"""zamba2-1.2b — hybrid Mamba2 backbone + shared attention blocks.

[arXiv:2411.15242; hf] 38L d_model=2048 32H (kv=32, full MHA in the shared
block) d_ff=8192 vocab=32000, ssm_state=64.

Copy of the reference's `repro/configs/zamba2_1p2b.py`: the port imports
nothing of the reference package.
"""
from repro_torch.configs.base import ArchConfig, HybridConfig, SSMConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,               # 2048 / 32
    d_ff=8192,                 # MLP of the shared attention block
    vocab_size=32000,
    act="geglu",
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, chunk_size=256),
    hybrid=HybridConfig(attn_every=6, shared_attn_blocks=1),
    source="arXiv:2411.15242; hf:Zyphra/Zamba2-1.2B",
)
