"""mamba2-370m — attention-free SSM (state space duality / SSD).

[arXiv:2405.21060; unverified] 48L d_model=1024 d_ff=0 vocab=50280,
ssm_state=128. No KV cache: O(1) decode state => the paper's SLC-cache
technique is inapplicable (DESIGN.md §6); long_500k runs natively.

Copy of the reference's `repro/configs/mamba2_370m.py`: the port imports
nothing of the reference package.
"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="mamba2-370m",
    family="ssm",
    num_layers=48,
    d_model=1024,
    num_heads=0,
    num_kv_heads=0,
    head_dim=64,
    d_ff=0,
    vocab_size=50280,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk_size=256),
    tie_embeddings=True,
    source="arXiv:2405.21060; hf:state-spaces/mamba2-370m",
)
