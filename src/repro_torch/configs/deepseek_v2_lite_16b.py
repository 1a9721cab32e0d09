"""deepseek-v2-lite-16b — MoE with Multi-head Latent Attention (MLA).

[arXiv:2405.04434; hf] 27L d_model=2048 16H (kv=16) d_ff_expert=1408
vocab=102400, MLA kv_lora=512, MoE: 2 shared + 64 routed top-6, first
layer dense (d_ff=10944).

Assignment note: the line says "64e top-6" and also "160 routed"; 160 is
full V2 — V2-*Lite* is 64 routed, which matches "64e top-6". We use 64.
(Recorded in DESIGN.md §6.)

Copy of the reference's `repro/configs/deepseek_v2_lite_16b.py`: the port imports
nothing of the reference package.
"""
from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=192,              # qk_nope(128) + qk_rope(64)
    d_ff=1408,                 # routed expert hidden
    vocab_size=102400,
    act="silu",
    mla=MLAConfig(kv_lora_rank=512, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(
        num_experts=64,
        top_k=6,
        d_ff_expert=1408,
        num_shared_experts=2,
        d_ff_shared=1408,
        first_k_dense=1,
        d_ff_first_dense=10944,
    ),
    source="arXiv:2405.04434; hf:deepseek-ai/DeepSeek-V2-Lite",
)
