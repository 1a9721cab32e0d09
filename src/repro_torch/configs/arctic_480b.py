"""arctic-480b — dense-MoE hybrid: 128-expert top-2 MoE + parallel dense residual.

[hf:Snowflake/snowflake-arctic-base; hf] 35L d_model=7168 56H (GQA kv=8)
d_ff_expert=4864 vocab=32000. Arctic runs a small dense FFN residual in
parallel with the routed MoE on every layer. Uses adafactor at this scale
(DESIGN.md §5: 480B * 12B/param of adamw state exceeds a 256-chip pod).

Copy of the reference's `repro/configs/arctic_480b.py`: the port imports
nothing of the reference package.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=4864,
    vocab_size=32000,
    act="silu",
    moe=MoEConfig(
        num_experts=128,
        top_k=2,
        d_ff_expert=4864,
        dense_residual_d_ff=4864,
    ),
    optimizer="adafactor",
    source="hf:Snowflake/snowflake-arctic-base",
)
