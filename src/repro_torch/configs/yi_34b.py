"""yi-34b — dense llama-arch GQA decoder.

[arXiv:2403.04652; hf] 60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.

Copy of the reference's `repro/configs/yi_34b.py`: the port imports
nothing of the reference package.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="yi-34b",
    family="dense",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab_size=64000,
    act="silu",
    rope_theta=5_000_000.0,
    source="arXiv:2403.04652; hf:01-ai/Yi-34B",
)
