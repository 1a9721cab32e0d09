"""yi-6b — dense llama-arch GQA decoder.

[arXiv:2403.04652; hf] 32L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000.

Copy of the reference's `repro/configs/yi_6b.py`: the port imports
nothing of the reference package.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="yi-6b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=11008,
    vocab_size=64000,
    act="silu",
    rope_theta=5_000_000.0,
    source="arXiv:2403.04652; hf:01-ai/Yi-6B",
)
