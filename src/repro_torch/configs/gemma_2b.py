"""gemma-2b — dense decoder with MQA (kv=1), GeGLU, head_dim=256.

[arXiv:2403.08295; hf] 18L d_model=2048 8H (kv=1) d_ff=16384 vocab=256000.
Tied input/output embeddings.

Copy of the reference's `repro/configs/gemma_2b.py`: the port imports
nothing of the reference package.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma-2b",
    family="dense",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=256000,
    act="geglu",
    tie_embeddings=True,
    source="arXiv:2403.08295; hf:google/gemma-2b",
)
