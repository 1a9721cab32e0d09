"""whisper-tiny — encoder-decoder transformer backbone (audio frontend stub).

[arXiv:2212.04356; unverified] 4L (each side) d_model=384 6H (kv=6)
d_ff=1536 vocab=51865. The conv/mel frontend is a STUB per the assignment:
input_specs() provides precomputed frame embeddings (batch, frames, d_model).

Copy of the reference's `repro/configs/whisper_tiny.py`: the port imports
nothing of the reference package.
"""
from repro_torch.configs.base import ArchConfig, EncDecConfig

CONFIG = ArchConfig(
    name="whisper-tiny",
    family="audio",
    num_layers=4,
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab_size=51865,
    act="gelu",
    encdec=EncDecConfig(num_encoder_layers=4, encoder_seq_len=1500),
    source="arXiv:2212.04356; hf:openai/whisper-tiny",
)
