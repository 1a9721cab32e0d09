"""llava-next-34b — VLM: yi-34b-class decoder + anyres patch embeddings (stub).

[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified] 60L d_model=7168 56H
(GQA kv=8) d_ff=20480 vocab=64000. The vision tower is a STUB per the
assignment: input_specs() provides precomputed patch embeddings
(batch, num_patches, d_model) which are prepended to the token sequence.

Copy of the reference's `repro/configs/llava_next_34b.py`: the port imports
nothing of the reference package.
"""
from repro_torch.configs.base import ArchConfig, VLMConfig

CONFIG = ArchConfig(
    name="llava-next-34b",
    family="vlm",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab_size=64000,
    act="silu",
    rope_theta=5_000_000.0,
    vlm=VLMConfig(num_patches=576),
    source="hf:llava-hf/llava-v1.6-34b (yi-34b backbone)",
)
