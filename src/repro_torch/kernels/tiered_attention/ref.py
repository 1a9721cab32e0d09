"""Plain PyTorch version of the tiered decode attention's dense-tier
partial (the port of the reference's
`repro/kernels/tiered_attention/ref.py`), and the merge of partials.

The partial is the online-softmax statistics (m, l, acc) of one decode
query per KV head against the int4 tier only; `ops.py` merges them with
the bf16 hot tail and the current token.
"""
from __future__ import annotations

import torch

from repro_torch.core.tiercache.quant import dequantize_int4

__all__ = ["NEG_INF", "dense_tier_partial_ref", "merge_partials"]

NEG_INF = -1e30


def dense_tier_partial_ref(q, k4, k4_sc, v4, v4_sc, dense_len: int,
                           group: int = 64, deq_dtype=torch.float32):
    """q: (B, Hkv, G, hd) float32; k4/v4: (B, S, Hkv, hd//2) uint8;
    scales: (B, S, Hkv, hd//group); dense_len: tokens [0, dense_len) are
    valid. `deq_dtype` float32 is the TPU kernel's contract; bf16 rounds
    the dequantized tier as the serving path does. Returns (m (B,Hkv,G),
    l (B,Hkv,G), acc (B,Hkv,G,hd)) in float32."""
    s = k4.shape[1]
    hd = q.shape[-1]
    scale = 1.0 / (hd ** 0.5)
    k = dequantize_int4(k4, k4_sc, group, deq_dtype).to(torch.float32)
    v = dequantize_int4(v4, v4_sc, group, deq_dtype).to(torch.float32)
    scores = torch.einsum("bkgd,bskd->bkgs", q, k) * scale
    valid = (torch.arange(s, device=q.device) < dense_len)[None, None, None]
    scores = torch.where(valid, scores, NEG_INF)
    m = scores.amax(dim=-1)
    p = torch.exp(scores - m[..., None])
    p = torch.where(valid, p, 0.0)
    l = p.sum(dim=-1)
    acc = torch.einsum("bkgs,bskd->bkgd", p, v)
    return m, l, acc


def merge_partials(parts):
    """Combine online-softmax partials [(m, l, acc), ...] ->
    (out, m, l)."""
    m, l, acc = parts[0]
    for m2, l2, acc2 in parts[1:]:
        m_new = torch.maximum(m, m2)
        c1 = torch.exp(m - m_new)
        c2 = torch.exp(m2 - m_new)
        l = l * c1 + l2 * c2
        acc = acc * c1[..., None] + acc2 * c2[..., None]
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out, m, l
