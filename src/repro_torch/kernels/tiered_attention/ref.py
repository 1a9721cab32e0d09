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

__all__ = ["NEG_INF", "dense_tier_partial_ref", "merge_partials",
           "split_partials_ref", "merge_splits"]

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


def split_partials_ref(q, k4, k4_sc, v4, v4_sc, dense_len: int,
                       split_tokens: int, splits: int, group: int = 64,
                       deq_dtype=torch.float32):
    """The kernel's split, in plain PyTorch (for the tests): the partial
    (m, l, acc) of each split [i * split_tokens, min((i + 1) *
    split_tokens, dense_len)), i < splits. A split with no token gives
    m = -1e30, l = 0, acc = 0."""
    parts = []
    for i in range(splits):
        start = i * split_tokens
        end = min(start + split_tokens, dense_len)
        if end <= start:
            m = torch.full(q.shape[:-1], NEG_INF, dtype=torch.float32,
                           device=q.device)
            parts.append((m, torch.zeros_like(m),
                          torch.zeros(q.shape, dtype=torch.float32,
                                      device=q.device)))
            continue
        sl = slice(start, end)
        parts.append(dense_tier_partial_ref(
            q, k4[:, sl], k4_sc[:, sl], v4[:, sl], v4_sc[:, sl], end - start,
            group, deq_dtype))
    return parts


def merge_splits(parts):
    """The kernel's merge of split partials -> (m, l, acc): each rescaled
    to the common max, as `merge_partials` rescales, and summed in split
    order."""
    m = parts[0][0]
    for p in parts[1:]:
        m = torch.maximum(m, p[0])
    l = torch.zeros_like(parts[0][1])
    acc = torch.zeros_like(parts[0][2])
    for m_i, l_i, acc_i in parts:
        c = torch.exp(m_i - m)
        l = l + l_i * c
        acc = acc + acc_i * c[..., None]
    return m, l, acc
