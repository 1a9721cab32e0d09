"""Plain PyTorch version of the tiered decode attention's dense-tier
partial (the port of the reference's
`repro/kernels/tiered_attention/ref.py`), and the merge of partials.

The partial is the online-softmax statistics (m, l, acc) of one decode
query per KV head against the int4 tier only; `ops.py` merges them with
the bf16 hot tail and the current token. `latent_tier_partial_ref` is
the same partial for MLA's absorbed decode: every query head against
the one int4 latent (key and value at once) plus a raw bf16 RoPE key.
"""
from __future__ import annotations

import torch

from repro_torch.core.tiercache.quant import dequantize_int4

__all__ = ["NEG_INF", "dense_tier_partial_ref", "latent_partial",
           "latent_tier_partial_ref", "merge_partials",
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


def latent_partial(q_lat, q_rope, c, k_rope, valid, scale: float):
    """MLA's partial over bf16 (or float32) latent tokens: q_lat (B, H, r)
    and q_rope (B, H, p) float32; c (B, T, r) and k_rope (B, T, p); valid
    (T,) or (B, T) bool. s = (q_lat . c + q_rope . k_rope) * scale; the
    latent is the value too. Returns float32 (m (B, H), l (B, H), acc (B,
    H, r))."""
    cf = c.to(torch.float32)
    scores = (torch.einsum("bhr,btr->bht", q_lat, cf)
              + torch.einsum("bhp,btp->bht", q_rope,
                             k_rope.to(torch.float32))) * scale
    mask = valid[None, None, :] if valid.dim() == 1 else valid[:, None, :]
    scores = torch.where(mask, scores, NEG_INF)
    m = scores.amax(dim=-1)
    p = torch.where(mask, torch.exp(scores - m[..., None]), 0.0)
    return m, p.sum(dim=-1), torch.einsum("bht,btr->bhr", p, cf)


def latent_tier_partial_ref(q_lat, q_rope, c4, c4_sc, krope, dense_len: int,
                            group: int = 64, scale: float = 1.0):
    """The latent form's contract: q_lat (B, H, r) and q_rope (B, H, p)
    float32, holding bf16-rounded values; c4 (B, S, r//2) uint8 and c4_sc
    (B, S, r//group); krope (B, S_raw, p) bf16, whose first dense_len rows
    are the dense tokens at their absolute positions. The latent is
    dequantized to bf16, as the serving path's `dequantize_int4` rounds
    it. Returns float32 (m (B, H), l (B, H), acc (B, H, r)) over tokens
    [0, dense_len); an empty tier gives m = -1e30, l = 0, acc = 0."""
    s = c4.shape[1]
    c = dequantize_int4(c4, c4_sc, group, torch.bfloat16)
    valid = torch.arange(s, device=q_lat.device) < dense_len
    return latent_partial(q_lat, q_rope, c, krope[:, :s], valid, scale)


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
