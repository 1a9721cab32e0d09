"""Plain PyTorch version of the causal flash-attention forward.

`flash_fwd_chunks` is the port of the reference's
`repro/models/attention.py::_flash_fwd` (online softmax over KV chunks,
GQA by virtual expansion, float32 throughout); the port's
`models.attention` runs it for every mask the kernel does not take.
`flash_bwd_chunks` is the port of `_flash_bwd`, the backward of the
reference's `custom_vjp`: p recomputed chunk by chunk from the saved
`lse`, no probability tensor kept from the forward. `flash_ref` is the
kernel's oracle, as the reference's `repro/kernels/flash_attention/ref.py`:
causal self-attention with positions 0..S-1, except that a ragged S is
padded to the chunk (the pads are masked) instead of being cut;
`iota_inputs` is that padding, which the backward of the kernel's route
shares.
"""
from __future__ import annotations

import torch

__all__ = ["NEG_INF", "expand_kv", "attention_mask", "flash_fwd_chunks",
           "flash_bwd_chunks", "iota_inputs", "flash_ref"]

NEG_INF = -1e30


def expand_kv(kc, g: int):
    """(B, C, Hkv, hd) -> (B, C, Hkv*g, hd), KV head j serving query
    heads j*g .. j*g+g-1."""
    if g == 1:
        return kc
    b, c, hkv, hd = kc.shape
    return kc[:, :, :, None, :].expand(b, c, hkv, g, hd).reshape(
        b, c, hkv * g, hd)


def attention_mask(q_pos, kv_pos, kv_valid, causal: bool):
    """Broadcastable mask (B?, 1, Sq?, C) from rank-1 (batch-uniform) or
    rank-2 positions and validity; None when nothing is masked."""
    def q_side(p):
        return p[:, None, :, None] if p.dim() == 2 else p[None, None, :, None]

    def kv_side(p):
        return p[:, None, None, :] if p.dim() == 2 else p[None, None, None, :]

    mask = None
    if causal:
        mask = kv_side(kv_pos) <= q_side(q_pos)
    if kv_valid is not None:
        vm = kv_side(kv_valid)
        mask = vm if mask is None else (mask & vm)
    return mask


def flash_fwd_chunks(q, k, v, qf, q_positions, kv_positions, kv_valid,
                     causal: bool, chunk: int):
    """Online softmax over KV chunks; the KV length is a multiple of
    `chunk`. qf is q in float32, already scaled. Returns (out (B, H, Sq,
    hd_v) float32, lse (B, H, Sq) float32)."""
    b, sq, h, _ = q.shape
    g = h // k.shape[2]
    n = k.shape[1] // chunk
    dev = q.device
    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, h, sq, v.shape[-1]), dtype=torch.float32,
                      device=dev)
    for i in range(n):
        sl = slice(i * chunk, (i + 1) * chunk)
        ke = expand_kv(k[:, sl], g).to(torch.float32)
        ve = expand_kv(v[:, sl], g).to(torch.float32)
        s_c = torch.einsum("bqhd,bchd->bhqc", qf, ke)
        mask = attention_mask(
            q_positions, None if kv_positions is None else kv_positions[..., sl],
            None if kv_valid is None else kv_valid[..., sl], causal)
        if mask is not None:
            s_c = torch.where(mask, s_c, NEG_INF)
        m_new = torch.maximum(m, s_c.amax(dim=-1))
        p = torch.exp(s_c - m_new[..., None])
        if mask is not None:
            p = torch.where(mask, p, 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhqc,bchd->bhqd", p, ve)
        m = m_new
    l_safe = torch.clamp(l, min=1e-30)
    return acc / l_safe[..., None], m + torch.log(l_safe)


def flash_bwd_chunks(q, k, v, qf, q_positions, kv_positions, kv_valid,
                     causal: bool, chunk: int, out, lse, dout, scale: float):
    """The backward of `flash_fwd_chunks` from its saved (out, lse): p
    recomputed per KV chunk as exp(s - lse), delta = sum(dout * out), dq
    summed over the chunks (against the scaled q, so scaled back by
    `scale`), dk and dv per chunk, reduced over the GQA group. dout and
    out are (B, H, Sq, hd_v) float32. Returns (dq, dk, dv) in q's, k's
    and v's dtypes."""
    b, sq, h, hd = q.shape
    hkv, hd_v = k.shape[2], v.shape[-1]
    g = h // hkv
    n = k.shape[1] // chunk
    doutf = dout.to(torch.float32)
    delta = (doutf * out).sum(dim=-1)                        # (B, H, Sq)
    dq = torch.zeros((b, sq, h, hd), dtype=torch.float32, device=q.device)
    dks, dvs = [], []
    for i in range(n):
        sl = slice(i * chunk, (i + 1) * chunk)
        ke = expand_kv(k[:, sl], g).to(torch.float32)
        ve = expand_kv(v[:, sl], g).to(torch.float32)
        s_c = torch.einsum("bqhd,bchd->bhqc", qf, ke)
        mask = attention_mask(
            q_positions, None if kv_positions is None else kv_positions[..., sl],
            None if kv_valid is None else kv_valid[..., sl], causal)
        if mask is not None:
            s_c = torch.where(mask, s_c, NEG_INF)
        p = torch.exp(s_c - lse[..., None])                  # (B, H, Sq, C)
        if mask is not None:
            p = torch.where(mask, p, 0.0)
        dp = torch.einsum("bhqd,bchd->bhqc", doutf, ve)
        ds = p * (dp - delta[..., None])
        dq = dq + torch.einsum("bhqc,bchd->bqhd", ds, ke)
        dk_c = torch.einsum("bhqc,bqhd->bchd", ds, qf)       # vs the SCALED q
        dv_c = torch.einsum("bhqc,bhqd->bchd", p, doutf)
        # reduce the virtual group expansion back to Hkv heads
        dks.append(dk_c.reshape(b, chunk, hkv, g, hd).sum(dim=3))
        dvs.append(dv_c.reshape(b, chunk, hkv, g, hd_v).sum(dim=3))
    dk = torch.cat(dks, dim=1)
    dv = torch.cat(dvs, dim=1)
    return ((dq * scale).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))


def iota_inputs(k, v, chunk: int):
    """The causal prefill's KV side over positions 0..S-1, padded to a
    multiple of `chunk` (at most S): returns (k, v, q positions, kv
    positions (pads at 2^30), kv_valid (None without pads), chunk)."""
    s = k.shape[1]
    chunk = min(chunk, s)
    pos = torch.arange(s, dtype=torch.int32, device=k.device)
    pad = (-s) % chunk
    kv_valid = None
    kv_pos = pos
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        kv_valid = torch.arange(s + pad, device=k.device) < s
        kv_pos = torch.cat([pos, torch.full((pad,), 2 ** 30,
                                            dtype=torch.int32,
                                            device=k.device)])
    return k, v, pos, kv_pos, kv_valid, chunk


def flash_ref(q, k, v, *, chunk: int = 256, scale=None):
    """q: (B, S, H, hd); k: (B, S, Hkv, hd); v: (B, S, Hkv, hd_v); causal,
    positions 0..S-1; scores scaled by `scale` (default 1/sqrt(hd)).
    Returns (out (B, H, S, hd_v) float32, lse (B, H, S) float32)."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    qf = q.to(torch.float32) * scale
    k, v, pos, kv_pos, kv_valid, chunk = iota_inputs(k, v, chunk)
    return flash_fwd_chunks(q, k, v, qf, pos, kv_pos, kv_valid, True, chunk)
