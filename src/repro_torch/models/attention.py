"""GQA/MQA attention (the port of the reference's
`repro/models/attention.py`).

Layouts as in the reference: q (B, Sq, H, hd); k/v (B, Sk, Hkv, hd);
scores (B, H, Sq, C). KV heads are expanded to the full head count
virtually. Every Sq > 1 path goes through the flash Function
(`kernels/flash_attention/ops.FlashAttnFn`, the reference's `custom_vjp`
`_flash`): the prefill's causal self-attention (positions 0..S-1) runs
the `flash_fwd` kernel forward, every other mask (the encoder's
non-causal self-attention, the decoder's cross-attention over the
encoder's frames) the plain chunked forward, and both the reference's
chunked-recomputation backward. The Sq == 1 decode path is plain
PyTorch, differentiated as it stands, as the reference's is.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import (NEG_INF, attention_mask,
                                                     expand_kv)
from repro_torch.models.layers import apply_rope, init_dense

__all__ = ["NEG_INF", "init_attention", "attend_chunked", "qkv_project",
           "out_project", "apply_attention", "apply_cross_attention"]


def init_attention(gen, cfg, dtype=torch.bfloat16, n_stack=None):
    d, h, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    wo = init_dense(gen, h * hd, d, dtype=dtype, n_stack=n_stack)
    return {
        "wq": init_dense(gen, d, (h, hd), dtype=dtype, n_stack=n_stack),
        "wk": init_dense(gen, d, (hkv, hd), dtype=dtype, n_stack=n_stack),
        "wv": init_dense(gen, d, (hkv, hd), dtype=dtype, n_stack=n_stack),
        "wo": wo.reshape(wo.shape[:-2] + (h, hd, d)),
    }


def attend_chunked(q, k, v, *, q_positions, kv_positions, kv_valid=None,
                   causal=True, chunk=512, iota=False):
    """Online-softmax attention over KV chunks.

    q_positions: (Sq,) or (B, Sq); kv_positions: (Sk,) or (B, Sk);
    kv_valid: optional (Sk,) or (B, Sk) bool. `iota` says that q and kv
    positions are both 0..S-1 (the prefill): with `causal` and no
    `kv_valid` that runs the flash kernel (on the CPU, its plain version
    with this `chunk`). Sq > 1 runs under the flash Function's backward.
    Returns (B, Sq, H, hd_v) in q's dtype."""
    b, sq, h, hd = q.shape
    hd_v = v.shape[-1]
    g = h // k.shape[2]
    sk = k.shape[1]
    scale = 1.0 / (hd ** 0.5)

    if iota and causal and kv_valid is None and sq == sk and sq > 1:
        out, _ = flash_ops.flash_attention(q, k, v, chunk=min(chunk, sk))
        return out.transpose(1, 2).reshape(b, sq, h, hd_v).to(q.dtype)

    if sq == 1:
        qf = q.to(torch.float32) * scale
        ke = expand_kv(k, g).to(torch.float32)
        ve = expand_kv(v, g).to(torch.float32)
        s = torch.einsum("bqhd,bchd->bhqc", qf, ke)
        mask = attention_mask(q_positions, kv_positions, kv_valid, causal)
        if mask is not None:
            s = torch.where(mask, s, NEG_INF)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        if mask is not None:
            p = torch.where(mask, p, 0.0)
        out = torch.einsum("bhqc,bchd->bhqd", p, ve)
        out = out / torch.clamp(p.sum(dim=-1), min=1e-30)[..., None]
        return out.transpose(1, 2).reshape(b, sq, h, hd_v).to(q.dtype)

    # pad the KV side to a chunk multiple; pads are masked via kv_valid
    chunk = min(chunk, sk)
    pad = (-sk) % chunk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        if kv_valid is None:
            kv_valid = torch.arange(sk + pad, device=q.device) < sk
        else:
            kv_valid = torch.cat([kv_valid, kv_valid.new_zeros(
                kv_valid.shape[:-1] + (pad,))], dim=-1)
        if kv_positions is not None:
            kv_positions = torch.cat([kv_positions, kv_positions.new_full(
                kv_positions.shape[:-1] + (pad,), 2 ** 30)], dim=-1)
    out, _ = flash_ops.flash_attention_chunks(q, k, v, q_positions,
                                              kv_positions, kv_valid, causal,
                                              chunk)
    return out.transpose(1, 2).reshape(b, sq, h, hd_v).to(q.dtype)


def _project(x, w):
    """einsum("bsd,dhk->bshk") as one matrix product (MLA's latent
    up-projections, "bsr,rhn->bshn", too)."""
    d = w.shape[0]
    return (x @ w.reshape(d, -1)).reshape(*x.shape[:-1], *w.shape[1:])


def qkv_project(params, cfg, x, positions, rope=True):
    q = _project(x, params["wq"])
    k = _project(x, params["wk"])
    v = _project(x, params["wv"])
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def out_project(params, attn_out):
    """einsum("bshk,hkd->bsd")."""
    h, hd, d = params["wo"].shape
    return attn_out.reshape(*attn_out.shape[:-2], h * hd) @ params[
        "wo"].reshape(h * hd, d)


def apply_attention(params, cfg, x, positions, *, causal=True, chunk=512,
                    rope=True):
    """Full self-attention (the prefill). Returns (y, (k, v)).

    positions: the (S,) iota 0..S-1, as `transformer.lm_hidden` passes."""
    q, k, v = qkv_project(params, cfg, x, positions, rope=rope)
    out = attend_chunked(q, k, v, q_positions=positions,
                         kv_positions=positions, causal=causal, chunk=chunk,
                         iota=True)
    return out_project(params, out), (k, v)


def apply_cross_attention(params, cfg, x, k, v, *, chunk=512):
    """Cross-attention: q from x, precomputed k/v (no RoPE, non-causal)."""
    q = _project(x, params["wq"])
    out = attend_chunked(q, k, v, q_positions=None, kv_positions=None,
                         causal=False, chunk=chunk)
    return out_project(params, out)
