"""Mamba2 block — SSD (state space duality) with a chunked parallel scan
(the port of the reference's `repro/models/mamba2.py`).

Follows the SSD decomposition (Dao & Gu, 2024): within a chunk the output
is a masked quadratic contraction; across chunks a small recurrence over
per-chunk states. Scalar A per head, ngroups=1 (B/C shared across heads).
The chunked scan runs through `kernels/ssd_scan/ops.py`, whose
intra-chunk contraction is the `ssd_intra` kernel on the card and its
plain version on the CPU. Decode is the single-token recurrence.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models.layers import init_dense, rms_norm

__all__ = ["init_mamba2", "ssd_chunked", "apply_mamba2",
           "apply_mamba2_decode"]


def init_mamba2(gen, cfg, dtype=torch.bfloat16, n_stack=None):
    """Random block parameters drawn from `gen` on its device, in the
    reference's tree; with `n_stack`, each leaf gets a leading axis."""
    s = cfg.ssm
    d = cfg.d_model
    d_in = s.d_inner(d)
    nh = s.num_heads(d)
    d_xc = d_in + 2 * s.d_state
    dev = gen.device
    lead = () if n_stack is None else (n_stack,)
    conv_w = (0.1 * torch.randn(lead + (s.d_conv, d_xc), generator=gen,
                                dtype=torch.float32, device=dev)).to(dtype)
    return {
        "in_proj": init_dense(gen, d, d_in + d_xc + nh, dtype=dtype,
                              n_stack=n_stack),
        "conv_w": conv_w,
        "conv_b": torch.zeros(lead + (d_xc,), dtype=dtype, device=dev),
        "A_log": torch.zeros(lead + (nh,), dtype=torch.float32, device=dev),
        "D": torch.ones(lead + (nh,), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros(lead + (nh,), dtype=torch.float32, device=dev),
        "norm": torch.zeros(lead + (d_in,), dtype=dtype, device=dev),
        "out_proj": init_dense(gen, d_in, d, dtype=dtype, n_stack=n_stack),
    }


def _split_proj(params, cfg, x):
    s = cfg.ssm
    d_in = s.d_inner(cfg.d_model)
    nh = s.num_heads(cfg.d_model)
    proj = x @ params["in_proj"]
    z = proj[..., :d_in]
    xc = proj[..., d_in: d_in + d_in + 2 * s.d_state]
    dt = proj[..., -nh:]
    dt = F.softplus(dt.to(torch.float32) + params["dt_bias"])
    return z, xc, dt


def _causal_conv(params, cfg, xc, conv_state=None):
    """Depthwise causal conv over (B, S, d_xc). Returns (out, new_state)."""
    s = cfg.ssm
    w = params["conv_w"].to(torch.float32)                    # (d_conv, d_xc)
    if conv_state is None:
        pad = torch.zeros((xc.shape[0], s.d_conv - 1, xc.shape[-1]),
                          dtype=xc.dtype, device=xc.device)
    else:
        pad = conv_state.to(xc.dtype)
    full = torch.cat([pad, xc], dim=1)                        # (B, S+dc-1, d_xc)
    seq = xc.shape[1]
    out = full[:, 0: seq].to(torch.float32) * w[0]
    for i in range(1, s.d_conv):
        out = out + full[:, i: i + seq].to(torch.float32) * w[i]
    out = F.silu(out + params["conv_b"].to(torch.float32))
    new_state = full[:, full.shape[1] - (s.d_conv - 1):]
    return out.to(xc.dtype), new_state


def ssd_chunked(x, dt, A, B, C, chunk: int, h0=None):
    """Chunked SSD scan.

    x: (B, S, nh, hd) bf16; dt: (B, S, nh) f32; A: (nh,) f32 (negative);
    B, C: (B, S, N), shared across heads (ngroups=1).
    Returns (y (B, S, nh, hd), h_final (B, nh, hd, N) f32)."""
    return ssd_ops.ssd_chunked_kernel(x, dt, A, B, C, chunk, h0=h0)


def _gate_norm_out(params, cfg, y, z):
    y = rms_norm(y * F.silu(z.to(torch.float32)).to(y.dtype), params["norm"],
                 cfg.norm_eps)
    return y @ params["out_proj"]


def apply_mamba2(params, cfg, x, *, conv_state=None, ssm_state=None,
                 return_state=False):
    """Full-sequence Mamba2 block. x: (B, S, D) -> (y, states or None);
    states is (conv_state (B, d_conv-1, d_xc), h (B, nh, hd, N) f32)."""
    s = cfg.ssm
    nh = s.num_heads(cfg.d_model)
    d_in = s.d_inner(cfg.d_model)
    z, xc, dt = _split_proj(params, cfg, x)
    xc, conv_state_new = _causal_conv(params, cfg, xc, conv_state)
    x_in = xc[..., :d_in]
    B = xc[..., d_in: d_in + s.d_state]
    C = xc[..., d_in + s.d_state:]
    A = -torch.exp(params["A_log"])
    xh = x_in.reshape(*x_in.shape[:2], nh, s.head_dim)
    y, h = ssd_chunked(xh, dt, A, B, C, s.chunk_size, h0=ssm_state)
    y = y + params["D"][None, None, :, None].to(y.dtype) * xh
    y = y.reshape(*x.shape[:2], d_in)
    out = _gate_norm_out(params, cfg, y, z)
    if return_state:
        return out, (conv_state_new, h)
    return out, None


def apply_mamba2_decode(params, cfg, x, conv_state, ssm_state):
    """Single-token recurrent step. x: (B, 1, D).

    conv_state: (B, d_conv-1, d_xc); ssm_state: (B, nh, hd, N) f32.
    Returns (y (B, 1, D), (conv_state, ssm_state))."""
    s = cfg.ssm
    nh = s.num_heads(cfg.d_model)
    d_in = s.d_inner(cfg.d_model)
    z, xc, dt = _split_proj(params, cfg, x)                   # S = 1
    xc, conv_state = _causal_conv(params, cfg, xc, conv_state)
    x_in = xc[..., :d_in]
    B = xc[..., d_in: d_in + s.d_state]
    C = xc[..., d_in + s.d_state:]
    A = -torch.exp(params["A_log"])

    xh = x_in.reshape(x.shape[0], 1, nh, s.head_dim).to(torch.float32)
    dt1 = dt[:, 0]                                            # (B, nh)
    decay = torch.exp(dt1 * A[None, :])                       # (B, nh)
    contrib = (dt1[:, :, None, None] * xh[:, 0, :, :, None]
               * B[:, 0, None, None, :].to(torch.float32))    # (B, nh, hd, N)
    h = decay[:, :, None, None] * ssm_state + contrib
    y = torch.einsum("bhpn,bn->bhp", h, C[:, 0].to(torch.float32))
    y = y + params["D"][None, :, None] * xh[:, 0]
    y = y.reshape(x.shape[0], 1, d_in).to(x.dtype)
    return _gate_norm_out(params, cfg, y, z), (conv_state, h)
