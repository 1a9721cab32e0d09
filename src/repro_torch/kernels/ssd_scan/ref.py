"""Plain PyTorch version of the Mamba2 SSD intra-chunk contraction (the
port of the reference's `repro/kernels/ssd_scan/ref.py`).

Given chunked inputs, it produces the intra-chunk output, the per-chunk
end states and the within-chunk cumulative decay; the inter-chunk
recurrence is shared code in ops.py. The decay is masked before `exp`,
as the TPU kernel masks it: the upper triangle of `cum_i - cum_j` is
positive and overflows at long chunks. The reference's oracle only
selects after `exp`, which keeps the same (finite) lower triangle.
`cum` is accumulated in float64 from the float32 products, as the
kernel accumulates it, so the two agree on it on any device.

`intra_chunk_bwd_ref` is its gradient: plain autograd through
`intra_chunk_ref`, the plain version of the backward kernel.
`intra_chunk_from_cum` is the contraction given `cum`.
"""
from __future__ import annotations

import torch

__all__ = ["intra_chunk_ref", "intra_chunk_from_cum", "intra_chunk_bwd_ref"]


def intra_chunk_ref(x, dt, A, B, C):
    """x: (Bt, nc, Q, nh, hd) f32; dt: (Bt, nc, Q, nh) f32; A: (nh,) f32;
    B, C: (Bt, nc, Q, N) f32.
    Returns (y_intra (Bt, nc, Q, nh, hd), states (Bt, nc, nh, hd, N),
    cum (Bt, nc, Q, nh)), all float32."""
    a = dt * A[None, None, None, :]
    # the float products summed in float64 and rounded once per row, on
    # every device (the CPU's float32 cumsum does so already; the card's
    # sums in float32, some ulps of |cum| ~ 200 off at Q 256)
    cum = torch.cumsum(a.to(torch.float64), dim=2).to(torch.float32)
    y_intra, states = intra_chunk_from_cum(x, dt, B, C, cum)
    return y_intra, states, cum


def intra_chunk_from_cum(x, dt, B, C, cum):
    """`intra_chunk_ref`'s (y_intra, states) given its cum (Bt, nc, Q,
    nh)."""
    q = x.shape[2]
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]     # (Bt,nc,Qi,Qj,nh)
    causal = torch.ones((q, q), dtype=torch.bool,
                        device=x.device).tril()[None, None, :, :, None]
    L = torch.where(causal, torch.exp(torch.where(causal, seg, 0.0)), 0.0)
    cb = torch.einsum("bcin,bcjn->bcij", C, B)
    scores = cb[..., None] * L * dt[:, :, None, :, :]
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", scores, x)
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)
    w = decay_to_end * dt                                   # (Bt,nc,Q,nh)
    states = torch.einsum("bcjn,bcjhp->bchpn", B, x * w[..., None])
    return y_intra, states


def intra_chunk_bwd_ref(x, dt, A, B, C, dy, dstates, dcum):
    """The gradient of `intra_chunk_ref(x, dt, A, B, C)` against the
    cotangents dy, dstates and dcum of its three outputs (a None
    cotangent counts as zeros). Returns (dx, ddt, dA, dB, dC), each like
    its input, float32."""
    inputs = [t.detach().requires_grad_(True) for t in (x, dt, A, B, C)]
    with torch.enable_grad():
        outs = intra_chunk_ref(*inputs)
    pairs = [(o, g) for o, g in zip(outs, (dy, dstates, dcum))
             if g is not None]
    if not pairs:
        return tuple(torch.zeros_like(t) for t in inputs)
    grads = torch.autograd.grad([o for o, _ in pairs], inputs,
                                [g for _, g in pairs], allow_unused=True)
    return tuple(torch.zeros_like(t) if g is None else g
                 for g, t in zip(grads, inputs))
