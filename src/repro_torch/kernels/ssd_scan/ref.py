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
"""
from __future__ import annotations

import torch

__all__ = ["intra_chunk_ref"]


def intra_chunk_ref(x, dt, A, B, C):
    """x: (Bt, nc, Q, nh, hd) f32; dt: (Bt, nc, Q, nh) f32; A: (nh,) f32;
    B, C: (Bt, nc, Q, N) f32.
    Returns (y_intra (Bt, nc, Q, nh, hd), states (Bt, nc, nh, hd, N),
    cum (Bt, nc, Q, nh)), all float32."""
    q = x.shape[2]
    a = dt * A[None, None, None, :]
    # the float products summed in float64 and rounded once per row, on
    # every device (the CPU's float32 cumsum does so already; the card's
    # sums in float32, some ulps of |cum| ~ 200 off at Q 256)
    cum = torch.cumsum(a.to(torch.float64), dim=2).to(torch.float32)
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
    return y_intra, states, cum
