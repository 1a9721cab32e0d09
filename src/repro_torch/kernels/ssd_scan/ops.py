"""Wrapper of the `ssd_intra` CUDA kernel (`csrc/ssd_intra.cu`) and the
chunked SSD scan around it (the port of the reference's
`repro/kernels/ssd_scan/ops.py`).

`ssd_intra(x, dt, A, B, C)` is the intra-chunk contraction: for tensors
on a CUDA device it launches the kernel or raises; tensors on the CPU go
to the plain version, `ref.intra_chunk_ref`. Nothing falls back. Its
outputs carry no autograd graph, so on the card it refuses inputs that
require a gradient while autograd records (`_build.refuse_grad`).
`SsdIntraFn` is the contraction under autograd: `ssd_intra` forward, and
the derivative of `ref.intra_chunk_ref` (the function the reference
differentiates inside its jnp `ssd_chunked`) backward.
`ssd_chunked_kernel` assembles the whole scan from it and the inter-chunk
recurrence, which stays plain PyTorch as it stays jnp in the reference;
the port's Mamba2 block runs its chunked scan through it on every device.
"""
from __future__ import annotations

import ctypes
import os

import torch

from repro_torch.kernels._build import (BASE_FLAGS, LINK_FLAGS, Launcher,
                                        Library, check, kernel_route,
                                        refuse_grad)
from repro_torch.kernels.ssd_scan import ref

__all__ = ["ssd_intra", "SsdIntraFn", "ssd_chunked_kernel", "LIB", "LAUNCHER", "reset",
           "SOURCE", "HEAD_DIMS", "STATE_DIMS", "MAX_CHUNK"]

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                      "ssd_intra.cu")
HEAD_DIMS = (16, 32, 64, 128)
STATE_DIMS = (16, 32, 64, 128)
MAX_CHUNK = 256


def _bind(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ssd_intra.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, p]
    lib.ssd_intra.restype = i


LIB = Library("ssd_intra", SOURCE, BASE_FLAGS + LINK_FLAGS, _bind)
LAUNCHER = Launcher(LIB, "ssd_intra")


def reset() -> None:
    """Zero the launch count and drop the recorded launch events."""
    LAUNCHER.reset()


def ssd_intra(x, dt, A, B, C):
    """x: (Bt, nc, Q, nh, hd); dt: (Bt, nc, Q, nh); A: (nh,); B, C: (Bt,
    nc, Q, N); all float32. Returns (y_intra like x, states (Bt, nc, nh,
    hd, N), cum (Bt, nc, Q, nh)), float32."""
    if not kernel_route("ssd_intra", x):
        return ref.intra_chunk_ref(x, dt, A, B, C)
    refuse_grad("ssd_intra", x, dt, A, B, C)
    if x.dim() != 5 or B.dim() != 4:
        raise ValueError("ssd_intra: x must be (Bt, nc, Q, nh, hd) and B, C "
                         "(Bt, nc, Q, N)")
    bt, nc, q, nh, hd = x.shape
    n = B.shape[-1]
    if hd not in HEAD_DIMS:
        raise ValueError(f"ssd_intra: head_dim {hd}; the kernel takes "
                         f"{HEAD_DIMS}")
    if n not in STATE_DIMS:
        raise ValueError(f"ssd_intra: d_state {n}; the kernel takes "
                         f"{STATE_DIMS}")
    if not 1 <= q <= MAX_CHUNK:
        raise ValueError(f"ssd_intra: chunk {q}; the kernel takes 1.."
                         f"{MAX_CHUNK}")
    f32 = (torch.float32,)
    check("ssd_intra", "x", x, f32, (bt, nc, q, nh, hd), x.device)
    check("ssd_intra", "dt", dt, f32, (bt, nc, q, nh), x.device)
    check("ssd_intra", "A", A, f32, (nh,), x.device)
    check("ssd_intra", "B", B, f32, (bt, nc, q, n), x.device)
    check("ssd_intra", "C", C, f32, (bt, nc, q, n), x.device)
    # the kernel copies x, B and C tiles 16 bytes at a time: a view that
    # starts off a 16-byte boundary is copied into a fresh buffer
    x, B, C = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (x, B, C))
    y = torch.empty_like(x)
    states = torch.empty((bt, nc, nh, hd, n), dtype=torch.float32,
                         device=x.device)
    cum = torch.empty_like(dt)
    LAUNCHER.launch("ssd_intra",
                    (x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                     C.data_ptr(), y.data_ptr(), states.data_ptr(),
                     cum.data_ptr(), bt * nc, q, nh, hd, n), x.device)
    return y, states, cum


class SsdIntraFn(torch.autograd.Function):
    """The intra-chunk contraction under autograd: apply(x, dt, A, B, C)
    -> (y_intra, states, cum). Forward: `ssd_intra`, looked up on this
    module at every call (the kernel on a card, the plain version on the
    CPU); it saves only the inputs. Backward: `ref.intra_chunk_ref`
    re-run on them under autograd, then `torch.autograd.grad`."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C):
        ctx.save_for_backward(x, dt, A, B, C)
        return ssd_intra(x, dt, A, B, C)

    @staticmethod
    def backward(ctx, *grads):
        inputs = [t.detach().requires_grad_(need) for t, need in
                  zip(ctx.saved_tensors, ctx.needs_input_grad)]
        wrt = [t for t in inputs if t.requires_grad]
        if not wrt:
            return (None,) * len(inputs)
        with torch.enable_grad():
            outs = ref.intra_chunk_ref(*inputs)
        pairs = [(o, g) for o, g in zip(outs, grads) if g is not None]
        got = iter(torch.autograd.grad([o for o, _ in pairs], wrt,
                                       [g for _, g in pairs],
                                       allow_unused=True))
        return tuple(next(got) if t.requires_grad else None
                     for t in inputs)


def ssd_chunked_kernel(x, dt, A, B, C, chunk: int, h0=None):
    """Chunked SSD scan, the contract of the reference's
    `models.mamba2.ssd_chunked`.

    x: (B, S, nh, hd) (bf16 in the model); dt: (B, S, nh) f32; A: (nh,)
    f32 (negative); B, C: (B, S, N), shared across heads; h0: optional
    (B, nh, hd, N) f32 entering state. Returns (y (B, S, nh, hd) in x's
    dtype, h_final (B, nh, hd, N) f32)."""
    b, s, nh, hd = x.shape
    n = B.shape[-1]
    q = min(chunk, s)
    if s % q:
        raise ValueError(f"seq {s} not divisible by chunk {q}")
    nc = s // q
    xf = x.to(torch.float32).reshape(b, nc, q, nh, hd).contiguous()
    dtc = dt.to(torch.float32).reshape(b, nc, q, nh).contiguous()
    Bc = B.to(torch.float32).reshape(b, nc, q, n).contiguous()
    Cc = C.to(torch.float32).reshape(b, nc, q, n).contiguous()
    y_intra, states, cum = SsdIntraFn.apply(
        xf, dtc, A.to(torch.float32).contiguous(), Bc, Cc)

    # inter-chunk recurrence: the state entering each chunk
    chunk_decay = torch.exp(cum[:, :, -1, :])                 # (B, nc, nh)
    h = (torch.zeros((b, nh, hd, n), dtype=torch.float32, device=x.device)
         if h0 is None else h0.to(torch.float32))
    h_enter = []
    for c in range(nc):
        h_enter.append(h)
        h = chunk_decay[:, c, :, None, None] * h + states[:, c]
    h_enter = torch.stack(h_enter, dim=1)                     # (B, nc, nh, hd, N)

    # inter-chunk contribution, decayed from the chunk start
    in_decay = torch.exp(cum)                                 # (B, nc, Q, nh)
    y_inter = torch.einsum("bcin,bchpn->bcihp", Cc,
                           h_enter) * in_decay[..., None]
    y = (y_intra + y_inter).reshape(b, s, nh, hd)
    return y.to(x.dtype), h
