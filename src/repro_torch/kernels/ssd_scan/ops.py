"""Wrappers of the `ssd_intra` CUDA kernel (`csrc/ssd_intra.cu`) and of
its backward (`csrc/ssd_intra_bwd.cu`), and the chunked SSD scan around
them (the port of the reference's `repro/kernels/ssd_scan/ops.py`).

`ssd_intra(x, dt, A, B, C)` is the intra-chunk contraction and
`ssd_intra_bwd(x, dt, A, B, C, dy, dstates, dcum)` its gradient: for
tensors on a CUDA device each launches its kernel or raises; tensors on
the CPU go to the plain versions, `ref.intra_chunk_ref` and
`ref.intra_chunk_bwd_ref`. Nothing falls back. Their outputs carry no
autograd graph, so on the card they refuse inputs that require a
gradient while autograd records (`_build.refuse_grad`). `SsdIntraFn` is
the contraction under autograd (the function the reference
differentiates inside its jnp `ssd_chunked`): `ssd_intra` forward,
`ssd_intra_bwd` backward. `ssd_chunked_kernel` assembles the whole scan
from it and the inter-chunk recurrence, which stays plain PyTorch as it
stays jnp in the reference; the port's Mamba2 block runs its chunked
scan through it on every device.
"""
from __future__ import annotations

import ctypes
import os

import torch

from repro_torch.kernels._build import (BASE_FLAGS, LINK_FLAGS, Launcher,
                                        Library, Span, check, kernel_route,
                                        refuse_grad)
from repro_torch.kernels.ssd_scan import ref

__all__ = ["ssd_intra", "ssd_intra_bwd", "SsdIntraFn", "ssd_chunked_kernel",
           "LIB", "LAUNCHER", "BWD_LIB", "BWD_LAUNCHER", "BACKWARD", "reset",
           "SOURCE", "BWD_SOURCE", "HEAD_DIMS", "STATE_DIMS", "MAX_CHUNK"]

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
SOURCE = os.path.join(_CSRC, "ssd_intra.cu")
BWD_SOURCE = os.path.join(_CSRC, "ssd_intra_bwd.cu")
HEAD_DIMS = (16, 32, 64, 128)
STATE_DIMS = (16, 32, 64, 128)
MAX_CHUNK = 256


def _bind(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ssd_intra.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, p]
    lib.ssd_intra.restype = i


def _bind_bwd(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ssd_intra_bwd.argtypes = [p] * 14 + [i] * 5 + [p]
    lib.ssd_intra_bwd.restype = i
    lib.ssd_intra_bwd_work.argtypes = [i] * 4
    lib.ssd_intra_bwd_work.restype = ctypes.c_longlong


LIB = Library("ssd_intra", SOURCE, BASE_FLAGS + LINK_FLAGS, _bind)
LAUNCHER = Launcher(LIB, "ssd_intra")
BWD_LIB = Library("ssd_intra_bwd", BWD_SOURCE, BASE_FLAGS + LINK_FLAGS,
                  _bind_bwd)
BWD_LAUNCHER = Launcher(BWD_LIB, "ssd_intra_bwd")
BACKWARD = Span("ssd_intra_bwd")


def reset() -> None:
    """Zero the launch counts and the backward's calls, and drop the
    recorded events."""
    LAUNCHER.reset()
    BWD_LAUNCHER.reset()
    BACKWARD.reset()


def _shape_check(kernel, x, B):
    """The widths the kernels take: (bt, nc, q, nh, hd, n) of x and B."""
    if x.dim() != 5 or B.dim() != 4:
        raise ValueError(f"{kernel}: x must be (Bt, nc, Q, nh, hd) and B, C "
                         "(Bt, nc, Q, N)")
    bt, nc, q, nh, hd = x.shape
    n = B.shape[-1]
    if hd not in HEAD_DIMS:
        raise ValueError(f"{kernel}: head_dim {hd}; the kernel takes "
                         f"{HEAD_DIMS}")
    if n not in STATE_DIMS:
        raise ValueError(f"{kernel}: d_state {n}; the kernel takes "
                         f"{STATE_DIMS}")
    if not 1 <= q <= MAX_CHUNK:
        raise ValueError(f"{kernel}: chunk {q}; the kernel takes 1.."
                         f"{MAX_CHUNK}")
    return bt, nc, q, nh, hd, n


def _aligned(t):
    """t, or a copy of it in a fresh (16-byte aligned) buffer: the kernels
    copy their tiles 16 bytes at a time."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def ssd_intra(x, dt, A, B, C):
    """x: (Bt, nc, Q, nh, hd); dt: (Bt, nc, Q, nh); A: (nh,); B, C: (Bt,
    nc, Q, N); all float32. Returns (y_intra like x, states (Bt, nc, nh,
    hd, N), cum (Bt, nc, Q, nh)), float32."""
    if not kernel_route("ssd_intra", x):
        return ref.intra_chunk_ref(x, dt, A, B, C)
    refuse_grad("ssd_intra", x, dt, A, B, C)
    bt, nc, q, nh, hd, n = _shape_check("ssd_intra", x, B)
    f32 = (torch.float32,)
    check("ssd_intra", "x", x, f32, (bt, nc, q, nh, hd), x.device)
    check("ssd_intra", "dt", dt, f32, (bt, nc, q, nh), x.device)
    check("ssd_intra", "A", A, f32, (nh,), x.device)
    check("ssd_intra", "B", B, f32, (bt, nc, q, n), x.device)
    check("ssd_intra", "C", C, f32, (bt, nc, q, n), x.device)
    # a view that starts off a 16-byte boundary is copied
    x, B, C = (_aligned(t) for t in (x, B, C))
    y = torch.empty_like(x)
    states = torch.empty((bt, nc, nh, hd, n), dtype=torch.float32,
                         device=x.device)
    cum = torch.empty_like(dt)
    LAUNCHER.launch("ssd_intra",
                    (x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                     C.data_ptr(), y.data_ptr(), states.data_ptr(),
                     cum.data_ptr(), bt * nc, q, nh, hd, n), x.device)
    return y, states, cum


def ssd_intra_bwd(x, dt, A, B, C, dy, dstates, dcum):
    """The gradient of `ssd_intra(x, dt, A, B, C)` against the cotangents
    dy (like x), dstates (Bt, nc, nh, hd, N) and dcum (like dt) of its
    three outputs, float32 (a None cotangent counts as zeros). Returns
    (dx, ddt, dA, dB, dC), each like its input."""
    if not kernel_route("ssd_intra_bwd", x):
        return ref.intra_chunk_bwd_ref(x, dt, A, B, C, dy, dstates, dcum)
    refuse_grad("ssd_intra_bwd", x, dt, A, B, C, dy, dstates, dcum)
    bt, nc, q, nh, hd, n = _shape_check("ssd_intra_bwd", x, B)
    dev = x.device
    dy, dstates, dcum = (
        torch.zeros(shape, dtype=torch.float32, device=dev) if g is None
        else g for g, shape in ((dy, x.shape), (dstates, (bt, nc, nh, hd, n)),
                                (dcum, dt.shape)))
    f32 = (torch.float32,)
    for name, t, shape in (
            ("x", x, (bt, nc, q, nh, hd)), ("dt", dt, (bt, nc, q, nh)),
            ("A", A, (nh,)), ("B", B, (bt, nc, q, n)),
            ("C", C, (bt, nc, q, n)), ("dy", dy, (bt, nc, q, nh, hd)),
            ("dstates", dstates, (bt, nc, nh, hd, n)),
            ("dcum", dcum, (bt, nc, q, nh))):
        check("ssd_intra_bwd", name, t, f32, shape, dev)
    x, B, C, dy, dstates = (_aligned(t) for t in (x, B, C, dy, dstates))
    dx = torch.empty_like(x)
    ddt = torch.empty_like(dt)
    dA = torch.empty_like(A)
    dB = torch.empty_like(B)
    dC = torch.empty_like(C)
    lib = BWD_LIB.load()
    work = torch.empty(lib.ssd_intra_bwd_work(bt * nc, q, nh, n),
                       dtype=torch.float32, device=dev)
    BWD_LAUNCHER.launch("ssd_intra_bwd",
                        (x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                         B.data_ptr(), C.data_ptr(), dy.data_ptr(),
                         dstates.data_ptr(), dcum.data_ptr(), dx.data_ptr(),
                         ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(),
                         dC.data_ptr(), work.data_ptr(), bt * nc, q, nh, hd,
                         n), dev)
    return dx, ddt, dA, dB, dC


class SsdIntraFn(torch.autograd.Function):
    """The intra-chunk contraction under autograd: apply(x, dt, A, B, C)
    -> (y_intra, states, cum). Forward: `ssd_intra`; backward:
    `ssd_intra_bwd`, each looked up on this module at every call (the
    kernels on a card, the plain versions on the CPU). It saves only the
    inputs; the backward is timed by `BACKWARD` when its `record` is
    set."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C):
        ctx.save_for_backward(x, dt, A, B, C)
        return ssd_intra(x, dt, A, B, C)

    @staticmethod
    def backward(ctx, dy, dstates, dcum):
        inputs = ctx.saved_tensors
        if not any(ctx.needs_input_grad):
            return (None,) * len(inputs)
        with BACKWARD(inputs[0].device):
            got = ssd_intra_bwd(*inputs, dy.contiguous(),
                                dstates.contiguous(), dcum.contiguous())
        return tuple(g if need else None
                     for g, need in zip(got, ctx.needs_input_grad))


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
