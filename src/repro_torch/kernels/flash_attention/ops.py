"""Wrappers of the flash-attention CUDA kernels, `flash_fwd`
(`csrc/flash_fwd.cu`) and `flash_bwd` (`csrc/flash_bwd.cu`): build,
argument checks, launch, launch count; and `FlashAttnFn`, the attention
under autograd (the port of the reference's `custom_vjp` `_flash`,
`repro/models/attention.py`).

`flash_fwd(q, k, v)` is the raw forward kernel: the causal
self-attention of the prefill (positions 0..S-1, any S). `flash_bwd(q,
k, v, out, lse, dout, scale=)` is its gradient from the saved (out,
lse), the port of the reference's jnp `_flash_bwd` on that route. For
tensors on a CUDA device each launches its kernel or raises; tensors on
the CPU go to the plain versions, `ref.flash_ref` and
`ref.flash_bwd_ref`. Nothing falls back. Their outputs carry no autograd
graph, so on the card they refuse inputs that require a gradient while
autograd records (`_build.refuse_grad`).

`flash_attention` (the prefill's causal mask, through the kernels) and
`flash_attention_chunks` (any other mask, through `ref.flash_fwd_chunks`
and `ref.flash_bwd_chunks`) are the differentiable entries: both run
`FlashAttnFn`, which saves only its inputs, the float32 `out` and `lse`,
and whose backward is timed by `BACKWARD` when its `record` is set.
"""
from __future__ import annotations

import ctypes
import os

import torch

from repro_torch.kernels._build import (BASE_FLAGS, LINK_FLAGS, Launcher,
                                        Library, Span, check, kernel_route,
                                        refuse_grad)
from repro_torch.kernels.flash_attention import ref

__all__ = ["flash_fwd", "flash_bwd", "flash_attention_fwd", "FlashAttnFn",
           "flash_attention", "flash_attention_chunks", "LIB", "LAUNCHER",
           "BWD_LIB", "BWD_LAUNCHER", "BWD_TERMS", "BACKWARD", "reset",
           "SOURCE", "BWD_SOURCE", "HEAD_DIMS", "MLA_WIDTHS",
           "kernel_widths"]

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
SOURCE = os.path.join(_CSRC, "flash_fwd.cu")
BWD_SOURCE = os.path.join(_CSRC, "flash_bwd.cu")
HEAD_DIMS = (16, 32, 64, 128, 256)
# q/k and v widths that the forward's bf16 form takes as they are beside
# HEAD_DIMS' equal pairs: MLA's prefill (deepseek-v2-lite)
MLA_WIDTHS = (192, 128)
# bf16 terms of each float32 operand of the backward's products (P, dS,
# dout): 3 sum to the float32 value exactly
BWD_TERMS = 3


def _bind(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_fwd.argtypes = [p, p, p, i, p, p, i, i, i, i, i, i,
                              ctypes.c_float, p]
    lib.flash_fwd.restype = i


def _bind_bwd(lib) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.flash_bwd.argtypes = [p, p, p, p, p, p, ll, ll, ll, p, p, p, p, p, p,
                              p, p, i, i, i, i, i, ctypes.c_float, i, p]
    lib.flash_bwd.restype = i


LIB = Library("flash_fwd", SOURCE, BASE_FLAGS + LINK_FLAGS, _bind)
LAUNCHER = Launcher(LIB, "flash_fwd")
BWD_LIB = Library("flash_bwd", BWD_SOURCE, BASE_FLAGS + LINK_FLAGS, _bind_bwd)
BWD_LAUNCHER = Launcher(BWD_LIB, "flash_bwd")
BACKWARD = Span("flash_bwd")


def reset() -> None:
    """Zero the launch counts and the backward's calls, and drop the
    recorded events."""
    LAUNCHER.reset()
    BWD_LAUNCHER.reset()
    BACKWARD.reset()


def kernel_widths(hd: int, hd_v: int, bf16: bool, backward: bool = False):
    """The (q/k, v) widths the forward kernel runs for q/k width hd and v
    width hd_v: (hd, hd_v) where it has a form for them (one width of
    HEAD_DIMS for all three; in bf16 also MLA_WIDTHS, unless the result
    goes to `flash_bwd`, which has no such form); else both the next
    width of HEAD_DIMS that holds either (None past the last)."""
    if hd == hd_v and hd in HEAD_DIMS:
        return hd, hd_v
    if bf16 and not backward and (hd, hd_v) == MLA_WIDTHS:
        return hd, hd_v
    width = next((w for w in HEAD_DIMS if w >= max(hd, hd_v)), None)
    return None if width is None else (width, width)


def _pad_to(widths, q, k, v):
    """q, k, v zero-padded to `widths` (q/k, v) in their last dimension
    (zeros add nothing to a dot product)."""
    wq, wv = widths
    pad = torch.nn.functional.pad
    return (pad(q, (0, wq - q.shape[-1])), pad(k, (0, wq - k.shape[-1])),
            pad(v, (0, wv - v.shape[-1])))


def flash_fwd(q, k, v, *, chunk: int = 256, scale=None):
    """q: (B, S, H, hd); k: (B, S, Hkv, hd); v: (B, S, Hkv, hd_v), bf16 or
    float32, one dtype; scores scaled by `scale` (default 1/sqrt(hd)).
    Returns (out (B, H, S, hd_v) float32, lse (B, H, S) float32). `chunk`
    is the plain version's KV chunk; the kernel tiles by itself.

    The kernel takes one width from HEAD_DIMS for q, k and v, and in bf16
    MLA's prefill widths (q and k 192, v 128) as they are. Other widths
    are zero-padded to the next width of HEAD_DIMS that holds both
    (`kernel_widths`), run with the unpadded scale, and the output is cut
    back to hd_v."""
    if not kernel_route("flash_fwd", q):
        return ref.flash_ref(q, k, v, chunk=chunk, scale=scale)
    refuse_grad("flash_fwd", q, k, v)
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_fwd: q must be (B, S, H, hd), k (B, S, "
                         "Hkv, hd) and v (B, S, Hkv, hd_v)")
    b, s, h, hd = q.shape
    hkv, hd_v = k.shape[2], v.shape[3]
    if scale is None:
        scale = 1.0 / (hd ** 0.5)
    widths = kernel_widths(hd, hd_v, q.dtype == torch.bfloat16)
    if widths is None:
        raise ValueError(f"flash_fwd: head_dim {hd} / {hd_v}; the kernel "
                         f"takes up to {HEAD_DIMS[-1]}")
    if hkv < 1 or h % hkv:
        raise ValueError(f"flash_fwd: {h} heads over {hkv} KV heads")
    dt = (torch.bfloat16, torch.float32)
    check("flash_fwd", "q", q, dt, (b, s, h, hd), q.device)
    check("flash_fwd", "k", k, (q.dtype,), (b, s, hkv, hd), q.device)
    check("flash_fwd", "v", v, (q.dtype,), (b, s, hkv, hd_v), q.device)
    if widths != (hd, hd_v):
        q, k, v = _pad_to(widths, q, k, v)
    out = torch.empty((b, h, s, widths[1]), dtype=torch.float32,
                      device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    LAUNCHER.launch("flash_fwd",
                    (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     int(q.dtype == torch.bfloat16), out.data_ptr(),
                     lse.data_ptr(), b, s, h, hkv, *widths, float(scale)),
                    q.device)
    return (out if widths[1] == hd_v else out[..., :hd_v]), lse


def _aligned(t):
    """t, or a copy of it in a fresh (16-byte aligned) buffer."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def flash_bwd(q, k, v, out, lse, dout, *, scale: float, chunk: int = 256,
              terms: int = BWD_TERMS):
    """The gradient of `flash_fwd(q, k, v, scale=scale)`: q (B, S, H, hd),
    k and v (B, S, Hkv, hd), out (B, H, S, hd) and lse (B, H, S) as the
    forward returned them, dout (B, H, S, hd) float32 (any strides with
    contiguous rows). Returns (dq, dk, dv) in q's, k's and v's dtypes.
    `chunk` is the plain version's KV chunk; the kernel tiles by itself.

    The kernel takes bf16 q, k, v of one width from HEAD_DIMS
    (`flash_attention` pads other widths before the Function), and runs
    each product's float32 operand (P, dS, dout) as `terms` bf16 terms."""
    if not kernel_route("flash_bwd", q):
        return ref.flash_bwd_ref(q, k, v, out, lse, dout, scale=scale,
                                 chunk=chunk)
    refuse_grad("flash_bwd", q, k, v, out, lse, dout)
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_bwd: q must be (B, S, H, hd), k and v (B, "
                         "S, Hkv, hd)")
    b, s, h, hd = q.shape
    hkv = k.shape[2]
    if hd not in HEAD_DIMS or v.shape[3] != hd:
        raise ValueError(f"flash_bwd: head_dim {hd} / {v.shape[3]}; the "
                         f"kernel takes one width of {HEAD_DIMS} for q, k "
                         "and v")
    if hkv < 1 or h % hkv:
        raise ValueError(f"flash_bwd: {h} heads over {hkv} KV heads")
    if terms not in (1, 2, 3):
        raise ValueError(f"flash_bwd: {terms} bf16 terms; the kernel takes "
                         "1, 2 or 3")
    dev = q.device
    check("flash_bwd", "q", q, (torch.bfloat16,), (b, s, h, hd), dev)
    check("flash_bwd", "k", k, (torch.bfloat16,), (b, s, hkv, hd), dev)
    check("flash_bwd", "v", v, (torch.bfloat16,), (b, s, hkv, hd), dev)
    check("flash_bwd", "out", out, (torch.float32,), (b, h, s, hd), dev)
    check("flash_bwd", "lse", lse, (torch.float32,), (b, h, s), dev)
    if (dout.device != dev or dout.dtype != torch.float32
            or tuple(dout.shape) != (b, h, s, hd)):
        raise ValueError(f"flash_bwd: dout must be float32 {(b, h, s, hd)} "
                         f"on {dev}")
    # the kernel reads dout by rows (autograd hands it a transposed view)
    if dout.stride(3) != 1:
        dout = dout.contiguous()
    q, k, v = (_aligned(t) for t in (q, k, v))
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    # scratch: dK/dV per query head, delta, dout's bf16 terms, their flag
    dk_part = torch.empty((b, s, h, hd), dtype=torch.float32, device=dev)
    dv_part = torch.empty_like(dk_part)
    delta = torch.empty((b, h, s), dtype=torch.float32, device=dev)
    dterms = torch.empty((terms, b, h, s, hd), dtype=torch.bfloat16,
                         device=dev)
    lo = torch.empty((1,), dtype=torch.int32, device=dev)
    BWD_LAUNCHER.launch("flash_bwd",
                        (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         out.data_ptr(), lse.data_ptr(), dout.data_ptr(),
                         *dout.stride()[:3], dq.data_ptr(), dk.data_ptr(),
                         dv.data_ptr(), dk_part.data_ptr(),
                         dv_part.data_ptr(), delta.data_ptr(),
                         dterms.data_ptr(), lo.data_ptr(), b, s, h, hkv, hd,
                         float(scale), terms), dev)
    return dq, dk, dv


def flash_attention_fwd(q, k, v, *, chunk: int = 256, scale=None):
    """Causal self-attention forward. Returns (out (B, S, H, hd_v) in q's
    dtype, lse (B, H, S) float32)."""
    out, lse = flash_fwd(q, k, v, chunk=chunk, scale=scale)
    return out.transpose(1, 2).to(q.dtype), lse


class FlashAttnFn(torch.autograd.Function):
    """Attention with the reference's `_flash` residuals: (q, k, v, the
    positions and validity, out, lse), out float32 (B, H, Sq, hd_v).

    apply(q, k, v, q_positions, kv_positions, kv_valid, causal, chunk,
    scale, kernel) -> (out, lse). With `kernel`, the prefill's causal
    self-attention over positions 0..S-1 (the positions and validity are
    None): `flash_fwd` forward and `flash_bwd` backward, each looked up on
    this module at every call (the kernels on a card, `ref.flash_ref` and
    `ref.flash_bwd_ref` on the CPU). Otherwise any mask, the KV length a
    multiple of `chunk`: `ref.flash_fwd_chunks` and `ref.flash_bwd_chunks`
    (plain PyTorch, as the reference's backward is jnp). `lse` takes no
    gradient."""

    @staticmethod
    def forward(ctx, q, k, v, q_positions, kv_positions, kv_valid,
                causal, chunk, scale, kernel):
        if kernel:
            out, lse = flash_fwd(q, k, v, chunk=chunk, scale=scale)
        else:
            qf = q.to(torch.float32) * scale
            out, lse = ref.flash_fwd_chunks(q, k, v, qf, q_positions,
                                            kv_positions, kv_valid, causal,
                                            chunk)
        ctx.save_for_backward(q, k, v, q_positions, kv_positions, kv_valid,
                              out, lse)
        ctx.causal, ctx.chunk, ctx.scale, ctx.kernel = (causal, chunk,
                                                        scale, kernel)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, q_pos, kv_pos, kv_valid, out, lse = ctx.saved_tensors
        with BACKWARD(q.device):
            if ctx.kernel:
                dq, dk, dv = flash_bwd(q, k, v, out, lse, dout,
                                       scale=ctx.scale, chunk=ctx.chunk)
            else:
                qf = q.to(torch.float32) * ctx.scale
                dq, dk, dv = ref.flash_bwd_chunks(
                    q, k, v, qf, q_pos, kv_pos, kv_valid, ctx.causal,
                    ctx.chunk, out, lse, dout, ctx.scale)
        return dq, dk, dv, None, None, None, None, None, None, None


def flash_attention(q, k, v, *, chunk: int = 256, scale=None):
    """The prefill's causal self-attention (positions 0..S-1) under
    autograd, through the kernel: q (B, S, H, hd), k (B, S, Hkv, hd), v
    (B, S, Hkv, hd_v). Returns (out (B, H, S, hd_v) float32, lse (B, H,
    S) float32). On a card, where autograd records (grad mode on and an
    input that requires a gradient), widths `flash_bwd` does not take
    (MLA's q/k 192, v 128) are zero-padded to its next width here, before
    `FlashAttnFn`, and the output cut back after it, so autograd sees
    the pad; otherwise (the serving prefill) `flash_fwd` runs them in
    its own form."""
    hd, hd_v = q.shape[-1], v.shape[-1]
    if scale is None:
        scale = 1.0 / (hd ** 0.5)
    if kernel_route("flash_fwd", q):
        records = torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v))
        widths = kernel_widths(hd, hd_v, q.dtype == torch.bfloat16,
                               backward=records)
        if widths is not None and widths != (hd, hd_v):
            q, k, v = _pad_to(widths, q, k, v)
    out, lse = FlashAttnFn.apply(q, k, v, None, None, None, True, chunk,
                                 float(scale), True)
    return (out if out.shape[-1] == hd_v else out[..., :hd_v]), lse


def flash_attention_chunks(q, k, v, q_positions, kv_positions, kv_valid,
                           causal: bool, chunk: int):
    """Any other mask under autograd (the encoder's non-causal
    self-attention, the cross-attention): the plain chunked forward, the
    KV length a multiple of `chunk`, scaled by 1/sqrt(hd). Returns (out
    (B, H, Sq, hd_v) float32, lse)."""
    return FlashAttnFn.apply(q, k, v, q_positions, kv_positions, kv_valid,
                             causal, chunk, 1.0 / (q.shape[-1] ** 0.5),
                             False)
