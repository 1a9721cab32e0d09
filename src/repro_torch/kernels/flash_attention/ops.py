"""Wrapper of the `flash_fwd` CUDA kernel (`csrc/flash_fwd.cu`): build,
argument checks, launch, launch count; and `FlashAttnFn`, the attention
under autograd (the port of the reference's `custom_vjp` `_flash`,
`repro/models/attention.py`).

`flash_fwd(q, k, v)` is the raw kernel: the causal self-attention of
the prefill (positions 0..S-1, any S). For tensors on a CUDA device it
launches the kernel or raises; tensors on the CPU go to the plain
version, `ref.flash_ref`. Nothing falls back. Its outputs carry no
autograd graph, so on the card it refuses inputs that require a
gradient while autograd records (`_build.refuse_grad`).

`flash_attention` (the prefill's causal mask, through the kernel) and
`flash_attention_chunks` (any other mask, through `ref.flash_fwd_chunks`)
are the differentiable entries: both run `FlashAttnFn`, which saves only
its inputs, the float32 `out` and `lse`, and whose backward is
`ref.flash_bwd_chunks` (plain PyTorch, as the reference's backward is
jnp), timed by `BACKWARD` when its `record` is set.
"""
from __future__ import annotations

import ctypes
import os

import torch

from repro_torch.kernels._build import (BASE_FLAGS, LINK_FLAGS, Launcher,
                                        Library, Span, check, kernel_route,
                                        refuse_grad)
from repro_torch.kernels.flash_attention import ref

__all__ = ["flash_fwd", "flash_attention_fwd", "FlashAttnFn",
           "flash_attention", "flash_attention_chunks", "LIB", "LAUNCHER",
           "BACKWARD", "reset", "SOURCE", "HEAD_DIMS"]

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                      "flash_fwd.cu")
HEAD_DIMS = (16, 32, 64, 128, 256)


def _bind(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_fwd.argtypes = [p, p, p, i, p, p, i, i, i, i, i,
                              ctypes.c_float, p]
    lib.flash_fwd.restype = i


LIB = Library("flash_fwd", SOURCE, BASE_FLAGS + LINK_FLAGS, _bind)
LAUNCHER = Launcher(LIB, "flash_fwd")
BACKWARD = Span("flash_bwd")


def reset() -> None:
    """Zero the launch count and the backward's calls, and drop the
    recorded events."""
    LAUNCHER.reset()
    BACKWARD.reset()


def flash_fwd(q, k, v, *, chunk: int = 256, scale=None):
    """q: (B, S, H, hd); k: (B, S, Hkv, hd); v: (B, S, Hkv, hd_v), bf16 or
    float32, one dtype; scores scaled by `scale` (default 1/sqrt(hd)).
    Returns (out (B, H, S, hd_v) float32, lse (B, H, S) float32). `chunk`
    is the plain version's KV chunk; the kernel tiles by itself.

    The kernel takes one width from HEAD_DIMS for q, k and v. Other
    widths (MLA's prefill: q and k 192, v 128) are zero-padded to the
    next width of HEAD_DIMS that holds both (zeros add nothing to a dot
    product), run with the unpadded scale, and the output is cut back
    to hd_v."""
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
    width = next((w for w in HEAD_DIMS if w >= max(hd, hd_v)), None)
    if width is None:
        raise ValueError(f"flash_fwd: head_dim {hd} / {hd_v}; the kernel "
                         f"takes up to {HEAD_DIMS[-1]}")
    if hkv < 1 or h % hkv:
        raise ValueError(f"flash_fwd: {h} heads over {hkv} KV heads")
    dt = (torch.bfloat16, torch.float32)
    check("flash_fwd", "q", q, dt, (b, s, h, hd), q.device)
    check("flash_fwd", "k", k, (q.dtype,), (b, s, hkv, hd), q.device)
    check("flash_fwd", "v", v, (q.dtype,), (b, s, hkv, hd_v), q.device)
    if width != hd or width != hd_v:
        q, k, v = (torch.nn.functional.pad(t, (0, width - t.shape[-1]))
                   for t in (q, k, v))
    out = torch.empty((b, h, s, width), dtype=torch.float32, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    LAUNCHER.launch("flash_fwd",
                    (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     int(q.dtype == torch.bfloat16), out.data_ptr(),
                     lse.data_ptr(), b, s, h, hkv, width, float(scale)),
                    q.device)
    return (out if width == hd_v else out[..., :hd_v]), lse


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
    None): `flash_fwd`, looked up on this module at every call (the
    kernel on a card, `ref.flash_ref` on the CPU). Otherwise any mask,
    the KV length a multiple of `chunk`: `ref.flash_fwd_chunks`. The
    backward is `ref.flash_bwd_chunks` over the same chunks (the kernel's
    route padded as `ref.iota_inputs` pads it); `lse` takes no
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
        chunk, sk = ctx.chunk, k.shape[1]
        with BACKWARD(q.device):
            if ctx.kernel:
                k, v, q_pos, kv_pos, kv_valid, chunk = ref.iota_inputs(
                    k, v, chunk)
            qf = q.to(torch.float32) * ctx.scale
            dq, dk, dv = ref.flash_bwd_chunks(
                q, k, v, qf, q_pos, kv_pos, kv_valid, ctx.causal, chunk,
                out, lse, dout, ctx.scale)
        return (dq, dk[:, :sk], dv[:, :sk], None, None, None, None, None,
                None, None)


def flash_attention(q, k, v, *, chunk: int = 256, scale=None):
    """The prefill's causal self-attention (positions 0..S-1) under
    autograd, through the kernel: q (B, S, H, hd), k (B, S, Hkv, hd), v
    (B, S, Hkv, hd_v). Returns (out (B, H, S, hd_v) float32, lse (B, H,
    S) float32). On a card, widths the kernel does not take (MLA's q/k
    192, v 128) are zero-padded to its next width here, before
    `FlashAttnFn`, and the output cut back after it, so autograd sees
    the pad."""
    hd, hd_v = q.shape[-1], v.shape[-1]
    if scale is None:
        scale = 1.0 / (hd ** 0.5)
    if kernel_route("flash_fwd", q):
        width = next((w for w in HEAD_DIMS if w >= max(hd, hd_v)), None)
        if width is not None and (width != hd or width != hd_v):
            q, k, v = (torch.nn.functional.pad(t, (0, width - t.shape[-1]))
                       for t in (q, k, v))
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
