"""Wrapper of the `flash_fwd` CUDA kernel (`csrc/flash_fwd.cu`): build,
argument checks, launch, launch count.

`flash_attention_fwd(q, k, v)` is the causal self-attention of the
prefill (positions 0..S-1, any S). For tensors on a CUDA device it
launches the kernel or raises; tensors on the CPU go to the plain
version, `ref.flash_ref`. Nothing falls back.
"""
from __future__ import annotations

import ctypes
import os

import torch

from repro_torch.kernels._build import (BASE_FLAGS, LINK_FLAGS, Launcher,
                                        Library, check)
from repro_torch.kernels.flash_attention import ref

__all__ = ["flash_fwd", "flash_attention_fwd", "LIB", "LAUNCHER", "reset",
           "SOURCE"]

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


def reset() -> None:
    """Zero the launch count and drop the recorded launch events."""
    LAUNCHER.reset()


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
    if q.device.type == "cpu":
        return ref.flash_ref(q, k, v, chunk=chunk, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_fwd: no kernel for device {q.device}")
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
