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


def flash_fwd(q, k, v, *, chunk: int = 256):
    """q: (B, S, H, hd); k/v: (B, S, Hkv, hd), bf16 or float32, one dtype.
    Returns (out (B, H, S, hd) float32, lse (B, H, S) float32). `chunk` is
    the plain version's KV chunk; the kernel tiles by itself."""
    if q.device.type == "cpu":
        return ref.flash_ref(q, k, v, chunk=chunk)
    if q.device.type != "cuda":
        raise ValueError(f"flash_fwd: no kernel for device {q.device}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError("flash_fwd: q must be (B, S, H, hd) and k, v "
                         "(B, S, Hkv, hd)")
    b, s, h, hd = q.shape
    hkv = k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_fwd: head_dim {hd}; the kernel takes "
                         f"{HEAD_DIMS}")
    if hkv < 1 or h % hkv:
        raise ValueError(f"flash_fwd: {h} heads over {hkv} KV heads")
    dt = (torch.bfloat16, torch.float32)
    check("flash_fwd", "q", q, dt, (b, s, h, hd), q.device)
    check("flash_fwd", "k", k, (q.dtype,), (b, s, hkv, hd), q.device)
    check("flash_fwd", "v", v, (q.dtype,), (b, s, hkv, hd), q.device)
    out = torch.empty((b, h, s, hd), dtype=torch.float32, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    LAUNCHER.launch("flash_fwd",
                    (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     int(q.dtype == torch.bfloat16), out.data_ptr(),
                     lse.data_ptr(), b, s, h, hkv, hd, 1.0 / (hd ** 0.5)),
                    q.device)
    return out, lse


def flash_attention_fwd(q, k, v, *, chunk: int = 256):
    """Causal self-attention forward. Returns (out (B, S, H, hd) in q's
    dtype, lse (B, H, S) float32)."""
    out, lse = flash_fwd(q, k, v, chunk=chunk)
    return out.transpose(1, 2).to(q.dtype), lse
