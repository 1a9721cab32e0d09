"""Wrapper of the `ips_repack` CUDA kernel (`csrc/ips_repack.cu`): build,
argument checks, launch, launch count.

Two forms of the one kernel:

* `quantize_rows(x, group)` — the tier form on the serving path: rows of
  bf16 (or float32) values -> packed int4 bytes and float32 scales. The
  tiered cache's prefill fill and every repack call it (through
  `core.tiercache.quant.quantize_int4`).
* `repack_arena(arena, tokens=, feat=, group=)` — the TPU kernel's arena
  contract, densifying every page in place on the same storage.

For tensors on a CUDA device each launches the kernel or raises; tensors
on the CPU go to the plain version in `ref.py`. Nothing falls back.
"""
from __future__ import annotations

import ctypes
import os

import torch

from repro_torch.kernels._build import (BASE_FLAGS, LINK_FLAGS, Launcher,
                                        Library, check)
from repro_torch.kernels.ips_repack import ref

__all__ = ["quantize_rows", "repack_arena", "LIB", "LAUNCHER", "reset",
           "SOURCE"]

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                      "ips_repack.cu")
MAX_SMEM = 232448


def _bind(lib) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ips_quantize_rows.argtypes = [p, i, p, p, ll, i, i, p]
    lib.ips_quantize_rows.restype = i
    lib.ips_repack_arena.argtypes = [p, ll, ll, i, i, i, p]
    lib.ips_repack_arena.restype = i


LIB = Library("ips_repack", SOURCE, BASE_FLAGS + LINK_FLAGS, _bind)
LAUNCHER = Launcher(LIB, "ips_repack")


def reset() -> None:
    """Zero the launch count and drop the recorded launch events."""
    LAUNCHER.reset()


def _check_group(feat: int, group: int) -> None:
    if group < 2 or group > 64 or group & (group - 1):
        raise ValueError(f"ips_repack: group {group}; the kernel takes a "
                         "power of two from 2 to 64")
    if feat % group:
        raise ValueError(f"ips_repack: feat {feat} is not a multiple of "
                         f"group {group}")


def quantize_rows(x: torch.Tensor, group: int = 64):
    """x: (N, F) bf16 or float32 -> (packed uint8 (N, F//2), scales
    float32 (N, F//group)), equal bit for bit to the plain version."""
    if x.device.type == "cpu":
        return ref.quantize_rows_ref(x, group)
    if x.device.type != "cuda":
        raise ValueError(f"ips_repack: no kernel for device {x.device}")
    if x.dim() != 2:
        raise ValueError(f"ips_repack: x must be (N, F), got "
                         f"{tuple(x.shape)}")
    n, f = x.shape
    _check_group(f, group)
    check("ips_repack", "x", x, (torch.bfloat16, torch.float32), (n, f),
          x.device)
    packed = torch.empty((n, f // 2), dtype=torch.uint8, device=x.device)
    scales = torch.empty((n, f // group), dtype=torch.float32,
                         device=x.device)
    if n:
        LAUNCHER.launch("ips_quantize_rows",
                        (x.data_ptr(), int(x.dtype == torch.bfloat16),
                         packed.data_ptr(), scales.data_ptr(), n, f, group),
                        x.device)
    return packed, scales


def repack_arena(arena: torch.Tensor, *, tokens: int, feat: int,
                 group: int = 64) -> torch.Tensor:
    """arena: (pages, page_bytes) uint8 holding `tokens x feat` bf16 per
    page. Densifies every page in place (packed bytes, bf16 scales, stale
    tail kept) and returns `arena` itself."""
    if arena.device.type == "cpu":
        arena.copy_(ref.repack_ref(arena, tokens, feat, group))
        return arena
    if arena.device.type != "cuda":
        raise ValueError(f"ips_repack: no kernel for device {arena.device}")
    _check_group(feat, group)
    if arena.dim() != 2:
        raise ValueError(f"ips_repack: arena must be (pages, page_bytes), "
                         f"got {tuple(arena.shape)}")
    pages, page_bytes = arena.shape
    check("ips_repack", "arena", arena, torch.uint8, (pages, page_bytes),
          arena.device)
    ref.page_layout(tokens, feat, group)
    if page_bytes < tokens * feat * 2 or page_bytes % 4:
        raise ValueError(f"ips_repack: page_bytes {page_bytes} must hold "
                         f"{tokens * feat * 2} bytes of data and be a "
                         "multiple of 4")
    if tokens * (feat // group) * 2 > MAX_SMEM:
        raise ValueError("ips_repack: a page's scales exceed a block's "
                         "shared memory")
    if pages:
        LAUNCHER.launch("ips_repack_arena",
                        (arena.data_ptr(), pages, page_bytes, tokens, feat,
                         group), arena.device)
    return arena
