"""Wrapper of the `ips_repack` CUDA kernel (`csrc/ips_repack.cu`): build,
argument checks, launch, launch count.

Three entry points, one kernel source:

* `quantize_into(channels, start, group)` — the in-place tier form on the
  serving path: every channel of a cache kind (K and V) in ONE launch,
  read where it lies in the hot tier and written straight into its dense
  tier at the watermark, the scales in the tier's own dtype. The tiered
  cache's prefill fill and every repack event call it.
* `quantize_rows(x, group)` — its contiguous case: (N, F) rows into new
  packed bytes and float32 scales (`core.tiercache.quant.quantize_int4`).
* `repack_arena(arena, tokens=, feat=, group=)` — the TPU kernel's arena
  contract, densifying every page in place on the same storage, one
  thread-block cluster a page.

Every even group that divides the feature axis is taken, as the
reference takes it. For tensors on a CUDA device each launches the
kernel or raises; tensors on the CPU go to the plain version in
`ref.py`. Nothing falls back.
"""
from __future__ import annotations

import ctypes
import os

import torch

from repro_torch.kernels._build import (BASE_FLAGS, LINK_FLAGS, Launcher,
                                        Library, check, kernel_route,
                                        refuse_grad)
from repro_torch.kernels.ips_repack import ref

__all__ = ["quantize_into", "quantize_rows", "repack_arena", "arena_smem",
           "LIB", "LAUNCHER", "reset", "SOURCE", "MAX_CHANNELS"]

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                      "ips_repack.cu")
MAX_SMEM = 232448
MAX_CHANNELS = 4
_VALUES = (torch.bfloat16, torch.float32)


def _bind(lib) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ips_quantize_into.argtypes = [i, ctypes.POINTER(ll), i, i, ll, i, i,
                                      i, i, p]
    lib.ips_quantize_into.restype = i
    lib.ips_repack_arena.argtypes = [p, ll, ll, i, i, i, p]
    lib.ips_repack_arena.restype = i
    lib.ips_arena_smem.argtypes = [i, i, i, ll]
    lib.ips_arena_smem.restype = ll


LIB = Library("ips_repack", SOURCE, BASE_FLAGS + LINK_FLAGS, _bind)
LAUNCHER = Launcher(LIB, "ips_repack")


def reset() -> None:
    """Zero the launch count and drop the recorded launch events."""
    LAUNCHER.reset()


def _check_group(feat: int, group: int) -> None:
    if group < 2 or group % 2:
        raise ValueError(f"ips_repack: group {group}; the reference takes an "
                         "even group of at least 2")
    if feat % group:
        raise ValueError(f"ips_repack: feat {feat} is not a multiple of "
                         f"group {group}")


def _check_block(name, t, dtypes, shape, device) -> None:
    """`t` on `device`, one of `dtypes`, of `shape`, and packed from dim 2
    on (the two leading dims may have any strides)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"ips_repack: {name} must be a tensor")
    if t.device != device:
        raise ValueError(f"ips_repack: {name} is on {t.device}, expected "
                         f"{device}")
    if t.dtype not in dtypes:
        raise TypeError(f"ips_repack: {name} has dtype {t.dtype}, the kernel "
                        f"takes {' or '.join(map(str, dtypes))}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"ips_repack: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    want = 1
    for d in range(t.dim() - 1, 1, -1):
        if t.shape[d] > 1 and t.stride(d) != want:
            raise ValueError(f"ips_repack: {name} must be contiguous from "
                             f"dim 2 on, strides {t.stride()}")
        want *= t.shape[d]


def quantize_into(channels, start: int, group: int = 64) -> None:
    """channels: up to four (src, packed, scales), all of one shape: src
    (A, B, T, ..., F) bf16 or float32 (any strides on A and B, packed from
    T on, e.g. the hot tier's `[:, :, :t]`); packed (A, B, S, ..., F//2)
    uint8 and scales (A, B, S, ..., F//group) bf16 or float32, the dense
    tier's buffers. Writes `quantize_int4(src)` into `packed[:, :, s:s+T]`
    and `scales[:, :, s:s+T]` in place, s = `start` placed as
    `jax.lax.dynamic_update_slice` places it (`ref.update_start`): one
    launch."""
    channels = list(channels)
    if not channels:
        return
    src0, packed0, scales0 = channels[0]
    if not kernel_route("ips_repack", src0):
        ref.quantize_into_ref(channels, start, group)
        return
    refuse_grad("ips_repack", channels)
    if len(channels) > MAX_CHANNELS:
        raise ValueError(f"ips_repack: {len(channels)} channels, one launch "
                         f"takes at most {MAX_CHANNELS}")
    if src0.dim() < 3:
        raise ValueError(f"ips_repack: src must be (A, B, T, ..., F), got "
                         f"{tuple(src0.shape)}")
    a, b, t, *rest, f = src0.shape
    _check_group(f, group)
    s_len = packed0.shape[2] if packed0.dim() > 2 else 0
    s = ref.update_start(start, s_len, t)
    for name, dtype in (("src", src0.dtype), ("scales", scales0.dtype)):
        if dtype not in _VALUES:
            raise TypeError(f"ips_repack: {name} has dtype {dtype}, the "
                            "kernel takes torch.bfloat16 or torch.float32")
    desc = []
    for src, packed, scales in channels:
        _check_block("src", src, (src0.dtype,), (a, b, t, *rest, f),
                     src0.device)
        _check_block("packed", packed, (torch.uint8,),
                     (a, b, s_len, *rest, f // 2), src0.device)
        _check_block("scales", scales, (scales0.dtype,),
                     (a, b, s_len, *rest, f // group), src0.device)
        desc += [src.data_ptr(), packed.data_ptr() + s * packed.stride(2),
                 scales.data_ptr()
                 + s * scales.stride(2) * scales.element_size(),
                 src.stride(0), src.stride(1), packed.stride(0),
                 packed.stride(1), scales.stride(0), scales.stride(1)]
    rows = t
    for d in rest:
        rows *= d
    if a * b * rows == 0:
        return
    if a * b > 65535:
        raise ValueError(f"ips_repack: {a} x {b} runs, a launch takes at "
                         "most 65535")
    LAUNCHER.launch("ips_quantize_into",
                    (len(channels), (ctypes.c_longlong * len(desc))(*desc),
                     a, b, rows, f, group,
                     int(src0.dtype == torch.bfloat16),
                     int(scales0.dtype == torch.bfloat16)), src0.device)


def quantize_rows(x: torch.Tensor, group: int = 64):
    """x: (N, F) bf16 or float32 -> (packed uint8 (N, F//2), scales
    float32 (N, F//group)), equal bit for bit to the plain version."""
    if not kernel_route("ips_repack", x):
        return ref.quantize_rows_ref(x, group)
    refuse_grad("ips_repack", x)
    if x.dim() != 2:
        raise ValueError(f"ips_repack: x must be (N, F), got "
                         f"{tuple(x.shape)}")
    n, f = x.shape
    _check_group(f, group)
    check("ips_repack", "x", x, _VALUES, (n, f), x.device)
    packed = torch.empty((n, f // 2), dtype=torch.uint8, device=x.device)
    scales = torch.empty((n, f // group), dtype=torch.float32,
                         device=x.device)
    quantize_into([(x[None, None], packed[None, None], scales[None, None])],
                  0, group)
    return packed, scales


def arena_smem(tokens: int, feat: int, group: int, align: int) -> int:
    """Shared memory one CTA of a page's cluster needs, as the kernel
    plans it (its ring of loads, the packed bytes and bf16 scales of its
    share of the rows); `align` is the arena's start OR its page_bytes."""
    return LIB.load().ips_arena_smem(tokens, feat, group, align)


def repack_arena(arena: torch.Tensor, *, tokens: int, feat: int,
                 group: int = 64) -> torch.Tensor:
    """arena: (pages, page_bytes) uint8 holding `tokens x feat` bf16 per
    page. Densifies every page in place (packed bytes, bf16 scales, stale
    tail kept) and returns `arena` itself."""
    if not kernel_route("ips_repack", arena):
        arena.copy_(ref.repack_ref(arena, tokens, feat, group))
        return arena
    _check_group(feat, group)
    if arena.dim() != 2:
        raise ValueError(f"ips_repack: arena must be (pages, page_bytes), "
                         f"got {tuple(arena.shape)}")
    pages, page_bytes = arena.shape
    check("ips_repack", "arena", arena, torch.uint8, (pages, page_bytes),
          arena.device)
    ref.page_layout(tokens, feat, group)
    if (tokens < 1 or page_bytes < tokens * feat * 2 or page_bytes % 4
            or arena.data_ptr() % 4):
        raise ValueError(f"ips_repack: page_bytes {page_bytes} must hold "
                         f"{tokens * feat * 2} bytes of data and, like the "
                         "arena's start, be a multiple of 4")
    smem = arena_smem(tokens, feat, group, arena.data_ptr() | page_bytes)
    if smem > MAX_SMEM:
        raise ValueError("ips_repack: a page's outputs exceed its cluster's "
                         f"shared memory ({smem} bytes a CTA, {MAX_SMEM} at "
                         "most)")
    if pages:
        LAUNCHER.launch("ips_repack_arena",
                        (arena.data_ptr(), pages, page_bytes, tokens, feat,
                         group), arena.device)
    return arena
