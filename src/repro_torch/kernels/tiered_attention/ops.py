"""Wrappers of the `tiered_decode` CUDA kernel (`csrc/tiered_decode.cu`)
and of its latent form (`csrc/latent_decode.cu`), and the full tiered
decode attention around each.

`dense_tier_partial` computes the int4 dense tier's online-softmax
partials: for tensors on a CUDA device it launches the kernel or raises;
tensors on the CPU go to the plain version, `ref.dense_tier_partial_ref`.
Nothing falls back. `tiered_decode_attention` merges that partial with
the bf16 hot tail's and the current token's, which stay plain PyTorch
(as in the reference's `tiered_attention/ops.py`: the tail is at most a
few thousand tokens). `latent_tier_partial` and `latent_decode_attention`
are the same for MLA's absorbed decode (one int4 latent serving as key
and value of every head, plus a raw bf16 RoPE key); its plain version is
`ref.latent_tier_partial_ref`.
"""
from __future__ import annotations

import ctypes
import os

import torch

from repro_torch.kernels._build import (BASE_FLAGS, LINK_FLAGS, Launcher,
                                        Library, check, kernel_route,
                                        refuse_grad)
from repro_torch.kernels.tiered_attention import ref
from repro_torch.kernels.tiered_attention.ref import merge_partials

__all__ = ["dense_tier_partial", "tiered_decode_attention",
           "latent_tier_partial", "latent_decode_attention",
           "merge_partials", "split_plan", "latent_split_plan",
           "latent_check", "LIB",
           "LAUNCHER", "LATENT_LIB", "LATENT_LAUNCHER", "reset", "SOURCE",
           "LATENT_SOURCE"]

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                      "tiered_decode.cu")
LATENT_SOURCE = os.path.join(os.path.dirname(SOURCE), "latent_decode.cu")
HEAD_DIMS = (16, 32, 64, 128, 256)
MAX_G = 16
# blocks of 128 threads the split is sized for: eight on each of the
# H100's 132 SMs
TARGET_BLOCKS = 8 * 132
MAX_SPLITS = 4096


def _bind(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.tiered_dense_partial.argtypes = [p, p, p, p, p, i, i, p, p, p,
                                         p, p, p, i, i, i, i, i, i, i, i, i,
                                         ctypes.c_float, p]
    lib.tiered_dense_partial.restype = i


def _bind_latent(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.latent_tier_partial.argtypes = [p, p, p, p, p, p, p, p, p, p, p,
                                        i, i, i, i, i, i, i, i, i, i,
                                        ctypes.c_float, p]
    lib.latent_tier_partial.restype = i


LIB = Library("tiered_decode", SOURCE, BASE_FLAGS + LINK_FLAGS, _bind)
LAUNCHER = Launcher(LIB, "tiered_decode")
LATENT_LIB = Library("latent_decode", LATENT_SOURCE,
                     BASE_FLAGS + LINK_FLAGS, _bind_latent)
LATENT_LAUNCHER = Launcher(LATENT_LIB, "latent_decode")
# the latent form's limits (csrc/latent_decode.cu)
LATENT_MAX_H = 16
LATENT_MAX_R = 512
LATENT_ROPE_DIMS = (16, 32, 64)
# the latent kernel's tile of tokens, and the blocks its split is sized
# for: one a SM (a block takes some 162 KB of shared memory)
LATENT_TILE = 64
LATENT_TARGET_BLOCKS = 132


def reset() -> None:
    """Zero the launch counts and drop the recorded launch events."""
    LAUNCHER.reset()
    LATENT_LAUNCHER.reset()


def split_plan(dense_len: int, b: int, hkv: int, g: int):
    """(tokens a block, number of splits) of the kernel's split of
    [0, dense_len) for g query heads per KV head: a multiple of the
    tokens a block takes at a time (32 when its four warps share the
    query heads, g > 1; 128 when each warp takes its own 32, g = 1), so
    that B * Hkv * splits comes near TARGET_BLOCKS, and at most
    MAX_SPLITS splits; one split (empty) when dense_len is 0."""
    def up(n, m):
        return -(-n // m) * m
    step = 128 if g == 1 else 32
    tokens = max(step, up(-(-dense_len * b * hkv // TARGET_BLOCKS), step),
                 up(-(-dense_len // MAX_SPLITS), step))
    return tokens, max(1, -(-dense_len // tokens))


def dense_tier_partial(q, k4, k4_sc, v4, v4_sc, dense_len: int, *,
                       group: int = 64, deq_dtype=torch.float32):
    """The contract of `ref.dense_tier_partial_ref`: q (B, Hkv, G, hd)
    float32, k4/v4 (B, S, Hkv, hd//2) uint8, scales (B, S, Hkv,
    hd//group) bf16 or float32, dense_len an int. Returns float32
    (m, l, acc)."""
    dense_len = int(dense_len)
    if not kernel_route("tiered_decode", q):
        return ref.dense_tier_partial_ref(q, k4, k4_sc, v4, v4_sc, dense_len,
                                          group, deq_dtype)
    refuse_grad("tiered_decode", q, k4, k4_sc, v4, v4_sc)
    if deq_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"tiered_decode: deq_dtype {deq_dtype}; the kernel "
                        "has float32 and bf16 forms")
    if q.dim() != 4 or k4.dim() != 4:
        raise ValueError("tiered_decode: q must be (B, Hkv, G, hd) and k4 "
                         "(B, S, Hkv, hd//2)")
    b, hkv, g, hd = q.shape
    s = k4.shape[1]
    if hd not in HEAD_DIMS:
        raise ValueError(f"tiered_decode: head_dim {hd}; the kernel takes "
                         f"{HEAD_DIMS}")
    if not 1 <= g <= MAX_G:
        raise ValueError(f"tiered_decode: {g} query heads per KV head; the "
                         f"kernel takes 1..{MAX_G}")
    if group < 2 or group % 2 or hd % group:
        raise ValueError(f"tiered_decode: group {group} does not divide "
                         f"head_dim {hd} in even groups")
    if not 0 <= dense_len <= s:
        raise ValueError(f"tiered_decode: dense_len {dense_len} outside "
                         f"[0, {s}]")
    dev = q.device
    check("tiered_decode", "q", q, torch.float32, (b, hkv, g, hd), dev)
    for name, t in (("k4", k4), ("v4", v4)):
        check("tiered_decode", name, t, torch.uint8, (b, s, hkv, hd // 2),
              dev)
    sc_dtypes = (torch.bfloat16, torch.float32)
    check("tiered_decode", "k4_sc", k4_sc, sc_dtypes,
          (b, s, hkv, hd // group), dev)
    check("tiered_decode", "v4_sc", v4_sc, (k4_sc.dtype,),
          (b, s, hkv, hd // group), dev)
    if b * hkv > 65535:
        raise ValueError(f"tiered_decode: B * Hkv = {b * hkv}; the merge "
                         "grid takes at most 65535")
    m = torch.empty((b, hkv, g), dtype=torch.float32, device=dev)
    l = torch.empty((b, hkv, g), dtype=torch.float32, device=dev)
    acc = torch.empty((b, hkv, g, hd), dtype=torch.float32, device=dev)
    tokens, splits = split_plan(dense_len, b, hkv, g)
    parts = (None, None, None)
    if splits > 1:                   # each split's partial, then the merge
        parts = tuple(torch.empty((b, hkv, splits, g) + extra,
                                  dtype=torch.float32, device=dev)
                      for extra in ((), (), (hd,)))
    LAUNCHER.launch("tiered_dense_partial",
                    (q.data_ptr(), k4.data_ptr(), k4_sc.data_ptr(),
                     v4.data_ptr(), v4_sc.data_ptr(),
                     int(k4_sc.dtype == torch.bfloat16),
                     int(deq_dtype == torch.bfloat16), m.data_ptr(),
                     l.data_ptr(), acc.data_ptr(),
                     *(None if t is None else t.data_ptr() for t in parts),
                     b, s, hkv, g, hd, group, dense_len, tokens, splits,
                     1.0 / (hd ** 0.5)), dev)
    return m, l, acc


def _bf16_partial(q, k, v, valid):
    """q: (B, Hkv, G, hd) float32; k/v: (B, W, Hkv, hd); valid: (B, W)
    bool."""
    hd = q.shape[-1]
    scores = torch.einsum("bkgd,bskd->bkgs", q,
                          k.to(torch.float32)) / (hd ** 0.5)
    mask = valid[:, None, None, :]
    scores = torch.where(mask, scores, ref.NEG_INF)
    m = scores.amax(dim=-1)
    p = torch.exp(scores - m[..., None])
    p = torch.where(mask, p, 0.0)
    l = p.sum(dim=-1)
    acc = torch.einsum("bkgs,bskd->bkgd", p, v.to(torch.float32))
    return m, l, acc


def tiered_decode_attention(q, lc, dense_len: int, total_len: int, k_new,
                            v_new, *, group: int = 64,
                            deq_dtype=torch.float32):
    """q: (B, 1, H, hd) after RoPE; lc: one layer's tier dict {k4, k4_sc,
    v4, v4_sc, kh, vh}; k_new/v_new: (B, 1, Hkv, hd), the current token.
    Returns the (B, 1, H, hd) float32 attention output (before the out
    projection)."""
    b, _, h, hd = q.shape
    hkv = lc["kh"].shape[2]
    g = h // hkv
    qg = q[:, 0].reshape(b, hkv, g, hd).to(torch.float32).contiguous()
    tier = (qg, lc["k4"], lc["k4_sc"], lc["v4"], lc["v4_sc"], dense_len)
    dense = dense_tier_partial(*tier, group=group, deq_dtype=deq_dtype)
    w = lc["kh"].shape[1]
    hot_valid = (dense_len + torch.arange(w, device=q.device)
                 < total_len).expand(b, w)
    hot = _bf16_partial(qg, lc["kh"], lc["vh"], hot_valid)
    self_valid = torch.ones((b, 1), dtype=torch.bool, device=q.device)
    self_p = _bf16_partial(qg, k_new, v_new, self_valid)
    out, _, _ = merge_partials([dense, hot, self_p])        # (B,Hkv,G,hd)
    return out.reshape(b, 1, h, hd)


def latent_split_plan(dense_len: int, b: int):
    """(tokens a block, number of splits) of the latent kernel's split of
    [0, dense_len): whole 64-token tiles, so that B * splits comes near
    LATENT_TARGET_BLOCKS, and at most MAX_SPLITS splits; one split
    (empty) when dense_len is 0."""
    def up(n, m):
        return -(-n // m) * m
    tile = LATENT_TILE
    tokens = max(tile, up(-(-dense_len * b // LATENT_TARGET_BLOCKS), tile),
                 up(-(-dense_len // MAX_SPLITS), tile))
    return tokens, max(1, -(-dense_len // tokens))


def latent_check(q_lat, q_rope, c4, c4_sc, krope, dense_len: int,
                 group: int) -> None:
    """Raise on what the latent kernel does not take (the C entry's
    refusals: heads, rank and RoPE width, group, dense_len, batch; then
    each tensor's device, dtype, shape and layout)."""
    if q_lat.dim() != 3 or q_rope.dim() != 3 or c4.dim() != 3 or (
            krope.dim() != 3):
        raise ValueError("latent_decode: q_lat must be (B, H, r), q_rope "
                         "(B, H, p), c4 (B, S, r//2) and krope (B, S_raw, "
                         "p)")
    b, h, r = q_lat.shape
    p = q_rope.shape[2]
    s, s_raw = c4.shape[1], krope.shape[1]
    if not 1 <= h <= LATENT_MAX_H:
        raise ValueError(f"latent_decode: {h} heads; the kernel takes "
                         f"1..{LATENT_MAX_H}")
    if r % 64 or not 64 <= r <= LATENT_MAX_R:
        raise ValueError(f"latent_decode: rank {r}; the kernel takes a "
                         f"multiple of 64 up to {LATENT_MAX_R}")
    if p not in LATENT_ROPE_DIMS:
        raise ValueError(f"latent_decode: rope dim {p}; the kernel takes "
                         f"{LATENT_ROPE_DIMS}")
    if group < 2 or group % 2 or r % group:
        raise ValueError(f"latent_decode: group {group} does not divide "
                         f"rank {r} in even groups")
    if not 0 <= dense_len <= s or s_raw < s:
        raise ValueError(f"latent_decode: dense_len {dense_len} outside "
                         f"[0, {s}] or krope shorter ({s_raw}) than the "
                         "tier")
    if b > 65535:
        raise ValueError(f"latent_decode: batch {b}; the grid takes at "
                         "most 65535")
    dev = q_lat.device
    check("latent_decode", "q_lat", q_lat, torch.float32, (b, h, r), dev)
    check("latent_decode", "q_rope", q_rope, torch.float32, (b, h, p), dev)
    check("latent_decode", "c4", c4, torch.uint8, (b, s, r // 2), dev)
    check("latent_decode", "c4_sc", c4_sc, torch.bfloat16,
          (b, s, r // group), dev)
    check("latent_decode", "krope", krope, torch.bfloat16, (b, s_raw, p),
          dev)


def latent_tier_partial(q_lat, q_rope, c4, c4_sc, krope, dense_len: int, *,
                        group: int = 64, scale: float = 1.0):
    """The contract of `ref.latent_tier_partial_ref`: q_lat (B, H, r) and
    q_rope (B, H, p) float32; c4 (B, S, r//2) uint8, c4_sc (B, S,
    r//group) bf16; krope (B, S_raw, p) bf16 with S_raw >= S, its first
    dense_len rows the dense tokens. Returns float32 (m (B, H), l (B, H),
    acc (B, H, r)) over tokens [0, dense_len)."""
    dense_len = int(dense_len)
    if not kernel_route("latent_decode", q_lat):
        return ref.latent_tier_partial_ref(q_lat, q_rope, c4, c4_sc, krope,
                                           dense_len, group, scale)
    refuse_grad("latent_decode", q_lat, q_rope, c4, c4_sc, krope)
    latent_check(q_lat, q_rope, c4, c4_sc, krope, dense_len, group)
    # q, latent and RoPE rows go by 16-byte copies: an unaligned view is
    # copied into a fresh buffer first
    q_lat, q_rope, c4, krope = (t if t.data_ptr() % 16 == 0 else t.clone()
                                for t in (q_lat, q_rope, c4, krope))
    b, h, r = q_lat.shape
    dev = q_lat.device
    tokens, splits = latent_split_plan(dense_len, b)

    def alloc(n):
        """(acc (n, r), m (n,), l (n,)) float32 in one allocation, acc
        first (16-byte aligned)."""
        buf = torch.empty(n * (r + 2), dtype=torch.float32, device=dev)
        return buf[:n * r], buf[n * r:n * (r + 1)], buf[n * (r + 1):]
    acc, m, l = alloc(b * h)
    acc, m, l = acc.view(b, h, r), m.view(b, h), l.view(b, h)
    parts = (None, None, None)
    if splits > 1:                   # each split's partial, then the merge
        acc_p, m_p, l_p = alloc(b * splits * h)
        parts = (m_p, l_p, acc_p)
    LATENT_LAUNCHER.launch(
        "latent_tier_partial",
        (q_lat.data_ptr(), q_rope.data_ptr(), c4.data_ptr(),
         c4_sc.data_ptr(), krope.data_ptr(), m.data_ptr(), l.data_ptr(),
         acc.data_ptr(),
         *(None if t is None else t.data_ptr() for t in parts),
         b, c4.shape[1], krope.shape[1], h, r, q_rope.shape[2], group,
         dense_len, tokens, splits, float(scale)), dev)
    return m, l, acc


def latent_decode_attention(q_lat, q_rope, lc, dense_len: int,
                            total_len: int, c_new, kr_new, *,
                            group: int = 64, scale: float = 1.0):
    """MLA's absorbed decode attention over one layer's tiered latent
    cache. q_lat (B, H, r) and q_rope (B, H, p) float32; lc {c4, c4_sc,
    ch, krope} (`layout.mla_layer_zeros`: krope's dense rows at absolute
    positions, its hot rows from s_dense); c_new (B, 1, r) and kr_new (B,
    1, p), the current token. Returns the (B, H, r) float32 context in
    the latent (before W_uv)."""
    s_dense, w = lc["c4"].shape[1], lc["ch"].shape[1]
    dense = latent_tier_partial(q_lat, q_rope, lc["c4"], lc["c4_sc"],
                                lc["krope"], dense_len, group=group,
                                scale=scale)
    hot_valid = (dense_len + torch.arange(w, device=q_lat.device)
                 < total_len)
    hot = ref.latent_partial(q_lat, q_rope, lc["ch"],
                             lc["krope"][:, s_dense:s_dense + w], hot_valid,
                             scale)
    # the current token as the cache holds it (the reference appends it
    # cast to the cache's dtype)
    self_valid = torch.ones((1,), dtype=torch.bool, device=q_lat.device)
    self_p = ref.latent_partial(q_lat, q_rope, c_new.to(lc["ch"].dtype),
                                kr_new.to(lc["krope"].dtype), self_valid,
                                scale)
    out, _, _ = merge_partials([dense, hot, self_p])
    return out
