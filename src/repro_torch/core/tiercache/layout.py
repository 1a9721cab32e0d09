"""Tiered KV-cache arena layout (the port of the reference's
`repro/core/tiercache/layout.py`: the `gqa`, `mla` and `encdec_self`
kinds).

Two tiers per cache channel (k, v, or MLA's latent):

* dense tier — packed int4 + groupwise bf16 scales, absolute-indexed
  positions [0, dense_len). The TLC analogue.
* hot tier — bf16 sliding window holding positions
  [dense_len, total_len), slot j = position dense_len + j. The SLC
  analogue.

An "in-place switch" (repack) converts the oldest hot pages to int4 at
the dense watermark and slides the hot window (manager.py). All state is
a flat dict of tensors with a leading layer dimension, plus the scalars
`dense_len` / `total_len`, which the port keeps on the host as ints.
Raw channels (MLA's RoPE key) follow the same dense/hot split without
quantization, in one buffer: the dense region [0, s_dense) at absolute
positions, the hot region from s_dense. An encoder-decoder's
`encdec_self` kind is `gqa`'s self-attention tiers beside a static int4
cross tier (`cross_static_zeros`: the encoder's K and V, quantized once
at the prefill, never appended to and never repacked).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.kernels.ips_repack import ops as repack_ops

__all__ = ["TierSpec", "QUANT_CHANNELS", "RAW_CHANNELS", "gqa_layer_zeros",
           "mla_layer_zeros", "cross_static_zeros", "split_for_prefill",
           "fill_quant_channels", "fill_raw_channel"]


@dataclass(frozen=True)
class TierSpec:
    s_max: int                  # max logical tokens (cache capacity target)
    hot_window: int = 1024      # bf16 tail capacity (tokens)
    page_tokens: int = 256      # repack granularity ("two layers" analogue)
    group: int = 64             # int4 quant group along the feature axis

    @property
    def s_dense(self) -> int:   # dense tier capacity
        return self.s_max + self.hot_window

    def __post_init__(self):
        assert self.hot_window % self.page_tokens == 0


# channel schemas per cache kind: (packed, scales, hot) names for quantized
# channels; single-buffer names for raw channels.
QUANT_CHANNELS = {
    "gqa": (("k4", "k4_sc", "kh"), ("v4", "v4_sc", "vh")),
    "mla": (("c4", "c4_sc", "ch"),),
    "encdec_self": (("k4", "k4_sc", "kh"), ("v4", "v4_sc", "vh")),
}
RAW_CHANNELS = {
    "gqa": (),
    "mla": ("krope",),
    "encdec_self": (),
}


def gqa_layer_zeros(n_slots, b, spec: TierSpec, hkv, hd,
                    sc_dtype=torch.bfloat16, device="cuda"):
    g = spec.group

    def z(s, f, dt):
        return torch.zeros((n_slots, b, s, hkv, f), dtype=dt, device=device)

    return {"k4": z(spec.s_dense, hd // 2, torch.uint8),
            "k4_sc": z(spec.s_dense, hd // g, sc_dtype),
            "v4": z(spec.s_dense, hd // 2, torch.uint8),
            "v4_sc": z(spec.s_dense, hd // g, sc_dtype),
            "kh": z(spec.hot_window, hd, torch.bfloat16),
            "vh": z(spec.hot_window, hd, torch.bfloat16)}


def mla_layer_zeros(n_slots, b, spec: TierSpec, rank, rope_dim,
                    sc_dtype=torch.bfloat16, device="cuda"):
    g = spec.group

    def z(s, f, dt):
        return torch.zeros((n_slots, b, s, f), dtype=dt, device=device)

    return {"c4": z(spec.s_dense, rank // 2, torch.uint8),
            "c4_sc": z(spec.s_dense, rank // g, sc_dtype),
            "ch": z(spec.hot_window, rank, torch.bfloat16),
            # raw channel: dense region [0, s_dense) absolute + hot
            # [s_dense, s_dense + W)
            "krope": z(spec.s_dense + spec.hot_window, rope_dim,
                       torch.bfloat16)}


def cross_static_zeros(n_slots, b, f, hkv, hd, group=64,
                       sc_dtype=torch.bfloat16, device="cuda"):
    """The static cross tier of `f` encoder frames: packed int4 K and V
    and their groupwise scales, every frame dense."""
    def z(feat, dt):
        return torch.zeros((n_slots, b, f, hkv, feat), dtype=dt,
                           device=device)

    return {"ck4": z(hd // 2, torch.uint8),
            "ck4_sc": z(hd // group, sc_dtype),
            "cv4": z(hd // 2, torch.uint8),
            "cv4_sc": z(hd // group, sc_dtype)}


def split_for_prefill(s: int, spec: TierSpec):
    """How a bulk write of s tokens splits into (dense_prefix, hot_tail)."""
    w0 = max(0, s - spec.hot_window)
    w0 = (w0 + spec.page_tokens - 1) // spec.page_tokens * spec.page_tokens
    w0 = min(w0, s)
    return w0, s - w0


def fill_quant_channels(buffers, channels, values, spec: TierSpec):
    """values: per channel of `channels` ((packed, scales, hot) names), a
    (n_slots, B, S, ...feat) bf16 bulk write -> tier buffers: the dense
    prefix quantized into every channel's dense tier in one `ips_repack`
    launch, the tail copied into the hot tier. Writes into the given
    buffers in place (the reference returns updated copies) and returns
    (buffers, w0)."""
    s = values[0].shape[2]
    w0, tail = split_for_prefill(s, spec)
    for packed_name, _, hot_name in channels:
        if (w0 > buffers[packed_name].shape[2]
                or tail > buffers[hot_name].shape[2]):
            raise ValueError(f"a prefill of {s} tokens does not fit the "
                             f"tiers ({buffers[packed_name].shape[2]} dense, "
                             f"{buffers[hot_name].shape[2]} hot)")
    if w0:
        repack_ops.quantize_into([(v[:, :, :w0], buffers[pk], buffers[sc])
                                  for v, (pk, sc, _) in zip(values, channels)],
                                 0, spec.group)
    if tail:
        for v, (_, _, hot) in zip(values, channels):
            buffers[hot][:, :, :tail] = v[:, :, w0:].to(buffers[hot].dtype)
    return buffers, w0


def fill_raw_channel(buffers, name, values, spec: TierSpec):
    """Raw (unquantized) channel: values (n_slots, B, S, feat) -> the
    dense part at absolute positions, the hot part from s_dense; in place.
    Returns (buffers, w0)."""
    s = values.shape[2]
    w0, tail = split_for_prefill(s, spec)
    buf = buffers[name]
    if w0 > spec.s_dense or spec.s_dense + tail > buf.shape[2]:
        raise ValueError(f"a prefill of {s} tokens does not fit the raw "
                         f"channel {name} ({buf.shape[2]} rows)")
    if w0:
        buf[:, :, :w0] = values[:, :, :w0].to(buf.dtype)
    if tail:
        buf[:, :, spec.s_dense:spec.s_dense + tail] = values[:, :, w0:].to(
            buf.dtype)
    return buffers, w0
