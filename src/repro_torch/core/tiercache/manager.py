"""Tiered-cache manager: append, in-place switch (repack), policy ticks
and traffic metrics (the port of the reference's
`repro/core/tiercache/manager.py`: the `gqa`, `mla` and `encdec_self`
kinds; the last ticks its self-attention tiers as `gqa` does and leaves
the static cross tier beside them untouched).

Caches are flat dicts of tensors with a leading layer dimension plus the
watermarks `dense_len` / `total_len`. The reference traces both repack
branches and selects with `jnp.where`; the watermarks depend only on the
lengths and the policy, so the port keeps them on the host as ints and
runs a repack only where its predicate holds, writing the tiers in place.
The metrics are float32 scalars added in the reference's order (a branch
not taken adds 0.0 there, which changes nothing), so they equal the
reference's bit for bit, past 2^24 bytes included.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.tiercache.layout import (QUANT_CHANNELS, RAW_CHANNELS,
                                               TierSpec)
from repro_torch.core.tiercache.policy import Policy, plan_for
from repro_torch.kernels.ips_repack import ops as repack_ops
from repro_torch.kernels.ips_repack.ref import update_start

__all__ = ["zero_metrics", "add_metric", "repack_pages", "serve_tick",
           "write_amplification"]

METRICS = ("hbm_read_bytes", "hbm_write_bytes", "repack_tokens",
           "stall_events", "appended_tokens")


def zero_metrics():
    return {k: np.float32(0.0) for k in METRICS}


def add_metric(metrics, key, value) -> None:
    """metrics[key] += value in float32, the value rounded to float32
    first (as a weak-typed Python float meets a float32 array)."""
    metrics[key] = np.float32(metrics[key] + np.float32(value))


def _nbytes(shape, dtype) -> float:
    n = 1
    for d in shape:
        n *= d
    return float(n) * dtype.itemsize


def _update_dim2(buf, update, idx: int) -> None:
    """buf[:, :, idx:idx+len] = update, the start placed as
    `jax.lax.dynamic_update_slice` places it."""
    idx = update_start(idx, buf.shape[2], update.shape[2])
    buf[:, :, idx:idx + update.shape[2]] = update.to(buf.dtype)


def repack_pages(layers, kind, spec: TierSpec, dense_len: int, n_pages: int,
                 staging_copy: bool):
    """Move the oldest n_pages*page_tokens hot tokens into the dense tier,
    in place: every quantized channel straight from the hot tier into its
    dense tier at the watermark in one `ips_repack` launch, then each hot
    window rolled; a raw channel's first hot tokens copied to the
    watermark, then its hot region rolled. Returns (layers, read_bytes,
    write_bytes)."""
    t = n_pages * spec.page_tokens
    chans = QUANT_CHANNELS[kind]
    vals = [layers[hot][:, :, :t] for (_, _, hot) in chans]
    repack_ops.quantize_into([(v, layers[pk], layers[sc])
                              for v, (pk, sc, _) in zip(vals, chans)],
                             dense_len, spec.group)
    read_b = 0.0
    write_b = 0.0
    for v, (pk, sc, hot) in zip(vals, chans):
        lead, f = tuple(v.shape[:-1]), v.shape[-1]
        read_b += _nbytes(v.shape, layers[hot].dtype)
        wb = (_nbytes(lead + (f // 2,), torch.uint8)
              + _nbytes(lead + (f // spec.group,), layers[sc].dtype))
        write_b += wb * (2.0 if staging_copy else 1.0)
        # the reference rolls into a new buffer; the port rolls into a
        # temporary and copies back into the same storage
        layers[hot].copy_(torch.roll(layers[hot], -t, dims=2))
    for name in RAW_CHANNELS[kind]:
        buf = layers[name]
        hs, w = spec.s_dense, spec.hot_window
        # a copy first, as the reference slices before it updates
        moved = buf[:, :, hs:hs + t].clone()
        _update_dim2(buf, moved, dense_len)
        hot = buf[:, :, hs:hs + w]
        hot.copy_(torch.roll(hot, -t, dims=2))
        read_b += _nbytes(moved.shape, buf.dtype)
        write_b += (_nbytes(moved.shape, buf.dtype)
                    * (2.0 if staging_copy else 1.0))
    return layers, read_b, write_b


def _append_token(layers, kind, spec: TierSpec, kv_new, hot_idx: int):
    """kv_new: tuple of (n_slots, B, 1, ...) matching the kind's
    channels, the quantized ones first, then the raw ones (written at
    s_dense + hot_idx)."""
    write_b = 0.0
    quant = QUANT_CHANNELS[kind]
    for (pk, sc, hot), val in zip(quant, kv_new[:len(quant)]):
        _update_dim2(layers[hot], val, hot_idx)
        write_b += _nbytes(val.shape, layers[hot].dtype)
    for name, val in zip(RAW_CHANNELS[kind], kv_new[len(quant):]):
        _update_dim2(layers[name], val, spec.s_dense + hot_idx)
        write_b += _nbytes(val.shape, layers[name].dtype)
    return layers, write_b


def serve_tick(cache, kind, spec: TierSpec, policy: Policy, kv_new,
               metrics=None, layers_key="layers"):
    """Apply (policy-driven repack; append kv_new) to `cache`.

    cache: {layers_key: channel dict, "dense_len": int, "total_len": int};
    its tensors are updated in place. kv_new: tuple of per-channel
    (n_slots, B, 1, ...) new values. Returns (cache', metrics')."""
    if kind not in QUANT_CHANNELS:
        raise ValueError(f"unknown cache kind {kind!r}")
    metrics = dict(zero_metrics() if metrics is None else metrics)
    plan = plan_for(policy, spec.hot_window, spec.page_tokens)
    layers = cache[layers_key]
    dense_len, total_len = int(cache["dense_len"]), int(cache["total_len"])

    # --- background (AGC) pass: bg_pages whenever a full page is hot ---
    if plan.bg_pages and (total_len - dense_len
                          >= plan.bg_pages * spec.page_tokens + 1):
        layers, rb, wb = repack_pages(layers, kind, spec, dense_len,
                                      plan.bg_pages, False)
        moved = plan.bg_pages * spec.page_tokens
        dense_len += moved
        add_metric(metrics, "hbm_read_bytes", rb)
        add_metric(metrics, "hbm_write_bytes", wb)
        add_metric(metrics, "repack_tokens", moved)

    # --- sync path: hot window (about to be) full ---
    if total_len - dense_len + 1 > spec.hot_window:
        layers, rb, wb = repack_pages(layers, kind, spec, dense_len,
                                      plan.sync_pages, plan.staging_copy)
        moved = plan.sync_pages * spec.page_tokens
        dense_len += moved
        add_metric(metrics, "hbm_read_bytes", rb)
        add_metric(metrics, "hbm_write_bytes", wb)
        add_metric(metrics, "repack_tokens", moved)
        add_metric(metrics, "stall_events", 1.0)

    # --- append the new token to the hot tier ---
    layers, wb_append = _append_token(layers, kind, spec, kv_new,
                                      total_len - dense_len)
    add_metric(metrics, "hbm_write_bytes", wb_append)
    add_metric(metrics, "appended_tokens", 1.0)

    out = dict(cache)
    out[layers_key] = layers
    out["dense_len"] = dense_len
    out["total_len"] = total_len + 1
    return out, metrics


def write_amplification(metrics, logical_bytes_per_token=None):
    """HBM write bytes / logically appended KV bytes — the WA analogue."""
    appended = np.float32(max(metrics["appended_tokens"], np.float32(1.0)))
    if logical_bytes_per_token is None:
        return np.float32(metrics["hbm_write_bytes"] / appended)
    return np.float32(metrics["hbm_write_bytes"]
                      / (appended * np.float32(logical_bytes_per_token)))
