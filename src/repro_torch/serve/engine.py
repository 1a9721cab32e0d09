"""Serving engine: prefill + greedy decode over the IPS tiered KV cache
(the port of the reference's `repro/serve/engine.py`: the `gqa`, `mla`,
`encdec_self`, `ssm` and `hybrid` cache kinds).

serve_step = model decode + cache maintenance tick (append + policy-driven
in-place switch). The tick is where the paper's four schemes differ:
BASELINE migrates (staged, 2x traffic, stall), IPS switches in place on
fill, IPS_AGC densifies one page per step in the background, COOP runs an
enlarged window. Per-step HBM traffic metrics accumulate beside the cache,
so the write-amplification analogues are counted, not estimated. An `ssm`
model has no KV cache: each step rewrites its conv and SSM states, and
the policy changes nothing. A `hybrid` model ticks the shared attention
block's tiered cache and adds its macro layers' state bytes. An
encoder-decoder (`encdec_self`) ticks its decoder's self-attention
tiers; its static cross tier is never appended to or repacked.
"""
from __future__ import annotations

import torch

from repro_torch.core.tiercache.layout import TierSpec
from repro_torch.core.tiercache.manager import (add_metric, serve_tick,
                                                zero_metrics)
from repro_torch.core.tiercache.policy import Policy, plan_for
from repro_torch.models.model_zoo import ModelBundle

__all__ = ["make_tier_spec", "make_prefill_step", "make_serve_step",
           "decode_loop"]


def make_tier_spec(bundle: ModelBundle, seq_len: int, policy: Policy,
                   hot_window: int = 1024, page_tokens: int = 256,
                   group: int = 64) -> TierSpec:
    plan = plan_for(policy, hot_window, page_tokens)
    return TierSpec(s_max=seq_len,
                    hot_window=hot_window * plan.hot_window_mult,
                    page_tokens=page_tokens, group=group)


def make_prefill_step(bundle: ModelBundle, spec: TierSpec):
    def prefill_step(params, batch):
        return bundle.prefill(params, batch, spec)
    return prefill_step


def make_serve_step(bundle: ModelBundle, spec: TierSpec, policy: Policy):
    """Returns serve_step(params, cache, token, metrics) ->
    (next_token, logits, cache, metrics)."""
    kind = bundle.cache_kind
    if kind not in ("gqa", "mla", "encdec_self", "ssm", "hybrid"):
        raise ValueError(f"unknown cache kind {kind!r}")

    def serve_step(params, cache, token, metrics):
        logits, kv_new = bundle.decode(params, token, cache, spec)
        if kind in ("gqa", "mla", "encdec_self"):
            cache, metrics = serve_tick(cache, kind, spec, policy, kv_new,
                                        metrics)
        elif kind == "ssm":
            conv, ssm = kv_new
            cache = dict(cache, conv=conv, ssm=ssm,
                         total_len=cache["total_len"] + 1,
                         dense_len=cache["dense_len"] + 1)
            metrics = dict(metrics)
            add_metric(metrics, "hbm_write_bytes", _state_bytes(conv, ssm))
            add_metric(metrics, "appended_tokens", 1.0)
        else:
            conv, ssm = kv_new["macro_states"]
            cache = dict(cache, macro_conv=conv, macro_ssm=ssm)
            if kv_new["tail_states"] is not None:
                cache.update(tail_conv=kv_new["tail_states"][0],
                             tail_ssm=kv_new["tail_states"][1])
            cache, metrics = serve_tick(cache, "gqa", spec, policy,
                                        kv_new["attn_kv"], metrics,
                                        layers_key="attn")
            # the reference counts the macro layers' states only
            add_metric(metrics, "hbm_write_bytes", _state_bytes(conv, ssm))
        next_token = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        return next_token, logits, cache, metrics

    return serve_step


def _state_bytes(conv, ssm) -> float:
    return float(conv.numel() * conv.element_size()
                 + ssm.numel() * ssm.element_size())


def decode_loop(bundle: ModelBundle, params, cache, first_token,
                n_steps: int, spec: TierSpec, policy: Policy):
    """Greedy decode, one serve_step per token. Returns (tokens (B,
    n_steps), cache, metrics)."""
    serve_step = make_serve_step(bundle, spec, policy)
    token, metrics = first_token, zero_metrics()
    tokens = []
    for _ in range(n_steps):
        token, _, cache, metrics = serve_step(params, cache, token, metrics)
        tokens.append(token[:, 0])
    if not tokens:
        return first_token[:, :0], cache, metrics
    return torch.stack(tokens, dim=1), cache, metrics
