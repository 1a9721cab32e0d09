"""Stand-ins for every model input on `torch.device("meta")` — the dry
run's inputs; port of the reference package's `launch/specs.py`.

Nothing is allocated: parameters come from the real `bundle.init` with
every factory call sent to the meta device (`on_meta`), optimizer state
from the real optimizer init over them, caches from the real cache
builders on meta, batches are written out directly. Modality frontends
are stubs, as in the reference: whisper gets (B, frames, d_model)
embeddings, llava gets (B, patches, d_model). The port keeps a cache's
`total_len` and `dense_len` as host ints; the stand-ins hold them as
int32 scalars, as the reference's cache does, and the metrics as float32
scalars.
"""
from __future__ import annotations

import contextlib
from typing import Dict

import torch
from torch.overrides import TorchFunctionMode

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core.tiercache.manager import METRICS
from repro_torch.core.tiercache.policy import Policy
from repro_torch.models.model_zoo import ModelBundle
from repro_torch.serve.engine import make_tier_spec

__all__ = ["META", "on_meta", "sds", "batch_specs", "params_specs",
           "opt_state_specs", "decode_cache_specs", "metrics_specs",
           "input_specs"]

META = torch.device("meta")


class _MetaFactories(TorchFunctionMode):
    """Every call that names a device gets the meta device instead (the
    models draw on `gen.device`; a CPU generator draws on meta)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if "device" in kwargs:
            kwargs["device"] = META
        return func(*args, **kwargs)


def on_meta():
    """Context in which the model code allocates on meta."""
    return _MetaFactories()


def sds(shape, dtype) -> torch.Tensor:
    """A stand-in of `shape` and `dtype` (a meta tensor)."""
    return torch.empty(shape, dtype=dtype, device=META)


def batch_specs(cfg: ArchConfig, batch: int, seq_len: int) -> Dict:
    out = {"tokens": sds((batch, seq_len), torch.int32)}
    if cfg.vlm is not None:
        out["patch_embeds"] = sds((batch, cfg.vlm.num_patches, cfg.d_model),
                                  torch.bfloat16)
    if cfg.encdec is not None:
        out["frames"] = sds((batch, cfg.encdec.encoder_seq_len, cfg.d_model),
                            torch.bfloat16)
    return out


def params_specs(bundle: ModelBundle):
    """The parameters `bundle.init` draws, on meta."""
    with on_meta():
        return bundle.init(torch.Generator().manual_seed(0))


def opt_state_specs(cfg: ArchConfig, params):
    """The optimizer state of `cfg.optimizer` over meta parameters."""
    from repro_torch.optim import make_optimizer
    opt_init, _ = make_optimizer(cfg.optimizer)
    with torch.no_grad(), on_meta():
        return opt_init(params)


def _int32_scalars(cache):
    return {k: (sds((), torch.int32) if k in ("total_len", "dense_len")
                else v) for k, v in cache.items()}


def decode_cache_specs(bundle: ModelBundle, batch: int, seq_len: int,
                       policy: Policy = Policy.IPS_AGC):
    """(cache stand-ins, tier spec) of a decode at `seq_len`."""
    spec = make_tier_spec(bundle, seq_len, policy)
    with on_meta():
        cache = bundle.make_decode_cache(batch, seq_len, spec, device=META)
    return _int32_scalars(cache), spec


def metrics_specs() -> Dict:
    return {k: sds((), torch.float32) for k in METRICS}


def input_specs(bundle: ModelBundle, shape: ShapeConfig,
                policy: Policy = Policy.IPS_AGC) -> Dict:
    """Everything the (arch x shape) cell's step function consumes."""
    cfg = bundle.cfg
    if shape.kind in ("train", "prefill"):
        return {"batch": batch_specs(cfg, shape.global_batch, shape.seq_len)}
    if shape.kind == "decode":
        cache, spec = decode_cache_specs(bundle, shape.global_batch,
                                         shape.seq_len, policy)
        return {"token": sds((shape.global_batch, 1), torch.int32),
                "cache": cache, "tier_spec": spec,
                "metrics": metrics_specs()}
    raise ValueError(shape.kind)
