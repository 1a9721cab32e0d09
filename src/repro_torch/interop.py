"""State and weights carried across from the reference package.

The simulator has no weights; what one implementation hands the other is
its carry. `state_from_jax` and `params_from_jax` take the leaves of the
reference's `SimState` / `CellParams` as numpy arrays — in field order,
absent optional fields skipped, as `jax.tree.leaves` lists them — and
return the port's tensors, dtype for dtype. Nothing here imports JAX:
the caller converts (`[np.asarray(x) for x in jax.tree.leaves(state)]`).

A carry may be one cell's or a fleet's (a leading cell axis on every
leaf). The wear carry (`SimState.wear`) and the endurance knobs
(`CellParams.endurance`) cross as their eight trailing leaves; optional
carries that do not cross (the telemetry timeline, which the port's
entry points build themselves, and the host tier) show up as other
extra leaves and are refused.

The serving path's model parameters and tiered caches cross as nested
dicts of numpy arrays (`jax.tree.map(np.asarray, params)`):
`model_params_from_jax` and `cache_from_jax` return the port's trees,
dtype for dtype (bf16 arrives as ml_dtypes' `bfloat16` and crosses by
its bits), and refuse a leaf they do not know.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.core.ssd.endurance.model import EnduranceParams, WearState
from repro_torch.core.ssd.policies.state import CellParams, SimState

__all__ = ["state_from_jax", "params_from_jax", "model_params_from_jax",
           "cache_from_jax"]

_PLANE_INT = ("int32", "int16")
_STATE_DTYPES = {
    "busy": ("float32",), "slc_used": _PLANE_INT, "rp_done": _PLANE_INT,
    "trad_used": _PLANE_INT, "valid_mig": _PLANE_INT, "epoch": _PLANE_INT,
    "loc": ("int8",), "loc_ep": ("int16",), "counters": ("float32",),
    "prev_t": ("float32",), "idle_cum": ("float32",),
    "idle_seen": ("float32",)}
_PARAM_DTYPES = {"cap_basic": "int32", "cap_trad": "int32",
                 "idle_thr": "float32", "waste_p": "float32",
                 "cap_boost": "int32"}


def _tensor(name, x, dtypes, device):
    """A numpy leaf as a tensor of the same dtype on `device`; bf16
    (ml_dtypes' `bfloat16`) crosses by its bits."""
    arr = np.asarray(x)
    if arr.dtype.name not in dtypes:
        raise TypeError(f"{name}: dtype {arr.dtype.name}, expected "
                        f"{' or '.join(dtypes)}")
    arr = np.array(arr, order="C")
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


# the carry's base fields, by name (`wear` and `timeline` trail them)
_BASE_STATE = tuple(_STATE_DTYPES)
_BASE_PARAMS = tuple(_PARAM_DTYPES)          # `endurance` and `hostcache`
#                                              trail them


def state_from_jax(leaves: Sequence, *, device="cuda") -> SimState:
    """The reference's SimState leaves (numpy, field order) as a port
    SimState: the 12 base fields, optionally followed by the 8 leaves of
    the wear carry. A carry with telemetry or host-tier leaves is
    refused."""
    leaves = list(leaves)
    n_base, n_wear = len(_BASE_STATE), len(WearState._fields)
    if len(leaves) not in (n_base, n_base + n_wear):
        raise ValueError(
            f"expected the {n_base} base SimState leaves {_BASE_STATE}, "
            f"or those and the {n_wear} wear leaves, got {len(leaves)}: "
            "telemetry and host-tier leaves do not cross")
    wear = None
    if len(leaves) > n_base:
        wear = WearState(*(_tensor(f, x, ("float32",), device) for f, x in
                           zip(WearState._fields, leaves[n_base:])))
    state = SimState(*(_tensor(f, x, _STATE_DTYPES[f], device)
                       for f, x in zip(_BASE_STATE, leaves)), wear=wear)
    plane = {state.slc_used.dtype, state.rp_done.dtype,
             state.trad_used.dtype, state.valid_mig.dtype,
             state.epoch.dtype}
    if len(plane) != 1:
        raise TypeError("integer plane fields mix packed and unpacked "
                        f"dtypes: {sorted(map(str, plane))}")
    return state


def params_from_jax(leaves: Sequence, *, device="cuda") -> CellParams:
    """The reference's CellParams leaves (numpy, field order) as a port
    CellParams. Four leaves mean `cap_boost` was None (read as 0); the
    five base leaves may be followed by the 8 endurance knobs; any other
    count (host-tier knobs) is refused."""
    leaves = list(leaves)
    if len(leaves) == 4:
        leaves.append(np.zeros_like(np.asarray(leaves[0]), np.int32))
    n_base, n_end = len(_BASE_PARAMS), len(EnduranceParams._fields)
    if len(leaves) not in (n_base, n_base + n_end):
        raise ValueError(
            f"expected the CellParams leaves {_BASE_PARAMS}, or those and "
            f"the {n_end} endurance knobs, got {len(leaves)}: host-tier "
            "knobs do not cross (`hostcache.model.as_hc_params`)")
    endurance = None
    if len(leaves) > n_base:
        endurance = EnduranceParams(*(
            _tensor(f, x, ("float32",), device)
            for f, x in zip(EnduranceParams._fields, leaves[n_base:])))
    return CellParams(*(_tensor(f, x, (_PARAM_DTYPES[f],), device)
                        for f, x in zip(_BASE_PARAMS, leaves)),
                      endurance=endurance)


_W = ("bfloat16", "float32")
_F32 = ("float32",)
_MAMBA = {"in_proj": _W, "conv_w": _W, "conv_b": _W, "A_log": _F32,
          "D": _F32, "dt_bias": _F32, "norm": _W, "out_proj": _W}
# GQA's {wq, wk, wv, wo} and MLA's {wq, w_dkv, w_uk, w_uv, wo, kv_norm}
_ATTN = {k: _W for k in ("wq", "wk", "wv", "wo", "w_dkv", "w_uk", "w_uv",
                         "kv_norm")}
_MLP = {k: _W for k in ("w_gate", "w_up", "w_down")}
_MOE = {"router": _F32, "w_gate": _W, "w_up": _W, "w_down": _W,
        "shared": _MLP, "dense_residual": _MLP}
_LAYERS = {"ln1": _W, "ln2": _W, "attn": _ATTN, "mlp": _MLP, "moe": _MOE,
           "ln": _W, "mamba": _MAMBA}
# the parameter trees of the dense, moe, vlm, ssm, hybrid and audio
# (encoder-decoder) families: leaf name -> the dtypes it may have
_MODEL_LEAVES = {
    "embed": _W, "final_norm": _W, "unembed": _W,
    "first_dense": _LAYERS, "layers": _LAYERS,
    "macro": {"ln": _W, "mamba": _MAMBA},
    "tail": {"ln": _W, "mamba": _MAMBA},
    "shared": {"attn": _ATTN, "mlp": _MLP, "ln1": _W, "ln2": _W},
    "enc_layers": {"attn": _ATTN, "mlp": _MLP, "ln1": _W, "ln2": _W},
    "enc_norm": _W,
    "dec_layers": {"self_attn": _ATTN, "cross_attn": _ATTN, "mlp": _MLP,
                   "ln1": _W, "lnx": _W, "ln2": _W}}
# the gqa tiers {k4, k4_sc, v4, v4_sc, kh, vh}, the mla tiers {c4,
# c4_sc, ch, krope} and the encoder-decoder's static cross tier {ck4,
# ck4_sc, cv4, cv4_sc}
_TIER_LEAVES = {"k4": ("uint8",), "v4": ("uint8",), "k4_sc": _W,
                "v4_sc": _W, "kh": ("bfloat16",), "vh": ("bfloat16",),
                "c4": ("uint8",), "c4_sc": _W, "ch": ("bfloat16",),
                "krope": ("bfloat16",), "ck4": ("uint8",), "ck4_sc": _W,
                "cv4": ("uint8",), "cv4_sc": _W}
# the caches: "layers" (gqa, mla) or "attn" (hybrid) hold the tiers; the
# Mamba2 states are conv (bf16) and ssm (float32)
_CACHE_LEAVES = {"layers": _TIER_LEAVES, "attn": _TIER_LEAVES,
                 "conv": ("bfloat16",), "ssm": _F32,
                 "macro_conv": ("bfloat16",), "macro_ssm": _F32,
                 "tail_conv": ("bfloat16",), "tail_ssm": _F32}


def _tree(name, tree, schema, device):
    if not isinstance(tree, dict):
        raise TypeError(f"{name}: expected a dict of arrays")
    out = {}
    for key, x in tree.items():
        path = f"{name}/{key}" if name else key
        if key not in schema:
            raise ValueError(f"{path}: the port does not hold this leaf")
        if isinstance(schema[key], dict):
            out[key] = _tree(path, x, schema[key], device)
        else:
            out[key] = _tensor(path, x, schema[key], device)
    return out


def model_params_from_jax(tree, *, device="cuda"):
    """The reference's parameter tree of a dense, moe, vlm, ssm, hybrid
    or encoder-decoder model (numpy leaves) as the port's tree of tensors
    on `device`."""
    return _tree("", tree, _MODEL_LEAVES, device)


def cache_from_jax(tree, *, device="cuda"):
    """A reference serving cache (numpy leaves): the tiered gqa, mla or
    encdec_self cache ({"layers", "dense_len", "total_len"}; encdec_self's
    layers hold the static cross tier too), the ssm states ({"conv",
    "ssm", ...}) or the hybrid's ({"attn", "macro_conv", "macro_ssm",
    "tail_conv", "tail_ssm", ...}), as the port's: tensors on `device`,
    the watermarks as ints."""
    scalars = {"dense_len", "total_len"}
    out = _tree("", {k: v for k, v in tree.items() if k not in scalars},
                _CACHE_LEAVES, device)
    for k in scalars:
        out[k] = int(np.asarray(tree[k]))
    return out
