"""Optimizers: AdamW and Adafactor (factored, for 480B-class models); the
port of the reference's `repro/optim/adamw.py`.

The reference's functional API, without `torch.optim`:
  init(params) -> state;  update(grads, state, params, lr) -> (updates,
  state). Updates include the -lr factor and are applied as
  params + updates. A parameter tree is a nested dict of tensors; the
  state's trees mirror it.

Each leaf's update is formed in float32, cast to the parameter's dtype,
then added, as the reference forms it (`torch.optim` would round
differently). The float32 moments are updated in place — the returned
state holds the same tensors as the one passed in — which keeps one
copy of them on the card; the arithmetic is the reference's, step for
step.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple

import torch

__all__ = ["AdamWConfig", "AdamWState", "adamw_init", "adamw_update",
           "AdafactorConfig", "AdafactorState", "adafactor_init",
           "adafactor_update", "make_optimizer", "tree_map", "tree_leaves",
           "tree_unflatten"]


def tree_map(fn, tree, *rest):
    """fn over the leaves of nested dicts (the parameter tree), with the
    matching leaves of `rest` as further arguments."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of nested dicts (and lists) in the reference's order
    (`jax.tree` sorts a dict's keys)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, list):
        return [leaf for x in tree for leaf in tree_leaves(x)]
    return [tree]


def tree_unflatten(tree, leaves: list):
    """`leaves` (in `tree_leaves` order) placed in the structure of
    nested dicts `tree`."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)
    return build(tree)


def _f32_scalar(x, like) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


@dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1


class AdamWState(NamedTuple):
    step: torch.Tensor           # int32 0-d
    mu: Any
    nu: Any


def adamw_init(params, cfg: AdamWConfig = AdamWConfig()) -> AdamWState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    first = tree_leaves(params)[0]
    return AdamWState(step=torch.zeros((), dtype=torch.int32,
                                       device=first.device),
                      mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def adamw_update(grads, state: AdamWState, params, lr,
                 cfg: AdamWConfig = AdamWConfig()):
    """One AdamW step over the tree. `lr` a float32 0-d tensor (or a
    float). Returns (updates in each parameter's dtype, new state)."""
    step = state.step + 1
    b1, b2 = cfg.b1, cfg.b2
    t = step.to(torch.float32)
    # 1 - b ** t in float32, as the reference's float32 power
    c1 = 1 - _f32_scalar(b1, t) ** t
    c2 = 1 - _f32_scalar(b2, t) ** t
    lr = _f32_scalar(lr, t)

    def upd(g, m, n, p):
        g = g.to(torch.float32)
        m.mul_(b1).add_((1 - b1) * g)
        n.mul_(b2).add_((1 - b2) * (g * g))
        u = (m / c1).div_((n / c2).sqrt_().add_(cfg.eps))
        u.add_(cfg.weight_decay * p.to(torch.float32))
        return (-lr * u).to(p.dtype)

    updates = tree_map(upd, grads, state.mu, state.nu, params)
    return updates, AdamWState(step=step, mu=state.mu, nu=state.nu)


# ---------------------------------------------------------------------------
# Adafactor — factored second moments: O(r+c) state for matrices instead
# of O(r*c); the only optimizer whose state fits a 480B MoE on one pod.
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class AdafactorConfig:
    decay: float = 0.8
    eps: float = 1e-30
    clip_threshold: float = 1.0
    weight_decay: float = 0.0


class AdafactorState(NamedTuple):
    step: torch.Tensor
    vr: Any      # row stats (or full stats for <2D leaves)
    vc: Any      # col stats (zeros-sized () for <2D leaves)


def _factored(p) -> bool:
    return p.dim() >= 2


def adafactor_init(params, cfg: AdafactorConfig = AdafactorConfig()):
    def vr_init(p):
        shape = p.shape[:-1] if _factored(p) else p.shape
        return torch.zeros(shape, dtype=torch.float32, device=p.device)

    def vc_init(p):
        shape = (p.shape[:-2] + p.shape[-1:]) if _factored(p) else ()
        return torch.zeros(shape, dtype=torch.float32, device=p.device)

    first = tree_leaves(params)[0]
    return AdafactorState(step=torch.zeros((), dtype=torch.int32,
                                           device=first.device),
                          vr=tree_map(vr_init, params),
                          vc=tree_map(vc_init, params))


def adafactor_update(grads, state: AdafactorState, params, lr,
                     cfg: AdafactorConfig = AdafactorConfig()):
    """One Adafactor step over the tree. Returns (updates in each
    parameter's dtype, new state)."""
    step = state.step + 1
    t = step.to(torch.float32)
    beta = 1.0 - t ** (-cfg.decay)
    lr = _f32_scalar(lr, t)

    def upd(g, vr, vc, p):
        g = g.to(torch.float32)
        g2 = g * g + cfg.eps
        if _factored(p):
            vr.mul_(beta).add_((1 - beta) * g2.mean(dim=-1))
            vc.mul_(beta).add_((1 - beta) * g2.mean(dim=-2))
            r = vr / torch.clamp(vr.mean(dim=-1, keepdim=True), min=cfg.eps)
            u = g / (r.sqrt()[..., None] * vc.sqrt()[..., None, :]
                     + cfg.eps)
        else:
            vr.mul_(beta).add_((1 - beta) * g2)
            u = g / (vr.sqrt() + cfg.eps)
        norm = (u * u).mean().sqrt()
        u = u / torch.clamp(norm / cfg.clip_threshold, min=1.0)
        if cfg.weight_decay:
            u = u + cfg.weight_decay * p.to(torch.float32)
        return (-lr * u).to(p.dtype)

    updates = tree_map(upd, grads, state.vr, state.vc, params)
    return updates, AdafactorState(step=step, vr=state.vr, vc=state.vc)


# ---------------------------------------------------------------------------


def make_optimizer(name: str):
    """(init, update) of "adamw" or "adafactor"."""
    if name == "adamw":
        return adamw_init, adamw_update
    if name == "adafactor":
        return adafactor_init, adafactor_update
    raise ValueError(f"unknown optimizer {name!r}")
