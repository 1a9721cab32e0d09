"""Training step: loss -> grads -> optimizer update, with optional
microbatch gradient accumulation (the port of the reference's
`repro/train/train_step.py`).

The model's layers are checkpointed inside its loss (`build_model`'s
`remat`); this module adds the optimizer plumbing. The parameters are
leaf tensors that require a gradient; `torch.autograd.grad` takes the
gradients of the loss with respect to them, and the update is added to
them in place, under `torch.no_grad()`, as are the optimizer's moments:
a state passed to the step is the state it returns, one step on.
"""
from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import torch

from repro_torch.optim import make_optimizer
from repro_torch.optim.adamw import tree_leaves, tree_map, tree_unflatten
from repro_torch.optim.schedules import cosine_with_warmup

__all__ = ["TrainState", "make_train_state", "global_norm",
           "make_train_step"]


class TrainState(NamedTuple):
    params: object               # nested dict of leaf tensors
    opt_state: object
    step: torch.Tensor           # int32 0-d


def make_train_state(bundle, gen: torch.Generator,
                     optimizer: str | None = None) -> TrainState:
    """Parameters drawn from `gen` on its device (`bundle.init`), made
    leaves that require a gradient, and the optimizer's zero state."""
    params = tree_map(lambda p: p.requires_grad_(True), bundle.init(gen))
    opt_init, _ = make_optimizer(optimizer or bundle.cfg.optimizer)
    with torch.no_grad():
        opt_state = opt_init(params)
    return TrainState(params=params, opt_state=opt_state,
                      step=torch.zeros((), dtype=torch.int32,
                                       device=gen.device))


def global_norm(tree):
    """sqrt of the sum over leaves (in the reference's order) of each
    leaf's float32 sum of squares."""
    total = None
    for x in tree_leaves(tree):
        sq = x.to(torch.float32).square().sum()
        total = sq if total is None else total + sq
    return total.sqrt()


def _split(batch, grad_accum: int) -> list:
    """The batch's leading dimension in grad_accum microbatches."""
    return [{k: v.reshape(grad_accum, v.shape[0] // grad_accum,
                          *v.shape[1:])[i] for k, v in batch.items()}
            for i in range(grad_accum)]


def make_train_step(bundle, *, optimizer: str | None = None,
                    schedule: Callable | None = None, grad_accum: int = 1,
                    clip_norm: float = 1.0):
    """Returns train_step(state, batch) -> (state, metrics); metrics are
    `loss`, `aux_loss`, `grad_norm`, `lr` and `total_loss`, 0-d
    tensors."""
    _, opt_update = make_optimizer(optimizer or bundle.cfg.optimizer)
    if schedule is None:
        schedule = functools.partial(cosine_with_warmup, peak_lr=3e-4,
                                     warmup_steps=100, total_steps=10_000)

    def grads_of(params, leaves, batch):
        loss, metrics = bundle.loss(params, batch)
        grads = list(torch.autograd.grad(loss, leaves))
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                grads)

    def compute_grads(params, batch):
        leaves = tree_leaves(params)
        if grad_accum == 1:
            return grads_of(params, leaves, batch)
        # microbatch accumulation: float32 gradients summed as g / n
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in leaves]
        acc_l = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        for mb in _split(batch, grad_accum):
            loss, metrics, grads = grads_of(params, leaves, mb)
            for a, g in zip(acc, grads):
                a.add_(g.to(torch.float32) / grad_accum)
            acc_l = acc_l + loss / grad_accum
            del grads
        return acc_l, metrics, acc

    def train_step(state: TrainState, batch):
        loss, metrics, grads = compute_grads(state.params, batch)
        with torch.no_grad():
            gnorm = global_norm(grads)
            scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-12),
                                max=1.0)
            # the reference multiplies by a float32 array, which promotes
            # a bf16 gradient to float32 (leaf by leaf: each bf16
            # gradient is freed as its float32 form is made)
            for i, g in enumerate(grads):
                grads[i] = g.to(torch.float32) * scale
            lr = schedule(state.step)
            grad_tree = tree_unflatten(state.params, grads)
            del grads
            updates, opt_state = opt_update(grad_tree, state.opt_state,
                                            state.params, lr)
            del grad_tree
            tree_map(lambda p, u: p.add_(u), state.params, updates)
        metrics = dict(metrics)
        metrics.update(grad_norm=gnorm, lr=lr, total_loss=loss)
        return TrainState(params=state.params, opt_state=opt_state,
                          step=state.step + 1), metrics

    return train_step

