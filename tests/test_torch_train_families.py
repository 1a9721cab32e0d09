"""Port vs reference: every family's training loss and gradients, and
remat — the loss functions of `repro_torch.models` (`bundle.loss`) on
the reference's reduced models.

The reference's weights cross by `interop`; its batch is fed to both
sides. Float32 parameters: the loss at rtol 1e-5 and each gradient
leaf's rms error at most 1e-4 of its rms, leaf for leaf in the
reference's tree order, against `jax.value_and_grad(bundle.loss)`; bf16
at the serving strand's 2e-2. The MoE families replay the reference's
routes with the port's own gate weights, so the router's gradient flows
(`torch_port_util.replayed_routes_differentiable`). Torch runs one
thread a process here (`torch_threads`): the test workers share the
machine's cores.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.models import moe as j_moe
from repro.models.model_zoo import build_model as j_build
from repro.models.model_zoo import make_train_batch as j_batch
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.interop import model_params_from_jax
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import moe as t_moe
from repro_torch.models.model_zoo import build_model as t_build
from repro_torch.optim.adamw import tree_leaves
from torch_port_util import (recorded_routes, replayed_routes_differentiable,
                             to_numpy, to_torch)

F32_TOL = 1e-5          # the loss, relative
GRAD_RMS = 1e-4         # each gradient leaf's rms error, of its rms
BF16_TOL = 2e-2         # bf16 activations: the serving strand's


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    """One torch thread a process while this module runs: its tensors are
    small, and several test processes share the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _rms_ratio(got, want) -> float:
    want = np.asarray(want, np.float32)
    got = to_numpy(got).astype(np.float32)
    assert got.shape == want.shape
    err = np.sqrt(np.mean(np.square(got - want)))
    return float(err / max(np.sqrt(np.mean(np.square(want))), 1e-30))


FAMILIES = ("gemma-2b", "yi-6b", "deepseek-v2-lite-16b", "arctic-480b",
            "llava-next-34b", "mamba2-370m", "zamba2-1.2b", "whisper-tiny")
B, S, CHUNK = 2, 32, 16


def _is_tx(cfg):
    return cfg.family in ("dense", "moe", "vlm")


@functools.lru_cache(maxsize=None)
def _reference(name, dtype_name):
    """The reference's reduced model (remat off for the transformer
    families, so each MoE layer routes once), its weights and batch in
    `dtype`, and jax.value_and_grad of its loss; the MoE routes the
    reference took."""
    dtype = jnp.float32 if dtype_name == "float32" else jnp.bfloat16
    jcfg = J_ARCHS[name].reduced()
    jm = (j_build(jcfg, attn_chunk=CHUNK, remat=False) if _is_tx(jcfg)
          else j_build(jcfg, attn_chunk=CHUNK))
    jp = jax.tree.map(lambda x: x.astype(dtype)
                      if x.dtype == jnp.bfloat16 else x,
                      jax.jit(jm.init)(jax.random.PRNGKey(0)))
    batch = {k: (v.astype(dtype) if v.dtype == jnp.bfloat16 else v)
             for k, v in j_batch(jcfg, B, S, jax.random.PRNGKey(1)).items()}
    log = []
    with recorded_routes(j_moe, log):
        (loss, metrics), grads = jax.jit(jax.value_and_grad(
            jm.loss, has_aux=True))(jp, batch)
        jax.effects_barrier()
    np_params = jax.tree.map(np.asarray, jp)
    return (np_params, {k: np.asarray(v) for k, v in batch.items()},
            float(loss), float(metrics["aux_loss"]),
            [np.asarray(g) for g in jax.tree.leaves(grads)], log)


def _port_loss_and_grads(name, dtype_name, remat=False, replay=True):
    """The port's loss, metrics and gradients on the reference's weights
    and batch; a MoE model replays the reference's routes unless
    `replay` is False (then it routes by itself)."""
    params, batch, _, _, _, log = _reference(name, dtype_name)
    log = log if replay else []
    tcfg = T_ARCHS[name].reduced()
    tm = t_build(tcfg, attn_chunk=CHUNK, device="cpu", remat=remat)
    tp = model_params_from_jax(params, device="cpu")
    leaves = [p.requires_grad_(True) for p in tree_leaves(tp)]
    flips = []
    with replayed_routes_differentiable(t_moe, log, flips) if log else \
            _nothing():
        loss, metrics = tm.loss(tp, {k: to_torch(v)
                                     for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), metrics, grads, flips


class _nothing:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@pytest.mark.parametrize("name", FAMILIES)
def test_family_loss_and_grads_match_the_reference(name):
    """Float32 parameters: the loss (rtol 1e-5), the aux loss, and every
    gradient leaf (rms error at most 1e-4 of its rms) against
    `jax.value_and_grad(bundle.loss)`, leaf for leaf in the reference's
    tree order."""
    _, _, j_loss, j_aux, j_grads, log = _reference(name, "float32")
    loss, metrics, grads, flips = _port_loss_and_grads(name, "float32")
    assert (len(log) > 0) == (T_ARCHS[name].moe is not None)
    if log:
        assert flips[0] == len(log) and flips[2] == 0, flips
    np.testing.assert_allclose(float(loss), j_loss, rtol=F32_TOL)
    np.testing.assert_allclose(float(metrics["aux_loss"].detach()), j_aux,
                               rtol=F32_TOL, atol=1e-7)
    assert len(grads) == len(j_grads)
    for i, (g, r) in enumerate(zip(grads, j_grads)):
        assert g.dtype == torch.float32
        assert _rms_ratio(g, r) <= GRAD_RMS, (name, i, _rms_ratio(g, r))


@pytest.mark.parametrize("name", ("gemma-2b", "mamba2-370m", "whisper-tiny"))
def test_family_loss_and_grads_bf16(name):
    """bf16 parameters and activations: the loss within 2e-2 of the
    reference's, gradients in the reference's dtypes, and each gradient
    leaf within 2e-2 (rms, of its rms) of the reference's float32
    gradient at the same weights, or no further from it than the
    reference's own bf16 gradient is (mamba2's D, a sum of terms that
    cancel: the reference's bf16 gradient is some 4% off its float32
    one, the port's some 1%)."""
    _, _, j_loss, _, j_grads, _ = _reference(name, "bf16")
    _, _, _, _, j_exact, _ = _reference(name, "float32")
    loss, _, grads, _ = _port_loss_and_grads(name, "bf16")
    np.testing.assert_allclose(float(loss), j_loss, rtol=BF16_TOL)
    for i, (g, r, x) in enumerate(zip(grads, j_grads, j_exact)):
        assert to_numpy(g).dtype == r.dtype
        own = _rms_ratio(to_torch(r), x)
        assert _rms_ratio(g, x) <= max(BF16_TOL, own), (
            name, i, _rms_ratio(g, x), own)


@pytest.mark.parametrize("remat", (True, "blocks"), ids=str)
@pytest.mark.parametrize("name", ("gemma-2b", "deepseek-v2-lite-16b",
                                  "mamba2-370m", "zamba2-1.2b",
                                  "whisper-tiny"))
def test_remat_gives_the_same_loss_and_grads(name, remat):
    """remat True and "blocks" recompute what remat False keeps: the same
    loss and gradients (the same operations, so to the last bit). A MoE
    model routes by itself here: its recomputed layers route again, to
    the same experts."""
    loss0, _, grads0, _ = _port_loss_and_grads(name, "float32",
                                               replay=False)
    loss1, _, grads1, _ = _port_loss_and_grads(name, "float32", remat,
                                               replay=False)
    assert torch.equal(loss0, loss1)
    for g0, g1 in zip(grads0, grads1):
        assert torch.equal(g0, g1)


def test_remat_checkpoints_the_layers():
    """Under remat the backward recomputes each layer's forward: the
    flash kernel's route runs twice a layer (gemma reduced, 2 layers);
    without it, once."""
    params, batch, *_ = _reference("gemma-2b", "float32")
    counts = {}
    for remat in (False, True, "blocks"):
        tm = t_build(T_ARCHS["gemma-2b"].reduced(), attn_chunk=CHUNK,
                     device="cpu", remat=remat)
        tp = model_params_from_jax(params, device="cpu")
        leaves = [p.requires_grad_(True) for p in tree_leaves(tp)]
        calls = []
        orig = flash_ops.flash_fwd
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(flash_ops, "flash_fwd",
                       lambda *a, **kw: calls.append(1) or orig(*a, **kw))
            loss, _ = tm.loss(tp, {k: to_torch(v) for k, v in batch.items()})
            torch.autograd.grad(loss, leaves)
        counts[str(remat)] = len(calls)
    assert counts == {"False": 2, "True": 4, "blocks": 4}
