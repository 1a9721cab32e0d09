"""Port vs reference: the training path — the flash Function and the SSD
intra-chunk Function under autograd, the raw kernel wrappers' refusal to
run under it, the chunked cross-entropy, AdamW and Adafactor, the
schedules, the train step, the data pipeline and the launcher (every
family's loss and gradients, and remat: test_torch_train_families.py).

Inputs are made with numpy from seeds; model weights are the
reference's, carried across by `interop`. The reference runs live on
the CPU (its attention backward is its `custom_vjp` `_flash_bwd`, its
Mamba2 scan the jnp `ssd_chunked`). Float32 parameters are held tight:
the loss at rtol 1e-5, each gradient leaf's rms error at most 1e-4 of
its rms, single tensors at 1e-5 of their largest magnitude (other
summation orders). Torch runs one thread a process here
(`torch_threads`): the test workers share the machine's cores. The data
pipeline
cannot draw `jax.random`'s bits (ROADMAP C), so the comparisons feed the
reference's batches to both sides, and the pipeline is held to the
reference's properties.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import make_batch as j_make_batch
from repro.models import attention as j_attn
from repro.models import mamba2 as j_m2
from repro.models.layers import chunked_softmax_xent as j_xent
from repro.models.model_zoo import build_model as j_build
from repro.optim import adafactor_init as j_afi
from repro.optim import adafactor_update as j_afu
from repro.optim import adamw_init as j_awi
from repro.optim import adamw_update as j_awu
from repro.optim import compress as j_compress
from repro.optim import schedules as j_sched
from repro.train.train_step import TrainState as JTrainState
from repro.train.train_step import make_train_step as j_make_step
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.data.pipeline import DataConfig, batch_iterator, make_batch
from repro_torch.interop import model_params_from_jax
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention import ref as flash_ref
from repro_torch.kernels.host_tier import ops as host_ops
from repro_torch.kernels.host_tier.ref import TierJob
from repro_torch.kernels.ips_repack import ops as repack_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_step import ops as step_ops
from repro_torch.kernels.tiered_attention import ops as tiered_ops
from repro_torch.launch import train as t_launch
from repro_torch.models import attention as t_attn
from repro_torch.models.layers import chunked_softmax_xent as t_xent
from repro_torch.models.model_zoo import build_model as t_build
from repro_torch.optim import adamw as t_adamw
from repro_torch.optim import compress as t_compress
from repro_torch.optim import schedules as t_sched
from repro_torch.optim.adamw import tree_leaves
from repro_torch.train.train_step import (TrainState, global_norm,
                                          make_train_state, make_train_step)
from torch_port_util import to_numpy, to_torch

F32_TOL = 1e-5          # single tensors, of their largest magnitude
S, CHUNK = 32, 16       # tokens a row; the models' attention chunk


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    """One torch thread a process while this module runs: its tensors are
    small, and several test processes share the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _close(got, want, tol, label):
    want = np.asarray(want, np.float32)
    got = (to_numpy(got) if isinstance(got, torch.Tensor)
           else np.asarray(got)).astype(np.float32)
    assert got.shape == want.shape, f"{label}: {got.shape} != {want.shape}"
    assert np.isfinite(got).all(), f"{label}: non-finite values"
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * float(np.abs(want).max() + 1e-30),
                               err_msg=label)


# ---------------------------------------------------------------------------
# the flash Function
# ---------------------------------------------------------------------------

# (label, B, Sq, Sk, H, Hkv, hd, hd_v, causal, chunk): the prefill's
# causal self-attention (iota positions; one S off the chunk), the
# encoder's non-causal self-attention, the decoder's cross-attention;
# GQA (H 4 over 2) and MQA (over 1)
FLASH_CASES = (
    ("causal-gqa", 2, 48, 48, 4, 2, 16, 16, True, 16),
    ("causal-mqa", 2, 48, 48, 4, 1, 16, 16, True, 16),
    ("causal-ragged", 2, 40, 40, 4, 2, 16, 16, True, 16),
    ("noncausal-gqa", 2, 40, 40, 4, 2, 16, 16, False, 16),
    ("noncausal-mqa", 2, 32, 32, 4, 1, 16, 16, False, 16),
    ("cross-gqa", 2, 24, 40, 4, 2, 16, 16, False, 16),
    ("cross-mqa", 2, 24, 40, 4, 1, 16, 16, False, 16),
    ("causal-widths", 2, 40, 40, 4, 4, 24, 16, True, 16),
)


def _flash_inputs(case, seed=0):
    _, b, sq, sk, h, hkv, hd, hd_v, causal, chunk = case
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, sk, hkv, hd)).astype(np.float32)
    v = rng.standard_normal((b, sk, hkv, hd_v)).astype(np.float32)
    w = rng.standard_normal((b, sq, h, hd_v)).astype(np.float32)
    return q, k, v, w


def _j_flash_grads(case, q, k, v, w):
    causal, chunk = case[8], case[9]
    pos = jnp.arange(q.shape[1], dtype=jnp.int32) if causal else None

    def loss(q, k, v):
        out = j_attn.attend_chunked(q, k, v, q_positions=pos,
                                    kv_positions=pos, causal=causal,
                                    chunk=chunk)
        return jnp.sum(out * w)
    return jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                             jnp.asarray(v))


def _t_flash_grads(case, q, k, v, w):
    causal, chunk = case[8], case[9]
    tq, tk, tv = (to_torch(x).requires_grad_(True) for x in (q, k, v))
    pos = torch.arange(q.shape[1], dtype=torch.int32) if causal else None
    out = t_attn.attend_chunked(tq, tk, tv, q_positions=pos,
                                kv_positions=pos, causal=causal, chunk=chunk,
                                iota=causal)
    return torch.autograd.grad((out * to_torch(w)).sum(), (tq, tk, tv))


@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: c[0])
def test_flash_function_grads_match_the_reference(case):
    """(dq, dk, dv) through `attend_chunked` against `jax.grad` of the
    reference's (its `custom_vjp` `_flash`)."""
    q, k, v, w = _flash_inputs(case)
    want = _j_flash_grads(case, q, k, v, w)
    flash_ops.reset()
    got = _t_flash_grads(case, q, k, v, w)
    assert flash_ops.BACKWARD.calls == 1
    for name, g, r in zip("qkv", got, want):
        _close(g, r, F32_TOL, f"{case[0]} d{name}")


@pytest.mark.parametrize("case", [c for c in FLASH_CASES if c[8]],
                         ids=lambda c: c[0])
def test_flash_function_matches_autograd_through_flash_ref(case):
    """The Function's chunked-recomputation backward against plain
    autograd through the plain forward, `ref.flash_ref`."""
    q, k, v, w = _flash_inputs(case, seed=1)
    got = _t_flash_grads(case, q, k, v, w)
    tq, tk, tv = (to_torch(x).requires_grad_(True) for x in (q, k, v))
    out, _ = flash_ref.flash_ref(tq, tk, tv, chunk=case[9])
    want = torch.autograd.grad(
        (out.transpose(1, 2) * to_torch(w)).sum(), (tq, tk, tv))
    for name, g, r in zip("qkv", got, want):
        _close(g, r.numpy(), F32_TOL, f"{case[0]} d{name}")


def test_flash_padded_widths_pad_before_the_function(monkeypatch):
    """On the kernel's route, widths it does not take (MLA's: q and k 24
    here, v 16) are padded to its next width before `FlashAttnFn` and
    cut after it: the Function sees 32, autograd the pad, and the
    gradients are the reference's at the unpadded widths. The kernel's
    route is taken as on a card, the plain version standing in for the
    kernel."""
    case = FLASH_CASES[-1]
    q, k, v, w = _flash_inputs(case, seed=2)
    seen = []

    def kernel(q, k, v, *, chunk, scale):
        seen.append((q.shape[-1], k.shape[-1], v.shape[-1], scale))
        return flash_ref.flash_ref(q, k, v, chunk=chunk, scale=scale)

    monkeypatch.setattr(flash_ops, "kernel_route", lambda *a: True)
    monkeypatch.setattr(flash_ops, "flash_fwd", kernel)
    got = _t_flash_grads(case, q, k, v, w)
    assert seen == [(32, 32, 32, pytest.approx(1 / np.sqrt(24)))]
    want = _j_flash_grads(case, q, k, v, w)
    for name, g, r in zip("qkv", got, want):
        assert g.shape == r.shape
        _close(g, r, F32_TOL, f"widths d{name}")


def test_flash_function_saves_only_out_and_lse():
    """What autograd keeps of the Function: its inputs, the float32 out
    and the lse; no (B, H, Sq, C) probability tensor."""
    case = FLASH_CASES[0]
    q, k, v, _ = _flash_inputs(case)
    tq, tk, tv = (to_torch(x).requires_grad_(True) for x in (q, k, v))
    out, lse = flash_ops.flash_attention(tq, tk, tv, chunk=16)
    saved = [t for t in out.grad_fn.saved_tensors if t is not None]
    b, s, h, _ = q.shape
    assert sorted(tuple(t.shape) for t in saved) == sorted([
        tq.shape, tk.shape, tv.shape, (b, h, s, 16), (b, h, s)])
    assert not lse.requires_grad


# ---------------------------------------------------------------------------
# the SSD intra-chunk Function
# ---------------------------------------------------------------------------


def _ssd_inputs(b, s, nh, hd, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, nh, hd)).astype(np.float32)
    dt = (0.5 * rng.random((b, s, nh)) + 0.05).astype(np.float32)
    a = -(rng.random(nh) + 0.5).astype(np.float32)
    bb = rng.standard_normal((b, s, n)).astype(np.float32)
    c = rng.standard_normal((b, s, n)).astype(np.float32)
    h0 = rng.standard_normal((b, nh, hd, n)).astype(np.float32)
    wy = rng.standard_normal((b, s, nh, hd)).astype(np.float32)
    wh = rng.standard_normal((b, nh, hd, n)).astype(np.float32)
    return (x, dt, a, bb, c, h0), (wy, wh)


@pytest.mark.parametrize("chunk", (8, 16, 64))
def test_ssd_intra_function_grads_match_the_reference(chunk):
    """Every input's gradient through the port's chunked scan (the
    `SsdIntraFn` contraction and the inter-chunk recurrence) against
    `jax.grad` of the reference's jnp `ssd_chunked`."""
    inputs, (wy, wh) = _ssd_inputs(2, 64, 4, 8, 16, seed=chunk)

    def j_loss(*args):
        y, h = j_m2.ssd_chunked(*args[:5], chunk, h0=args[5])
        return jnp.sum(y * wy) + jnp.sum(h * wh)
    want = jax.grad(j_loss, argnums=tuple(range(6)))(
        *map(jnp.asarray, inputs))
    ts = [to_torch(x).requires_grad_(True) for x in inputs]
    y, h = ssd_ops.ssd_chunked_kernel(*ts[:5], chunk, h0=ts[5])
    got = torch.autograd.grad((y * to_torch(wy)).sum()
                              + (h * to_torch(wh)).sum(), ts)
    for name, g, r in zip(("x", "dt", "A", "B", "C", "h0"), got, want):
        _close(g, r, F32_TOL, f"chunk {chunk} d{name}")


def test_ssd_intra_function_matches_autograd_through_the_plain_version():
    """`SsdIntraFn`'s gradients are those of `ref.intra_chunk_ref` under
    plain autograd, for every output at once."""
    rng = np.random.default_rng(5)
    bt, nc, q, nh, hd, n = 2, 3, 16, 4, 8, 16
    arrs = [rng.standard_normal((bt, nc, q, nh, hd)),
            0.5 * rng.random((bt, nc, q, nh)) + 0.05,
            -(rng.random(nh) + 0.5),
            rng.standard_normal((bt, nc, q, n)),
            rng.standard_normal((bt, nc, q, n))]
    outs_w = [rng.standard_normal(s) for s in
              ((bt, nc, q, nh, hd), (bt, nc, nh, hd, n), (bt, nc, q, nh))]
    ws = [torch.tensor(w, dtype=torch.float32) for w in outs_w]

    def grads(fn):
        ts = [torch.tensor(a, dtype=torch.float32, requires_grad=True)
              for a in arrs]
        outs = fn(*ts)
        return torch.autograd.grad(sum((o * w).sum()
                                       for o, w in zip(outs, ws)), ts)
    got = grads(ssd_ops.SsdIntraFn.apply)
    want = grads(ssd_ops.ref.intra_chunk_ref)
    for g, r in zip(got, want):
        assert torch.equal(g, r)


# ---------------------------------------------------------------------------
# the raw wrappers refuse to run under autograd
# ---------------------------------------------------------------------------


def _f(*shape, grad=True):
    return torch.zeros(shape, dtype=torch.float32, requires_grad=grad)


def _u8(*shape):
    return torch.zeros(shape, dtype=torch.uint8)


def _raw_calls():
    """(module, call) for each raw wrapper, called on inputs one of
    which requires a gradient."""
    from repro_torch.configs.ssd_paper import PAPER_SSD
    from repro_torch.core.ssd.sim import default_params
    cfg = PAPER_SSD.scaled(128)
    return {
        "flash_fwd": (flash_ops, lambda: flash_ops.flash_fwd(
            _f(1, 8, 2, 16), _f(1, 8, 1, 16, grad=False),
            _f(1, 8, 1, 16, grad=False))),
        "ssd_intra": (ssd_ops, lambda: ssd_ops.ssd_intra(
            _f(1, 1, 8, 2, 16), _f(1, 1, 8, 2, grad=False),
            _f(2, grad=False), _f(1, 1, 8, 16, grad=False),
            _f(1, 1, 8, 16, grad=False))),
        "tiered_decode": (tiered_ops, lambda: tiered_ops.dense_tier_partial(
            _f(1, 1, 2, 16), _u8(1, 8, 1, 8), _f(1, 8, 1, 1, grad=False),
            _u8(1, 8, 1, 8), _f(1, 8, 1, 1, grad=False), 8, group=16)),
        "latent_decode": (tiered_ops, lambda: tiered_ops.latent_tier_partial(
            _f(1, 2, 64), _f(1, 2, 16, grad=False), _u8(1, 8, 32),
            _f(1, 8, 1, grad=False), _f(1, 8, 16, grad=False), 8)),
        "ips_repack rows": (repack_ops, lambda: repack_ops.quantize_rows(
            _f(4, 64))),
        "ips_repack into": (repack_ops, lambda: repack_ops.quantize_into(
            [(_f(1, 1, 4, 64), _u8(1, 1, 4, 32),
              _f(1, 1, 4, 1, grad=False))], 0, 64)),
        "ssd_step": (step_ops, lambda: step_ops.run_streams(cfg, [
            step_ops.StreamJob(
                policy="baseline",
                segs={"arrival_ms": _f(1, 4, 1),
                      "lba": torch.zeros((1, 4, 1), dtype=torch.int32),
                      "is_write": torch.ones((1, 4, 1), dtype=torch.int32)},
                state0=None, closed_loop=False,
                params=default_params(cfg, "baseline", 0.05,
                                      device="cpu"))])),
        "host_tier": (host_ops, lambda: host_ops.tier_pass([TierJob(
            spec=None, ops={"arrival_ms": _f(1, 4),
                            "lba": torch.zeros((1, 4), dtype=torch.int32)},
            params=None, hc0=None, closed_loop=False)])),
    }


@pytest.mark.parametrize("name", list(_raw_calls()))
def test_raw_wrapper_refuses_inputs_that_require_a_gradient(name,
                                                            monkeypatch):
    """With the device check taking the kernel's route (as on a card), a
    raw wrapper called on an input that requires a gradient while
    autograd records raises before it launches anything; under
    `torch.no_grad()` the guard lets the call through (here it then
    fails for want of a card or nvcc, not on the guard)."""
    module, call = _raw_calls()[name]
    monkeypatch.setattr(module, "kernel_route", lambda *a: True)
    with pytest.raises(RuntimeError, match="require a gradient"):
        call()
    with torch.no_grad():
        with pytest.raises(Exception) as err:
            call()
    assert "require a gradient" not in str(err.value)


def test_refuse_grad_looks_into_nested_inputs():
    leaf = _f(2)
    with pytest.raises(RuntimeError, match="require a gradient"):
        _build.refuse_grad("k", [{"a": (1, leaf)}])
    _build.refuse_grad("k", [{"a": (1, leaf.detach())}])
    with torch.no_grad():
        _build.refuse_grad("k", leaf)


def test_kernel_calls_inside_the_functions_pass_the_guard(monkeypatch):
    """Inside `FlashAttnFn` and `SsdIntraFn` autograd does not record, so
    the wrapper's guard passes there: the kernel's route runs (its
    plain version standing in for it) with the gradient flowing through
    the Function."""
    def guarded_flash(q, k, v, **kw):
        _build.refuse_grad("flash_fwd", q, k, v)
        return flash_ref.flash_ref(q, k, v, **kw)

    def guarded_intra(*args):
        _build.refuse_grad("ssd_intra", *args)
        return ssd_ops.ref.intra_chunk_ref(*args)

    monkeypatch.setattr(flash_ops, "flash_fwd", guarded_flash)
    monkeypatch.setattr(ssd_ops, "ssd_intra", guarded_intra)
    case = FLASH_CASES[0]
    q, k, v, w = _flash_inputs(case)
    got = _t_flash_grads(case, q, k, v, w)
    assert all(float(g.abs().max()) > 0 for g in got)
    inputs, (wy, wh) = _ssd_inputs(1, 32, 2, 8, 16, seed=3)
    ts = [to_torch(x).requires_grad_(True) for x in inputs]
    y, _ = ssd_ops.ssd_chunked_kernel(*ts[:5], 16, h0=ts[5])
    grads = torch.autograd.grad((y * to_torch(wy)).sum(), ts[:5])
    assert all(float(g.abs().max()) > 0 for g in grads)


# ---------------------------------------------------------------------------
# the chunked cross-entropy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk", (8, 31, 512))
def test_chunked_softmax_xent_matches_the_reference(chunk):
    """Loss and the gradients of the hidden states and the unembedding,
    chunks of `chunk` positions over 31 (8: three chunks and a remainder
    of 7), a mask with zeros."""
    rng = np.random.default_rng(chunk)
    h = rng.standard_normal((2, 31, 16)).astype(np.float32)
    u = (0.3 * rng.standard_normal((16, 50))).astype(np.float32)
    y = rng.integers(0, 50, (2, 31)).astype(np.int32)
    m = (rng.random((2, 31)) < 0.8).astype(np.float32)
    (jl, jg) = jax.value_and_grad(
        lambda h, u: j_xent(h, u, jnp.asarray(y), jnp.asarray(m),
                            chunk=chunk), argnums=(0, 1))(jnp.asarray(h),
                                                          jnp.asarray(u))
    th, tu = to_torch(h).requires_grad_(True), to_torch(u).requires_grad_(True)
    tl = t_xent(th, tu, to_torch(y), to_torch(m), chunk=chunk)
    tg = torch.autograd.grad(tl, (th, tu))
    _close(tl.detach(), np.asarray(jl), F32_TOL, "loss")
    for name, g, r in zip(("hidden", "unembed"), tg, jg):
        _close(g, r, F32_TOL, name)


# ---------------------------------------------------------------------------
# optimizers, schedules, compression
# ---------------------------------------------------------------------------


def _tree(dtype_np, seed):
    rng = np.random.default_rng(seed)

    def a(*shape):
        return (0.5 * rng.standard_normal(shape)).astype(dtype_np)
    return {"w": a(6, 5), "stack": {"e": a(3, 4, 5), "b": a(7)},
            "s": a(1, 9)}


def _as_torch(tree):
    return jax.tree.map(to_torch, tree)


@pytest.mark.parametrize("dtype", ("float32", "bf16"))
@pytest.mark.parametrize("opt", ("adamw", "adafactor"))
def test_optimizer_updates_match_the_reference(opt, dtype):
    """Three steps on a random tree (1-, 2- and 3-d leaves, so Adafactor
    factors some), with float32 gradients: the updates at rtol 1e-6 in
    float32, within one bf16 ulp in bf16, and the float32 state at rtol
    1e-6."""
    np_dt = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    j_init, j_upd = (j_awi, j_awu) if opt == "adamw" else (j_afi, j_afu)
    t_init, t_upd = t_adamw.make_optimizer(opt)
    params = _tree(np_dt, 0)
    jp, tp = jax.tree.map(jnp.asarray, params), _as_torch(params)
    js, ts = j_init(jp), t_init(tp)
    for step in range(3):
        grads = _tree(np.float32, 10 + step)
        lr = np.float32(1e-2 * (step + 1))
        ju, js = j_upd(jax.tree.map(jnp.asarray, grads), js, jp,
                       jnp.float32(lr))
        tu, ts = t_upd(_as_torch(grads), ts, tp, torch.tensor(lr))
        for path, r in jax.tree_util.tree_flatten_with_path(ju)[0]:
            g = functools.reduce(lambda t, k: t[k.key], path, tu)
            r = np.asarray(r)
            assert to_numpy(g).dtype == r.dtype
            if dtype == "float32":
                np.testing.assert_allclose(to_numpy(g), r, rtol=1e-6,
                                           atol=1e-12)
            else:
                gi = to_numpy(g).view(np.int16).astype(np.int32)
                ri = r.view(np.int16).astype(np.int32)
                assert np.abs(gi - ri).max() <= 1, (step, path)
        jp = jax.tree.map(lambda p, u: p + u, jp, ju)
        tp = jax.tree.map(lambda p, u: p + u, tp, tu)
        for r, g in zip(jax.tree.leaves(js), tree_leaves(list(ts))):
            np.testing.assert_allclose(to_numpy(g), np.asarray(r),
                                       rtol=1e-6, atol=1e-30)


def test_adafactor_state_is_factored():
    params = {"w": torch.zeros(64, 32), "b": torch.zeros(32)}
    state = t_adamw.adafactor_init(params)
    assert state.vr["w"].shape == (64,) and state.vc["w"].shape == (32,)
    assert state.vc["b"].shape == ()
    n_opt = sum(x.numel() for x in tree_leaves([state.vr, state.vc]))
    assert n_opt < sum(x.numel() for x in tree_leaves(params)) / 10


@pytest.mark.parametrize("opt", ("adamw", "adafactor"))
def test_optimizers_converge(opt):
    """The reference's convergence check: 300 steps on a quadratic."""
    init, upd = t_adamw.make_optimizer(opt)
    target = torch.tensor([1.0, -2.0, 3.0])
    params = {"w": torch.zeros(3)}
    state = init(params)
    for _ in range(300):
        grads = {"w": 2 * (params["w"] - target)}
        updates, state = upd(grads, state, params, 0.05)
        params = {"w": params["w"] + updates["w"]}
    assert float((params["w"] - target).abs().max()) < 0.3


def test_schedules_match_the_reference():
    for step in list(range(0, 130, 3)) + [10, 100, 1000]:
        for fn, kw in ((("cosine_with_warmup"),
                        dict(peak_lr=1e-3, warmup_steps=10,
                             total_steps=100)),
                       (("linear_warmup_constant"),
                        dict(peak_lr=3e-4, warmup_steps=7))):
            want = np.float32(getattr(j_sched, fn)(jnp.int32(step), **kw))
            got = getattr(t_sched, fn)(torch.tensor(step, dtype=torch.int32),
                                       **kw)
            assert got.dtype == torch.float32
            np.testing.assert_allclose(float(got), want, rtol=1e-6,
                                       atol=1e-12)
    assert float(t_sched.cosine_with_warmup(
        100, peak_lr=1e-3, warmup_steps=10, total_steps=100)) == \
        pytest.approx(1e-4, rel=0.01)


def test_gradient_compression_matches_the_reference():
    rng = np.random.default_rng(4)
    g = rng.standard_normal(256).astype(np.float32)
    r = (0.01 * rng.standard_normal(256)).astype(np.float32)
    jq, js, je = j_compress.compress_with_feedback(jnp.asarray(g),
                                                   jnp.asarray(r))
    tq, tsc, te = t_compress.compress_with_feedback(to_torch(g), to_torch(r))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert tq.dtype == torch.int8
    np.testing.assert_allclose(float(tsc), float(js), rtol=1e-7)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-6,
                               atol=1e-7)
    res = t_compress.init_residuals({"a": torch.zeros(3, 2)})
    assert res["a"].dtype == torch.float32 and res["a"].shape == (3, 2)
    # error feedback is unbiased over time (the reference's check)
    grad = torch.randn(256, generator=torch.Generator().manual_seed(0))
    residual, acc = torch.zeros(256), torch.zeros(256)
    for _ in range(50):
        q, scale, residual = t_compress.compress_with_feedback(grad, residual)
        acc = acc + t_compress.dequantize_int8(q, scale)
    assert float((acc / 50 - grad).abs().max()) < 0.02


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


def _states(name, optimizer, dtype=jnp.float32):
    """The reference's and the port's TrainState from the same weights."""
    from repro.optim import make_optimizer as j_make_opt
    jcfg = J_ARCHS[name].reduced()
    jm = j_build(jcfg, attn_chunk=CHUNK)
    jp = jax.tree.map(lambda x: x.astype(dtype) if x.dtype == jnp.bfloat16
                      else x, jax.jit(jm.init)(jax.random.PRNGKey(0)))
    js = JTrainState(params=jp, opt_state=j_make_opt(optimizer)[0](jp),
                     step=jnp.zeros((), jnp.int32))
    tm = t_build(T_ARCHS[name].reduced(), attn_chunk=CHUNK, device="cpu")
    tp = model_params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    tp = jax.tree.map(lambda p: p.requires_grad_(True), tp)
    ts = TrainState(params=tp,
                    opt_state=t_adamw.make_optimizer(optimizer)[0](tp),
                    step=torch.zeros((), dtype=torch.int32))
    return jcfg, jm, js, tm, ts


@pytest.mark.parametrize("optimizer", ("adamw", "adafactor"))
def test_five_step_trajectory_matches_the_reference(optimizer):
    """Five steps of `make_train_step` on the reference's batches, both
    sides from the same float32 weights: the losses, grad norms and
    learning rates at rtol 1e-4, and the parameters after the steps."""
    jcfg, jm, js, tm, ts = _states("gemma-2b", optimizer)
    sched = functools.partial(j_sched.cosine_with_warmup, peak_lr=1e-3,
                              warmup_steps=2, total_steps=5)
    j_step = jax.jit(j_make_step(jm, optimizer=optimizer, schedule=sched))
    t_step = make_train_step(tm, optimizer=optimizer, schedule=functools.partial(
        t_sched.cosine_with_warmup, peak_lr=1e-3, warmup_steps=2,
        total_steps=5))
    data = JDataConfig(vocab_size=jcfg.vocab_size, seq_len=S, global_batch=4)
    for i in range(5):
        batch = j_make_batch(data, i)
        js, jmet = j_step(js, batch)
        ts, tmet = t_step(ts, {"tokens": to_torch(np.asarray(
            batch["tokens"]))})
        for key in ("loss", "total_loss", "grad_norm", "lr", "aux_loss"):
            np.testing.assert_allclose(float(tmet[key]), float(jmet[key]),
                                       rtol=1e-4, atol=1e-12,
                                       err_msg=f"step {i} {key}")
    assert int(ts.step) == int(js.step) == 5
    for r, g in zip(jax.tree.leaves(js.params), tree_leaves(ts.params)):
        np.testing.assert_allclose(to_numpy(g), np.asarray(r), rtol=1e-3,
                                   atol=1e-4)


def test_grad_accum_matches_the_reference():
    """grad_accum 2 (float32 gradients summed as g / 2) against the
    reference's: one step's metrics at rtol 1e-4."""
    jcfg, jm, js, tm, ts = _states("gemma-2b", "adamw")
    batch = j_make_batch(JDataConfig(vocab_size=jcfg.vocab_size,
                                     seq_len=S, global_batch=4), 3)
    _, jmet = jax.jit(j_make_step(jm, grad_accum=2))(js, batch)
    _, tmet = make_train_step(tm, grad_accum=2)(
        ts, {"tokens": to_torch(np.asarray(batch["tokens"]))})
    for key in ("loss", "total_loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(tmet[key]), float(jmet[key]),
                                   rtol=1e-4, err_msg=key)


def test_grad_accum_matches_full_batch():
    """The reference's check, on the port: microbatch gradient
    accumulation equals one full-batch step on the same data."""
    cfg = T_ARCHS["gemma-2b"].reduced(num_layers=2, vocab_size=128)
    bundle = t_build(cfg, device="cpu")
    batch = {"tokens": torch.randint(0, 128, (4, 32), generator=torch.Generator(
        ).manual_seed(9), dtype=torch.int32)}
    s_full = make_train_state(bundle, torch.Generator().manual_seed(0))
    s_acc = make_train_state(bundle, torch.Generator().manual_seed(0))
    s_full, m1 = make_train_step(bundle, grad_accum=1)(s_full, batch)
    s_acc, m2 = make_train_step(bundle, grad_accum=2)(s_acc, batch)
    np.testing.assert_allclose(float(m1["total_loss"]),
                               float(m2["total_loss"]), rtol=2e-2)
    for a, b in zip(tree_leaves(s_full.params), tree_leaves(s_acc.params)):
        np.testing.assert_allclose(a.detach().float().numpy(),
                                   b.detach().float().numpy(), rtol=0.1,
                                   atol=5e-3)


def test_training_reduces_loss():
    """The reference's check, on the port: 30 steps on the learnable
    synthetic stream must cut the loss."""
    cfg = T_ARCHS["yi-6b"].reduced(num_layers=2, vocab_size=256)
    bundle = t_build(cfg, device="cpu")
    state = make_train_state(bundle, torch.Generator().manual_seed(0))
    step = make_train_step(bundle, schedule=functools.partial(
        t_sched.cosine_with_warmup, peak_lr=1e-3, warmup_steps=5,
        total_steps=60))
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=128, global_batch=8)
    losses = []
    for i, batch in batch_iterator(data):
        if i == 30:
            break
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.5, losses[::10]
    assert np.isfinite(losses).all()


def test_train_state_and_metrics():
    cfg = T_ARCHS["mamba2-370m"].reduced()
    bundle = t_build(cfg, device="cpu")
    state = make_train_state(bundle, torch.Generator().manual_seed(0))
    assert all(p.requires_grad and p.is_leaf
               for p in tree_leaves(state.params))
    assert state.step.dtype == torch.int32
    before = [p.detach().clone() for p in tree_leaves(state.params)]
    batch = make_batch(DataConfig(cfg.vocab_size, 32, 2), 0)
    new, metrics = make_train_step(bundle)(state, batch)
    assert set(metrics) == {"loss", "aux_loss", "grad_norm", "lr",
                            "total_loss"}
    assert int(new.step) == 1 and float(metrics["aux_loss"]) == 0.0
    # the step updates the parameters in place, so the state passed in
    # is the state returned
    assert new.params is state.params
    assert float(metrics["lr"]) == 0.0       # warmup's first step
    new, metrics = make_train_step(bundle)(new, batch)
    assert any(not torch.equal(a, p.detach())
               for a, p in zip(before, tree_leaves(new.params)))
    assert float(global_norm([torch.ones(4), torch.ones(5)])) == 3.0


# ---------------------------------------------------------------------------
# the data pipeline (the reference's TestData, on the port)
# ---------------------------------------------------------------------------


def test_data_deterministic_and_resumable():
    cfg = DataConfig(vocab_size=100, seq_len=32, global_batch=8)
    a, b = make_batch(cfg, 7), make_batch(cfg, 7)
    assert a["tokens"].dtype == torch.int32
    assert a["tokens"].shape == (8, 32)
    assert torch.equal(a["tokens"], b["tokens"])
    assert not torch.equal(a["tokens"], make_batch(cfg, 8)["tokens"])
    assert not torch.equal(a["tokens"], make_batch(
        dataclasses.replace(cfg, seed=1), 7)["tokens"])
    it = batch_iterator(cfg, 5)
    for step in (5, 6, 7):
        got_step, batch = next(it)
        assert got_step == step
        assert torch.equal(batch["tokens"], make_batch(cfg, step)["tokens"])


def test_data_host_sharding_partitions_batch():
    cfg = DataConfig(vocab_size=100, seq_len=16, global_batch=8)
    shards = [make_batch(cfg, 3, shard_index=i, num_shards=4)["tokens"]
              for i in range(4)]
    assert all(s.shape == (2, 16) for s in shards)
    assert not torch.equal(shards[0], shards[1])


def test_data_learnable_structure():
    """The repeat overlay copies from the final stream, so the period-R
    repetition rate is the coin's full 1/2 (plus chance), and the
    unigrams follow the Zipf law: the reference's checks and its
    documented rate."""
    cfg = DataConfig(vocab_size=100, seq_len=128, global_batch=4)
    toks = make_batch(cfg, 0)["tokens"].numpy()
    rep = (toks[:, cfg.ngram_repeat:] == toks[:, :-cfg.ngram_repeat])
    assert rep.mean() > 0.3
    big = DataConfig(vocab_size=1000, seq_len=2048, global_batch=8)
    toks = make_batch(big, 1)["tokens"].numpy()
    rate = (toks[:, 8:] == toks[:, :-8]).mean()
    assert 0.48 < rate < 0.56, rate
    # the raw draws of block 0: Zipf(1.1) over the ranks
    counts = np.bincount(toks[:, :8].reshape(-1), minlength=1000)
    assert counts[0] > counts[1] > counts[10] and counts[0] > 0.05 * 64


def test_data_batch_is_the_same_on_every_device():
    cfg = DataConfig(vocab_size=256000, seq_len=64, global_batch=2)
    a = make_batch(cfg, 2)["tokens"]
    b = make_batch(cfg, 2, device=torch.device("cpu"))["tokens"]
    assert torch.equal(a, b) and int(a.max()) < 256000 and int(a.min()) >= 0


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def test_launcher_trains_on_the_cpu(capsys):
    out = t_launch.main(["--arch", "gemma-2b", "--reduced", "--device", "cpu",
                         "--steps", "4", "--batch", "2", "--seq", "32",
                         "--log-every", "2"])
    text = capsys.readouterr().out
    assert text.startswith("arch=gemma-2b params=")
    assert "step     1 loss=" in text and "step     4 loss=" in text
    assert "final loss" in text
    assert len(out["losses"]) == 4 and np.isfinite(out["losses"]).all()


@pytest.mark.parametrize("arch", ("whisper-tiny", "deepseek-v2-lite-16b"))
def test_launcher_trains_other_families(arch, capsys):
    out = t_launch.main(["--arch", arch, "--reduced", "--device", "cpu",
                         "--steps", "2", "--batch", "2", "--seq", "32"])
    assert np.isfinite(out["losses"]).all()


def test_launcher_resumes_from_its_checkpoint(tmp_path, monkeypatch):
    """Four steps with a checkpoint every two, cut after the second step
    and resumed, give the losses of four uninterrupted steps, to the
    bit: the state comes back exactly and the data replays from the
    step counter."""
    from repro_torch.checkpoint import ckpt
    argv = ["--arch", "gemma-2b", "--reduced", "--device", "cpu", "--steps",
            "4", "--batch", "2", "--seq", "32", "--ckpt-every", "2",
            "--lr", "1e-2"]
    whole = t_launch.main(argv + ["--ckpt-dir", str(tmp_path / "whole")])

    real = t_launch.make_batch

    class Cut(Exception):
        pass

    def cut_at_2(cfg, step, **kw):
        if step == 2:
            raise Cut
        return real(cfg, step, **kw)

    run = str(tmp_path / "cut")
    monkeypatch.setattr(t_launch, "make_batch", cut_at_2)
    with pytest.raises(Cut):
        t_launch.main(argv + ["--ckpt-dir", run])
    ckpt._EXEC.submit(lambda: None).result()     # the write in flight
    monkeypatch.setattr(t_launch, "make_batch", real)
    assert ckpt.load_manifest(run)["step"] == 2
    resumed = t_launch.main(argv + ["--ckpt-dir", run])
    assert resumed["start_step"] == 2
    assert resumed["losses"] == whole["losses"][2:]
    assert ckpt.load_manifest(run)["step"] == 4
