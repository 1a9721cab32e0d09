"""Port vs reference: the MoE FFN (`repro_torch/models/moe.py`) and
arctic-480b reduced served end to end.

The reference's weights cross by `interop`; inputs are made with numpy
from a seed. Both dispatches are held to the reference's: float32
parameters at rtol 1e-5 (the products' summation order differs),
bf16 at 2e-2 (bf16 activations, the serving tests' tolerance); the
routed experts, the capacity and the kept/dropped pattern exactly; the
aux loss at rtol 1e-6. A router biased towards one expert makes the
capacity drop pairs. arctic-480b reduced (a parallel dense residual,
GQA) is served as tests/test_torch_serve.py serves gemma-2b: teacher-
forced on the reference's tokens under each policy, logits within
2e-2, the watermarks and the five metrics exact. Its routes are teacher-
forced too: the compiled reference rounds bf16 activations at other
places than its op-by-op form (and the port), and a near-tie between
the 2nd and 3rd of 4 experts then flips (0 to 2 of the 288 top-2 sets
of a policy's run). The port replays the reference's (weights, experts) and
counts the sets its own routing would have chosen otherwise: at most
ROUTE_FLIPS of them.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.core.tiercache.manager import zero_metrics as j_zero
from repro.core.tiercache.policy import Policy as JPolicy
from repro.models import moe as j_moe
from repro.models.model_zoo import build_model as j_build
from repro.models.model_zoo import make_train_batch as j_batch
from repro.serve.engine import make_serve_step as j_serve_step
from repro.serve.engine import make_tier_spec as j_tier_spec
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.core.tiercache.manager import METRICS, zero_metrics
from repro_torch.core.tiercache.policy import Policy as TPolicy
from repro_torch.interop import model_params_from_jax
from repro_torch.models import moe as t_moe
from repro_torch.models.model_zoo import build_model as t_build
from repro_torch.models.model_zoo import make_train_batch as t_batch
from repro_torch.serve.engine import decode_loop as t_decode_loop
from repro_torch.serve.engine import make_serve_step as t_serve_step
from repro_torch.serve.engine import make_tier_spec as t_tier_spec
from torch_port_util import recorded_routes, replayed_routes, to_torch

ARCH_NAMES = ("deepseek-v2-lite-16b", "arctic-480b")
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
B, S = 2, 32


def _cfgs(name):
    return J_ARCHS[name].reduced(), T_ARCHS[name].reduced()


def _params(jcfg, dtype, seed=3, bias=0.0):
    """The reference's MoE layer (router float32) and its port; `bias`
    is added to expert 0's router column (a favoured expert: drops)."""
    jp = j_moe.init_moe_layer(jax.random.PRNGKey(seed), jcfg, dtype=dtype)
    if bias:
        jp = dict(jp, router=jp["router"].at[:, 0].add(bias))
    tp = model_params_from_jax(
        {"layers": {"moe": jax.tree.map(np.asarray, jp)}},
        device="cpu")["layers"]["moe"]
    return jp, tp


def _x(d, dtype_np, seed=1, shape=(B, S), shift=0.0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape + (d,)).astype(np.float32) + shift
    return x.astype(dtype_np)


def _np(dtype):
    return ml_dtypes.bfloat16 if dtype == jnp.bfloat16 else np.float32


def _close(got, want, tol, label):
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=label)


def _j_keep(experts, m, c):
    """The reference's kept pairs, by its einsum dispatch's own lines
    (moe.py:96-99), from its routed experts."""
    b = experts.shape[0]
    sel = jax.nn.one_hot(experts, m.num_experts, dtype=jnp.float32)
    flat_sel = sel.reshape(b, -1, m.num_experts)
    pos = jnp.cumsum(flat_sel, axis=1) - flat_sel
    return np.asarray(jnp.sum((pos < c) * flat_sel, axis=-1) > 0)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_routing_matches(name, dtype):
    jcfg, tcfg = _cfgs(name)
    jdt, _, _ = DTYPES[dtype]
    jp, tp = _params(jcfg, jdt)
    x = _x(jcfg.d_model, _np(jdt))
    jw, je, jaux = jax.jit(lambda r, x: j_moe._routing(r, x, jcfg.moe))(
        jp["router"], jnp.asarray(x))
    tw, te, taux = t_moe._routing(tp["router"], to_torch(x), tcfg.moe)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    assert tw.dtype == torch.float32 and taux.dtype == torch.float32
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_capacity_is_the_reference_s(name):
    import dataclasses
    jcfg, tcfg = _cfgs(name)
    for cf in (1.0, 1.25, 2.0):
        jm = dataclasses.replace(J_ARCHS[name].moe, capacity_factor=cf)
        tm = dataclasses.replace(T_ARCHS[name].moe, capacity_factor=cf)
        for s in (1, 2, 3, 4, 7, 32, 100, 2048, 4096):
            assert t_moe._capacity(s, tm) == j_moe._capacity(s, jm), (cf, s)
    assert t_moe._capacity(S, tcfg.moe) == j_moe._capacity(S, jcfg.moe)


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_drops_are_the_reference_s(name):
    """A router biased towards expert 0: pairs past its capacity are
    dropped, the same pairs in both packages, and the outputs of both
    dispatches equal the reference's."""
    jcfg, tcfg = _cfgs(name)
    jp, tp = _params(jcfg, jnp.float32, bias=0.05)
    x = _x(jcfg.d_model, np.float32, seed=2, shift=1.0)
    c = t_moe._capacity(S, tcfg.moe)
    _, je, _ = j_moe._routing(jp["router"], jnp.asarray(x), jcfg.moe)
    _, te, _ = t_moe._routing(tp["router"], to_torch(x), tcfg.moe)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    _, keep = t_moe._slots(te, c, tcfg.moe.num_experts)
    want = _j_keep(je, jcfg.moe, c)
    np.testing.assert_array_equal(keep.numpy(), want)
    assert 0 < int((~keep).sum()) < keep.numel(), "no drop or all dropped"
    for dispatch in ("einsum", "gather"):
        jy, jaux = j_moe.apply_moe(jp, jcfg, jnp.asarray(x), dispatch)
        ty, taux = t_moe.apply_moe(tp, tcfg, to_torch(x), dispatch)
        _close(ty, jy, 1e-5, dispatch)
        np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)


@pytest.mark.parametrize("dispatch", ["einsum", "gather"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_apply_moe_matches(name, dtype, dispatch):
    jcfg, tcfg = _cfgs(name)
    jdt, tdt, tol = DTYPES[dtype]
    jp, tp = _params(jcfg, jdt)
    x = _x(jcfg.d_model, _np(jdt))
    jy, jaux = jax.jit(lambda p, x: j_moe.apply_moe(p, jcfg, x, dispatch))(
        jp, jnp.asarray(x))
    ty, taux = t_moe.apply_moe(tp, tcfg, to_torch(x), dispatch)
    assert ty.dtype == tdt and ty.shape == (B, S, jcfg.d_model)
    _close(ty, jy, tol, f"{name} {dtype} {dispatch}")
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)


@pytest.mark.parametrize("dispatch", ["einsum", "gather"])
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_decode_flattens_the_batch_into_one_group(name, dispatch):
    """S == 1, B > 1: one dispatch group of B tokens (capacity of B),
    as the reference; the same as a (1, B) call."""
    jcfg, tcfg = _cfgs(name)
    jp, tp = _params(jcfg, jnp.float32)
    x = _x(jcfg.d_model, np.float32, seed=4, shape=(5, 1))
    jy, jaux = j_moe.apply_moe(jp, jcfg, jnp.asarray(x), dispatch)
    ty, taux = t_moe.apply_moe(tp, tcfg, to_torch(x), dispatch)
    assert ty.shape == (5, 1, jcfg.d_model)
    _close(ty, jy, 1e-5, dispatch)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    flat, flat_aux = t_moe.apply_moe(tp, tcfg, to_torch(x).reshape(1, 5, -1),
                                     dispatch)
    assert torch.equal(flat[0], ty[:, 0]) and float(flat_aux) == float(taux)


def test_dispatches_agree_with_each_other():
    """The port's two dispatches, as tests/test_models.py holds the
    reference's: one capacity, one drop rule."""
    jcfg, tcfg = _cfgs("deepseek-v2-lite-16b")
    _, tp = _params(jcfg, jnp.float32, bias=0.05)
    x = to_torch(_x(jcfg.d_model, np.float32, seed=5, shift=1.0))
    ye, ae = t_moe.apply_moe(tp, tcfg, x, "einsum")
    yg, ag = t_moe.apply_moe(tp, tcfg, x, "gather")
    torch.testing.assert_close(ye, yg, rtol=1e-6, atol=1e-6)
    assert float(ae) == float(ag)
    with pytest.raises(ValueError, match="dispatch"):
        t_moe.apply_moe(tp, tcfg, x, "sorted")


def test_init_draws_the_reference_tree():
    """The port's MoE init for arctic (the dense residual beside the
    experts, no shared ones): the reference's leaves, shapes and dtypes,
    stacked over layers (deepseek's whole tree: tests/test_torch_mla.py)."""
    jcfg, tcfg = _cfgs("arctic-480b")
    jp = jax.eval_shape(lambda k: j_moe.init_moe_layer(k, jcfg),
                        jax.random.PRNGKey(0))
    gen = torch.Generator().manual_seed(0)
    tp = t_moe.init_moe_layer(gen, tcfg, n_stack=3)

    def flat(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out.update(flat(v, f"{prefix}{k}/"))
            else:
                out[prefix + k] = v
        return out

    jf, tf = flat(jp), flat(tp)
    assert sorted(jf) == sorted(tf)
    for k, leaf in jf.items():
        assert tuple(tf[k].shape) == (3,) + tuple(leaf.shape), k
        assert str(tf[k].dtype).split(".")[-1] == str(leaf.dtype), k


# ---------------------------------------------------------------------------
# arctic-480b reduced served end to end
# ---------------------------------------------------------------------------

PROMPT, STEPS, BATCH = 24, 48, 2
TOL = 2e-2
# the share of (layer, token) top-k sets whose own choice may differ from
# the compiled reference's (near-ties under bf16 noise)
ROUTE_FLIPS = 0.02
_RUNS = {}


@pytest.fixture(scope="module")
def arctic():
    jcfg = J_ARCHS["arctic-480b"].reduced()
    jb = j_build(jcfg)
    jparams = jax.jit(jb.init)(jax.random.PRNGKey(0))
    tparams = model_params_from_jax(jax.tree.map(np.asarray, jparams),
                                    device="cpu")
    tokens = np.asarray(j_batch(jcfg, BATCH, PROMPT)["tokens"])
    return jcfg, jb, jparams, tparams, tokens


def _reference_run(model, policy):
    if policy in _RUNS:
        return _RUNS[policy]
    jcfg, jb, jparams, _, tokens = model
    spec = j_tier_spec(jb, 128, policy, hot_window=16, page_tokens=8,
                       group=16)
    routes = []
    with recorded_routes(j_moe, routes):
        cache, logits = jax.jit(lambda p, b: jb.prefill(p, b, spec))(
            jparams, {"tokens": jnp.asarray(tokens)})
        step = jax.jit(j_serve_step(jb, spec, policy))
        metrics = j_zero()
        token = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
        inputs, step_logits = [], []
        for _ in range(STEPS):
            inputs.append(np.asarray(token))
            token, lg, cache, metrics = step(jparams, cache, token, metrics)
            step_logits.append(np.asarray(lg))
        jax.effects_barrier()
    run = {"prefill_logits": np.asarray(logits), "inputs": inputs,
           "routes": routes,
           "logits": step_logits, "dense_len": int(cache["dense_len"]),
           "total_len": int(cache["total_len"]),
           "metrics": {k: np.float32(metrics[k]) for k in METRICS}}
    _RUNS[policy] = run
    return run


def _assert_counters(ref, cache, metrics, label):
    assert cache["dense_len"] == ref["dense_len"], label
    assert cache["total_len"] == ref["total_len"], label
    for k in METRICS:
        assert (np.float32(metrics[k]).view(np.uint32)
                == ref["metrics"][k].view(np.uint32)), (
            f"{label}: {k} {metrics[k]!r} != {ref['metrics'][k]!r}")


@pytest.mark.parametrize("policy", list(JPolicy), ids=lambda p: p.name)
def test_arctic_served_teacher_forced(arctic, policy):
    _, _, _, tparams, tokens = arctic
    ref = _reference_run(arctic, policy)
    tcfg = T_ARCHS["arctic-480b"].reduced()
    tpol = TPolicy(int(policy))
    tb = t_build(tcfg, device="cpu")
    assert tb.cache_kind == "gqa"
    spec = t_tier_spec(tb, 128, tpol, hot_window=16, page_tokens=8,
                       group=16)
    flips = []
    with replayed_routes(t_moe, ref["routes"], flips):
        cache, logits = tb.prefill(tparams, {"tokens": to_torch(tokens)},
                                   spec)
        np.testing.assert_allclose(logits.numpy(), ref["prefill_logits"],
                                   rtol=TOL, atol=TOL, err_msg="prefill")
        step = t_serve_step(tb, spec, tpol)
        metrics = zero_metrics()
        for i, (tok, want) in enumerate(zip(ref["inputs"], ref["logits"])):
            _, lg, cache, metrics = step(tparams, cache, to_torch(tok),
                                         metrics)
            np.testing.assert_allclose(lg.numpy(), want, rtol=TOL, atol=TOL,
                                       err_msg=f"step {i}")
    _assert_counters(ref, cache, metrics, "teacher-forced")
    calls, sets, flipped = flips
    assert calls == tcfg.num_layers * (STEPS + 1)
    assert flipped <= ROUTE_FLIPS * sets, (
        f"{flipped} of {sets} top-k sets differ from the reference's")
    print(f"route flips {flipped} of {sets}")


@pytest.mark.parametrize("policy", list(JPolicy), ids=lambda p: p.name)
def test_arctic_free_running_counters(arctic, policy):
    """The port's own greedy tokens through `decode_loop`: the counters
    do not depend on them."""
    _, _, _, tparams, _ = arctic
    ref = _reference_run(arctic, policy)
    tcfg = T_ARCHS["arctic-480b"].reduced()
    tpol = TPolicy(int(policy))
    tb = t_build(tcfg, device="cpu")
    spec = t_tier_spec(tb, 128, tpol, hot_window=16, page_tokens=8,
                       group=16)
    gen = torch.Generator().manual_seed(int(policy))
    cache, logits = tb.prefill(tparams, t_batch(tcfg, BATCH, PROMPT, gen),
                               spec)
    first = torch.argmax(logits, -1).to(torch.int32)[:, None]
    toks, cache, metrics = t_decode_loop(tb, tparams, cache, first, STEPS,
                                         spec, tpol)
    assert toks.shape == (BATCH, STEPS)
    _assert_counters(ref, cache, metrics, "free-running")
