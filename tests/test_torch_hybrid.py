"""Port vs reference: zamba2 served as a whole — reduced to five layers
(two macro blocks of two Mamba2 layers and the shared attention block,
then a tail of one Mamba2 layer), the reference's weights carried
across, prefill and greedy decode over the shared block's tiered KV
cache under each of the four policies.

The plain `reduced()` config has four layers and so no tail; five keeps
the tail path in. The spec is tests/test_torch_serve.py's (hot window
16, page 8, group 16), with a prompt of two SSD chunks (64 tokens) and
64 decode steps. The port decodes teacher-forced on the reference's
tokens, so each step's logits are held to the reference's (2e-2: bf16
activations, the reference's own tolerance in test_integration.py), and
the watermarks and the five metrics exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.core.tiercache.manager import zero_metrics as j_zero
from repro.core.tiercache.policy import Policy as JPolicy
from repro.models import hybrid as jhy
from repro.models.model_zoo import build_model as j_build
from repro.models.model_zoo import make_train_batch as j_batch
from repro.serve.engine import make_serve_step as j_serve_step
from repro.serve.engine import make_tier_spec as j_tier_spec
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.core.tiercache.manager import METRICS, zero_metrics
from repro_torch.core.tiercache.policy import Policy as TPolicy
from repro_torch.interop import cache_from_jax, model_params_from_jax
from repro_torch.launch import serve as t_launch
from repro_torch.models import hybrid as thy
from repro_torch.models.model_zoo import build_model as t_build
from repro_torch.models.model_zoo import make_train_batch as t_batch
from repro_torch.serve.engine import decode_loop as t_decode_loop
from repro_torch.serve.engine import make_serve_step as t_serve_step
from repro_torch.serve.engine import make_tier_spec as t_tier_spec
from torch_port_util import to_numpy, to_torch

ARCH, LAYERS = "zamba2-1.2b", 5
PROMPT, STEPS, BATCH, S_MAX = 64, 64, 2, 128
TOL = 2e-2
SPEC = dict(hot_window=16, page_tokens=8, group=16)


def _close(ref, got, tol, label):
    got = to_numpy(got).astype(np.float32)
    assert np.isfinite(got).all(), f"{label}: non-finite values"
    np.testing.assert_allclose(got, np.asarray(ref, np.float32), rtol=tol,
                               atol=tol, err_msg=label)


def test_reduced_config_has_a_tail():
    jcfg = J_ARCHS[ARCH].reduced(num_layers=LAYERS)
    tcfg = T_ARCHS[ARCH].reduced(num_layers=LAYERS)
    assert jhy.hybrid_structure(jcfg) == thy.hybrid_structure(tcfg) == (2, 1)
    assert thy.hybrid_structure(T_ARCHS[ARCH]) == (6, 2)   # the full model


@pytest.fixture(scope="module")
def model():
    jcfg = J_ARCHS[ARCH].reduced(num_layers=LAYERS)
    jb = j_build(jcfg)
    jparams = jax.jit(jb.init)(jax.random.PRNGKey(0))
    tparams = model_params_from_jax(jax.tree.map(np.asarray, jparams),
                                    device="cpu")
    tokens = np.asarray(j_batch(jcfg, BATCH, PROMPT)["tokens"])
    return jcfg, jb, jparams, tparams, tokens


_RUNS = {}


def _reference_run(model, policy):
    """The reference's prefill and STEPS jitted serve steps: the prefill
    cache, per-step input tokens and logits, the final watermarks and
    metrics."""
    if policy in _RUNS:
        return _RUNS[policy]
    _, jb, jparams, _, tokens = model
    spec = j_tier_spec(jb, S_MAX, policy, **SPEC)
    cache, logits = jax.jit(lambda p, b: jb.prefill(p, b, spec))(
        jparams, {"tokens": jnp.asarray(tokens)})
    run = {"spec": spec, "prefill_logits": np.asarray(logits),
           "prefill_cache": jax.tree.map(np.asarray, cache)}
    step = jax.jit(j_serve_step(jb, spec, policy))
    metrics = j_zero()
    token = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
    inputs, step_logits = [], []
    for _ in range(STEPS):
        inputs.append(np.asarray(token))
        token, lg, cache, metrics = step(jparams, cache, token, metrics)
        step_logits.append(np.asarray(lg))
    run.update(inputs=inputs, logits=step_logits,
               dense_len=int(cache["dense_len"]),
               total_len=int(cache["total_len"]),
               final_cache=jax.tree.map(np.asarray, cache),
               metrics={k: np.float32(metrics[k]) for k in METRICS})
    _RUNS[policy] = run
    return run


def _assert_counters(ref, cache, metrics, label):
    assert cache["dense_len"] == ref["dense_len"], label
    assert cache["total_len"] == ref["total_len"], label
    for k in METRICS:
        assert (np.float32(metrics[k]).view(np.uint32)
                == ref["metrics"][k].view(np.uint32)), (
            f"{label}: {k} {metrics[k]!r} != {ref['metrics'][k]!r}")


def _t_setup(policy):
    tcfg = T_ARCHS[ARCH].reduced(num_layers=LAYERS)
    tb = t_build(tcfg, device="cpu")
    tpol = TPolicy(int(policy))
    return tcfg, tb, tpol, t_tier_spec(tb, S_MAX, tpol, **SPEC)


@pytest.mark.parametrize("policy", list(JPolicy), ids=lambda p: p.name)
def test_prefill_and_teacher_forced_decode(model, policy):
    _, _, _, tparams, tokens = model
    ref = _reference_run(model, policy)
    _, tb, tpol, spec = _t_setup(policy)
    assert tb.cache_kind == "hybrid" and spec.s_dense == ref["spec"].s_dense
    cache, logits = tb.prefill(tparams, {"tokens": to_torch(tokens)}, spec)
    _close(ref["prefill_logits"], logits, TOL, "prefill")
    want = cache_from_jax(ref["prefill_cache"], device="cpu")
    assert set(cache) == set(want)
    assert (cache["dense_len"], cache["total_len"]) == (
        want["dense_len"], want["total_len"])
    for k in ("macro_conv", "macro_ssm", "tail_conv", "tail_ssm"):
        assert cache[k].shape == want[k].shape, k
        _close(to_numpy(want[k]), cache[k], TOL, f"prefill {k}")
    step = t_serve_step(tb, spec, tpol)
    metrics = zero_metrics()
    for i, (tok, lg_want) in enumerate(zip(ref["inputs"], ref["logits"])):
        _, lg, cache, metrics = step(tparams, cache, to_torch(tok), metrics)
        _close(lg_want, lg, TOL, f"step {i}")
    _assert_counters(ref, cache, metrics, "teacher-forced")
    want = cache_from_jax(ref["final_cache"], device="cpu")
    _close(to_numpy(want["tail_ssm"]), cache["tail_ssm"], TOL, "final tail")


@pytest.mark.parametrize("policy", list(JPolicy), ids=lambda p: p.name)
def test_free_running_counters_equal_the_reference(model, policy):
    """The port's own greedy tokens: the counters do not depend on them."""
    _, _, _, tparams, _ = model
    ref = _reference_run(model, policy)
    tcfg, tb, tpol, spec = _t_setup(policy)
    gen = torch.Generator().manual_seed(int(policy))
    cache, logits = tb.prefill(tparams, t_batch(tcfg, BATCH, PROMPT, gen),
                               spec)
    first = torch.argmax(logits, -1).to(torch.int32)[:, None]
    toks, cache, metrics = t_decode_loop(tb, tparams, cache, first, STEPS,
                                         spec, tpol)
    assert toks.shape == (BATCH, STEPS) and toks.dtype == torch.int32
    _assert_counters(ref, cache, metrics, "free-running")


def test_decode_cache_matches_the_reference_layout():
    jcfg = J_ARCHS[ARCH].reduced(num_layers=LAYERS)
    tcfg = T_ARCHS[ARCH].reduced(num_layers=LAYERS)
    jb, tb = j_build(jcfg), t_build(tcfg, device="cpu")
    jspec = j_tier_spec(jb, S_MAX, JPolicy.IPS, **SPEC)
    tspec = t_tier_spec(tb, S_MAX, TPolicy.IPS, **SPEC)
    want = cache_from_jax(jax.tree.map(np.asarray,
                                       jb.make_decode_cache(3, 40, jspec)),
                          device="cpu")
    got = tb.make_decode_cache(3, 40, tspec)
    assert set(got) == set(want)
    for k in ("macro_conv", "macro_ssm", "tail_conv", "tail_ssm"):
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype
    for k, v in want["attn"].items():
        assert got["attn"][k].shape == v.shape and got["attn"][k].dtype == v.dtype
    assert (got["dense_len"], got["total_len"]) == (want["dense_len"], 40)


def test_launcher_runs_zamba2_on_the_cpu(capsys):
    t_launch.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                   "--prompt-len", "32", "--decode", "40", "--policy",
                   "ips"])
    out = capsys.readouterr().out
    assert "prefill 32 tokens x2" in out
    # hot window 32, page 8: IPS moves 2 pages (16 tokens) at each of 3
    # stalls in 40 steps from a 32-token prompt
    assert "policy=IPS:" in out and "repacked=48 tok stalls=3" in out
    assert "sample tokens:" in out
