"""Port vs reference: the serving path as a whole — gemma-2b reduced to
two layers, the reference's weights carried across, prefill and greedy
decode over the tiered KV cache under each of the four policies.

The spec is test_integration.py's (hot window 16, page 8, group 16;
prompt 24, 64 decode steps). The port decodes teacher-forced on the
reference's tokens, so each step's logits are held to the reference's
(2e-2: bf16 activations, the reference's own tolerance in
test_integration.py), and the watermarks and the five metrics exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.core.tiercache.policy import Policy as JPolicy
from repro.models.model_zoo import build_model as j_build
from repro.models.model_zoo import make_train_batch as j_batch
from repro.serve.engine import make_serve_step as j_serve_step
from repro.serve.engine import make_tier_spec as j_tier_spec
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.core.tiercache.manager import METRICS, zero_metrics
from repro_torch.core.tiercache.policy import Policy as TPolicy
from repro_torch.interop import model_params_from_jax
from repro_torch.launch import serve as t_launch
from repro_torch.models.model_zoo import build_model as t_build
from repro_torch.models.model_zoo import make_train_batch as t_batch
from repro_torch.serve.engine import decode_loop as t_decode_loop
from repro_torch.serve.engine import make_serve_step as t_serve_step
from repro_torch.serve.engine import make_tier_spec as t_tier_spec
from torch_port_util import to_torch

PROMPT, STEPS, BATCH = 24, 64, 2
TOL = 2e-2


@pytest.fixture(scope="module")
def model():
    jcfg = J_ARCHS["gemma-2b"].reduced(num_layers=2)
    jb = j_build(jcfg)
    jparams = jax.jit(jb.init)(jax.random.PRNGKey(0))
    tparams = model_params_from_jax(jax.tree.map(np.asarray, jparams),
                                    device="cpu")
    tokens = np.asarray(j_batch(jcfg, BATCH, PROMPT)["tokens"])
    return jcfg, jb, jparams, tparams, tokens


_RUNS = {}


def _reference_run(model, policy):
    """The reference's prefill and STEPS jitted serve steps: per-step
    input tokens and logits, and the final watermarks and metrics."""
    if policy in _RUNS:
        return _RUNS[policy]
    jcfg, jb, jparams, _, tokens = model
    spec = j_tier_spec(jb, 128, policy, hot_window=16, page_tokens=8,
                       group=16)
    cache, logits = jax.jit(lambda p, b: jb.prefill(p, b, spec))(
        jparams, {"tokens": jnp.asarray(tokens)})
    step = jax.jit(j_serve_step(jb, spec, policy))
    from repro.core.tiercache.manager import zero_metrics as j_zero
    metrics = j_zero()
    token = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
    inputs, step_logits = [], []
    for _ in range(STEPS):
        inputs.append(np.asarray(token))
        token, lg, cache, metrics = step(jparams, cache, token, metrics)
        step_logits.append(np.asarray(lg))
    run = {"spec": spec, "prefill_logits": np.asarray(logits),
           "inputs": inputs, "logits": step_logits,
           "dense_len": int(cache["dense_len"]),
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
def test_prefill_and_teacher_forced_decode(model, policy):
    _, _, _, tparams, tokens = model
    ref = _reference_run(model, policy)
    tcfg = T_ARCHS["gemma-2b"].reduced(num_layers=2)
    tpol = TPolicy(int(policy))
    tb = t_build(tcfg, device="cpu")
    spec = t_tier_spec(tb, 128, tpol, hot_window=16, page_tokens=8,
                       group=16)
    assert spec.s_dense == ref["spec"].s_dense
    cache, logits = tb.prefill(tparams, {"tokens": to_torch(tokens)}, spec)
    np.testing.assert_allclose(logits.numpy(), ref["prefill_logits"],
                               rtol=TOL, atol=TOL, err_msg="prefill")
    step = t_serve_step(tb, spec, tpol)
    metrics = zero_metrics()
    for i, (tok, want) in enumerate(zip(ref["inputs"], ref["logits"])):
        _, lg, cache, metrics = step(tparams, cache, to_torch(tok), metrics)
        np.testing.assert_allclose(lg.numpy(), want, rtol=TOL, atol=TOL,
                                   err_msg=f"step {i}")
    _assert_counters(ref, cache, metrics, "teacher-forced")


@pytest.mark.parametrize("policy", list(JPolicy), ids=lambda p: p.name)
def test_free_running_counters_equal_the_reference(model, policy):
    """The port's own greedy tokens: the counters do not depend on them."""
    _, _, _, tparams, _ = model
    ref = _reference_run(model, policy)
    tcfg = T_ARCHS["gemma-2b"].reduced(num_layers=2)
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
    assert toks.shape == (BATCH, STEPS) and toks.dtype == torch.int32
    _assert_counters(ref, cache, metrics, "free-running")


def test_other_families_are_refused():
    """Every family the reference serves builds — the encoder-decoder and
    the VLM too (tests/test_torch_encdec.py, tests/test_torch_vlm.py) —
    and a family the reference does not know is refused."""
    import dataclasses
    for name, kind in (("whisper-tiny", "encdec_self"),
                       ("llava-next-34b", "gqa")):
        cfg = T_ARCHS[name].reduced()
        assert t_build(cfg, device="cpu").cache_kind == kind
        with pytest.raises(ValueError, match="unknown family"):
            t_build(dataclasses.replace(cfg, family="speech"), device="cpu")


def test_launcher_runs_on_the_cpu(capsys):
    t_launch.main(["--arch", "gemma-2b", "--reduced", "--device", "cpu",
                   "--prompt-len", "24", "--decode", "20", "--policy",
                   "ips"])
    out = capsys.readouterr().out
    assert "prefill 24 tokens x2" in out
    assert "policy=IPS:" in out and "stalls=" in out
    assert "sample tokens:" in out
