"""Port vs reference: the VLM family (llava-next-34b reduced: 2 layers,
d_model 128, 16 patch embeddings), whose new code is the patch prefix:
`transformer.lm_hidden(prefix_embeds=)` concatenates the patches before
the tokens' embeddings, and the prefill fills the tiers over all P + S
positions. Served end to end under each policy, as
tests/test_torch_serve.py serves gemma-2b: logits within 2e-2, the
watermarks and the five traffic metrics exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.core.tiercache.manager import zero_metrics as j_zero
from repro.core.tiercache.policy import Policy as JPolicy
from repro.models import transformer as j_tx
from repro.models.model_zoo import build_model as j_build
from repro.models.model_zoo import make_train_batch as j_batch
from repro.serve.engine import make_serve_step as j_serve_step
from repro.serve.engine import make_tier_spec as j_tier_spec
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.core.tiercache.manager import METRICS, zero_metrics
from repro_torch.core.tiercache.policy import Policy as TPolicy
from repro_torch.interop import model_params_from_jax
from repro_torch.launch import serve as t_launch
from repro_torch.models import transformer as t_tx
from repro_torch.models.model_zoo import build_model as t_build
from repro_torch.models.model_zoo import make_train_batch as t_batch
from repro_torch.serve.engine import decode_loop as t_decode_loop
from repro_torch.serve.engine import make_serve_step as t_serve_step
from repro_torch.serve.engine import make_tier_spec as t_tier_spec
from torch_port_util import to_numpy, to_torch

NAME = "llava-next-34b"
J_CFG, T_CFG = J_ARCHS[NAME].reduced(), T_ARCHS[NAME].reduced()
PROMPT, STEPS, BATCH = 24, 16, 2
PATCHES = 16
TOL = 2e-2
SPEC = dict(hot_window=16, page_tokens=8, group=16)
S_MAX = 64


def _close(got, want, label, tol=TOL):
    np.testing.assert_allclose(to_numpy(got).astype(np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=label)


@pytest.fixture(scope="module")
def model():
    jb = j_build(J_CFG)
    jparams = jax.jit(jb.init)(jax.random.PRNGKey(0))
    tparams = model_params_from_jax(jax.tree.map(np.asarray, jparams),
                                    device="cpu")
    batch = {k: np.asarray(v) for k, v in
             j_batch(J_CFG, BATCH, PROMPT, jax.random.PRNGKey(5)).items()}
    return jb, jparams, tparams, batch


def test_configs_match():
    assert T_CFG.vlm.num_patches == PATCHES and T_CFG.family == "vlm"
    full = T_ARCHS[NAME]
    assert (full.num_layers, full.d_model, full.num_heads,
            full.num_kv_heads, full.head_dim, full.d_ff, full.vocab_size,
            full.vlm.num_patches) == (60, 7168, 56, 8, 128, 20480, 64000,
                                      576)
    # 68.78 GB of bf16 weights at full depth (PERF.md §4)
    assert full.param_count() == J_ARCHS[NAME].param_count() == 34388917248


def test_prefix_hidden_matches(model):
    _, jparams, tparams, batch = model
    want, _, (jk, jv) = jax.jit(lambda p, t, e: j_tx.lm_hidden(
        p, J_CFG, t, prefix_embeds=e, remat=False, collect_kv=True))(
        jparams, jnp.asarray(batch["tokens"]),
        jnp.asarray(batch["patch_embeds"]))
    got, _, (k, v) = t_tx.lm_hidden(
        tparams, T_CFG, to_torch(batch["tokens"]),
        prefix_embeds=to_torch(batch["patch_embeds"]), collect_kv=True)
    assert got.shape == (BATCH, PATCHES + PROMPT, 128)
    assert k.shape == (2, BATCH, PATCHES + PROMPT, 2, 32)
    for label, a, w in (("hidden", got, want), ("k", k, jk), ("v", v, jv)):
        a = to_numpy(a).astype(np.float32)
        w = np.asarray(w, np.float32)
        assert np.abs(a - w).max() <= TOL * np.abs(w).max(), label
    # without the prefix the same tokens give other states: the patches
    # are attended to
    plain, _, _ = t_tx.lm_hidden(tparams, T_CFG, to_torch(batch["tokens"]))
    assert not torch.allclose(plain, got[:, PATCHES:], atol=TOL)


def test_train_batch_draws_the_patches():
    gen = torch.Generator().manual_seed(0)
    batch = t_batch(T_CFG, BATCH, PROMPT, gen)
    assert sorted(batch) == ["patch_embeds", "tokens"]
    assert batch["patch_embeds"].shape == (BATCH, PATCHES, 128)
    assert batch["patch_embeds"].dtype == torch.bfloat16
    assert batch["tokens"].shape == (BATCH, PROMPT)


_RUNS = {}


def _reference_run(model, policy):
    if policy in _RUNS:
        return _RUNS[policy]
    jb, jparams, _, batch = model
    spec = j_tier_spec(jb, S_MAX, policy, **SPEC)
    cache, logits = jax.jit(lambda p, b: jb.prefill(p, b, spec))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    step = jax.jit(j_serve_step(jb, spec, policy))
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
def test_prefix_prefill_and_teacher_forced_decode(model, policy):
    _, _, tparams, batch = model
    ref = _reference_run(model, policy)
    tpol = TPolicy(int(policy))
    tb = t_build(T_CFG, device="cpu")
    spec = t_tier_spec(tb, S_MAX, tpol, **SPEC)
    cache, logits = tb.prefill(tparams, {k: to_torch(v) for k, v in
                                         batch.items()}, spec)
    # the prefill's tiers cover the patches and the prompt
    assert cache["total_len"] == PATCHES + PROMPT
    _close(logits, ref["prefill_logits"], "prefill")
    step = t_serve_step(tb, spec, tpol)
    metrics = zero_metrics()
    for i, (tok, want) in enumerate(zip(ref["inputs"], ref["logits"])):
        _, lg, cache, metrics = step(tparams, cache, to_torch(tok), metrics)
        _close(lg, want, f"step {i}")
    _assert_counters(ref, cache, metrics, "teacher-forced")


@pytest.mark.parametrize("policy", list(JPolicy), ids=lambda p: p.name)
def test_free_running_counters_equal_the_reference(model, policy):
    _, _, tparams, _ = model
    ref = _reference_run(model, policy)
    tpol = TPolicy(int(policy))
    tb = t_build(T_CFG, device="cpu")
    spec = t_tier_spec(tb, S_MAX, tpol, **SPEC)
    gen = torch.Generator().manual_seed(int(policy))
    cache, logits = tb.prefill(tparams, t_batch(T_CFG, BATCH, PROMPT, gen),
                               spec)
    first = torch.argmax(logits, -1).to(torch.int32)[:, None]
    toks, cache, metrics = t_decode_loop(tb, tparams, cache, first, STEPS,
                                         spec, tpol)
    assert toks.shape == (BATCH, STEPS)
    _assert_counters(ref, cache, metrics, "free-running")


def test_launcher_serves_llava_on_the_cpu(capsys):
    t_launch.main(["--arch", NAME, "--reduced", "--device", "cpu",
                   "--prompt-len", "24", "--decode", "12", "--policy",
                   "baseline"])
    out = capsys.readouterr().out
    assert "prefill 24 tokens x2" in out
    assert "policy=BASELINE:" in out and "sample tokens:" in out
