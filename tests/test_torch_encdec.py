"""Port vs reference: the encoder-decoder (whisper-tiny reduced: 2 + 2
layers, d_model 128, 64 frames), its `encdec_self` cache kind and the
static int4 cross tier, served end to end.

The reference's weights cross by `interop`; frames and tokens are the
reference's batch (numpy); the reference runs compiled (`jax.jit`), as
its serving path does. Tolerances: bf16 activations at 2e-2 (the serving
tests' tolerance); the cross tier's buffers bit for bit against the
reference's own quantizer on the same projections; the watermarks and
the five traffic metrics exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.core.tiercache import layout as jlayout
from repro.core.tiercache.manager import zero_metrics as j_zero
from repro.core.tiercache.policy import Policy as JPolicy
from repro.core.tiercache.quant import dequantize_int4 as j_dequant
from repro.core.tiercache.quant import quantize_int4 as j_quantize
from repro.models import attention as j_attn
from repro.models import encdec as j_encdec
from repro.models.model_zoo import build_model as j_build
from repro.models.model_zoo import make_train_batch as j_batch
from repro.serve.engine import make_serve_step as j_serve_step
from repro.serve.engine import make_tier_spec as j_tier_spec
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.core.tiercache import layout as tlayout
from repro_torch.core.tiercache import manager as tmanager
from repro_torch.core.tiercache.manager import METRICS, zero_metrics
from repro_torch.core.tiercache.policy import Policy as TPolicy
from repro_torch.interop import cache_from_jax, model_params_from_jax
from repro_torch.kernels.tiered_attention import ops as tiered
from repro_torch.launch import serve as t_launch
from repro_torch.models import encdec as t_encdec
from repro_torch.models.model_zoo import build_model as t_build
from repro_torch.models.model_zoo import make_train_batch as t_batch
from repro_torch.serve.engine import decode_loop as t_decode_loop
from repro_torch.serve.engine import make_serve_step as t_serve_step
from repro_torch.serve.engine import make_tier_spec as t_tier_spec
from torch_port_util import assert_leaf_equal, to_numpy, to_torch

NAME = "whisper-tiny"
J_CFG, T_CFG = J_ARCHS[NAME].reduced(), T_ARCHS[NAME].reduced()
PROMPT, STEPS, BATCH = 24, 8, 2
TOL = 2e-2
SPEC = dict(hot_window=16, page_tokens=8, group=16)


def _close(got, want, label, tol=TOL):
    np.testing.assert_allclose(to_numpy(got).astype(np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=label)


def _close_scaled(got, want, label, tol=TOL):
    """Hidden states and projections of order one: within `tol` of their
    largest magnitude (bf16 holds 8 bits, so a value near 1.5 moves by
    0.008 a rounding)."""
    got = to_numpy(got).astype(np.float32)
    want = np.asarray(want, np.float32)
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), (label, err)


@pytest.fixture(scope="module")
def model():
    jb = j_build(J_CFG)
    jparams = jax.jit(jb.init)(jax.random.PRNGKey(0))
    tparams = model_params_from_jax(jax.tree.map(np.asarray, jparams),
                                    device="cpu")
    batch = {k: np.asarray(v) for k, v in
             j_batch(J_CFG, BATCH, PROMPT, jax.random.PRNGKey(3)).items()}
    return jb, jparams, tparams, batch


def test_configs_match():
    assert T_CFG == T_ARCHS[NAME].reduced()
    assert (T_CFG.num_layers, T_CFG.encdec.num_encoder_layers,
            T_CFG.encdec.encoder_seq_len) == (2, 2, 64)
    full = T_ARCHS[NAME]
    assert (full.num_layers, full.encdec.num_encoder_layers, full.d_model,
            full.num_heads, full.num_kv_heads, full.head_dim, full.d_ff,
            full.encdec.encoder_seq_len, full.vocab_size) == (
        4, 4, 384, 6, 6, 64, 1536, 1500, 51865)


def test_init_draws_the_reference_tree():
    jp = jax.eval_shape(lambda k: j_encdec.init_encdec(k, J_CFG),
                        jax.random.PRNGKey(0))
    tp = t_encdec.init_encdec(torch.Generator().manual_seed(0), T_CFG)

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
        assert tuple(tf[k].shape) == tuple(leaf.shape), k
        assert str(tf[k].dtype).split(".")[-1] == str(leaf.dtype), k


def test_sinusoidal_positions_match():
    want = j_encdec.sinusoidal_positions(64, 128, jnp.float32)
    got = t_encdec.sinusoidal_positions(64, 128, torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert_leaf_equal(j_encdec.sinusoidal_positions(64, 128),
                      t_encdec.sinusoidal_positions(64, 128), "bf16")


def _enc(model):
    _, jparams, tparams, batch = model
    j_out = jax.jit(lambda p, f: j_encdec.encode(p, J_CFG, f, remat=False))(
        jparams, jnp.asarray(batch["frames"]))
    t_out = t_encdec.encode(tparams, T_CFG, to_torch(batch["frames"]))
    return j_out, t_out


def test_encode_matches(model):
    j_out, t_out = _enc(model)
    assert t_out.shape == (BATCH, 64, 128) and t_out.dtype == torch.bfloat16
    _close_scaled(t_out, j_out, "encode")


def test_decoder_hidden_matches(model):
    _, jparams, tparams, batch = model
    j_out, t_out = _enc(model)
    j_hidden, j_kvs = jax.jit(lambda p, t, e: j_encdec.decoder_hidden(
        p, J_CFG, t, e, remat=False, collect_kv=True))(
        jparams, jnp.asarray(batch["tokens"]), j_out)
    # the same encoder output on both sides, so that only the decoder
    # is compared
    t_hidden, ((k, v), (ck, cv)) = t_encdec.decoder_hidden(
        tparams, T_CFG, to_torch(batch["tokens"]), to_torch(j_out),
        collect_kv=True)
    _close_scaled(t_hidden, j_hidden, "hidden")
    (jk, jv), (jck, jcv) = j_kvs
    for name, got, want in (("k", k, jk), ("v", v, jv), ("ck", ck, jck),
                            ("cv", cv, jcv)):
        assert tuple(got.shape) == tuple(want.shape), name
        _close_scaled(got, want, name)


def _cross_tier(rng, b=BATCH, f=64, hkv=2, hd=32, group=16):
    ck = (2.0 * rng.standard_normal((b, f, hkv, hd))).astype(np.float32)
    cv = (2.0 * rng.standard_normal((b, f, hkv, hd))).astype(np.float32)
    out = {}
    for name, x in (("ck", ck), ("cv", cv)):
        pk, sc = jax.jit(lambda a: j_quantize(a, group))(
            jnp.asarray(x, jnp.bfloat16))
        out[name + "4"] = np.asarray(pk)
        out[name + "4_sc"] = np.asarray(sc.astype(jnp.bfloat16))
    return out


@pytest.mark.parametrize("group", (16, 32))
def test_cross_decode_attention_matches_the_dequantized_reference(model,
                                                                  group):
    """The dense partial over the whole cross tier, normalized by its own
    l, against the reference's bf16 dequantization and its chunked
    attention (chunk 2048, as its decode step calls it)."""
    _, jparams, tparams, _ = model
    rng = np.random.default_rng(11)
    tier = _cross_tier(rng, group=group)
    x = (rng.standard_normal((BATCH, 1, 128))).astype(np.float32)
    jp = jax.tree.map(lambda a: a[0], jparams["dec_layers"]["cross_attn"])
    tp = {k: v[0] for k, v in tparams["dec_layers"]["cross_attn"].items()}

    def ref(p, x, t):
        ck = j_dequant(t["ck4"], t["ck4_sc"], group)
        cv = j_dequant(t["cv4"], t["cv4_sc"], group)
        return j_attn.apply_cross_attention(p, J_CFG, x, ck, cv, chunk=2048)
    want = jax.jit(ref)(jp, jnp.asarray(x, jnp.bfloat16),
                        {k: jnp.asarray(v) for k, v in tier.items()})
    got = t_encdec.cross_decode_attention(
        tp, T_CFG, to_torch(x).to(torch.bfloat16),
        {k: to_torch(v) for k, v in tier.items()}, group)
    assert got.shape == (BATCH, 1, 128) and got.dtype == torch.bfloat16
    _close(got, want, "cross")


def test_cross_tier_split_plan_stops_at_the_frames():
    """F = 1500 is no multiple of the split: the last split ends at F,
    and no split starts past it (the kernel masks the rest of its last
    split and loads nothing past dense_len)."""
    for b, hkv, g in ((4, 6, 1), (1, 6, 1), (4, 6, 2)):
        tokens, splits = tiered.split_plan(1500, b, hkv, g)
        assert (splits - 1) * tokens < 1500 <= splits * tokens
        assert 1500 % tokens


def test_prefill_cross_tier_is_the_reference_quantizer(model):
    """The prefill quantizes the cross K/V once (`ips_repack`'s tier form;
    on the CPU its plain version): bit for bit the reference's
    `quantize_int4` of the same projections, scales cast to bf16."""
    _, _, tparams, batch = model
    tb = t_build(T_CFG, device="cpu")
    spec = t_tier_spec(tb, 64, TPolicy.IPS, **SPEC)
    tbatch = {k: to_torch(v) for k, v in batch.items()}
    cache, _ = tb.prefill(tparams, tbatch, spec)
    enc = t_encdec.encode(tparams, T_CFG, tbatch["frames"])
    _, (_, (ck, cv)) = t_encdec.decoder_hidden(
        tparams, T_CFG, tbatch["tokens"], enc, collect_kv=True)
    for name, x in (("ck", ck), ("cv", cv)):
        pk, sc = jax.jit(lambda a: j_quantize(a, spec.group))(
            jnp.asarray(to_numpy(x)))
        assert_leaf_equal(pk, cache["layers"][name + "4"], name + "4")
        assert_leaf_equal(sc.astype(jnp.bfloat16),
                          cache["layers"][name + "4_sc"], name + "4_sc")


def test_layout_matches_the_reference():
    assert tlayout.QUANT_CHANNELS["encdec_self"] == \
        jlayout.QUANT_CHANNELS["encdec_self"]
    assert tlayout.RAW_CHANNELS["encdec_self"] == \
        jlayout.RAW_CHANNELS["encdec_self"]
    want = jlayout.cross_static_zeros(2, 3, 50, 6, 64, 32)
    got = tlayout.cross_static_zeros(2, 3, 50, 6, 64, 32, device="cpu")
    assert sorted(got) == sorted(want)
    for k in want:
        assert_leaf_equal(want[k], got[k], k)


# ---------------------------------------------------------------------------
# served end to end
# ---------------------------------------------------------------------------

_RUNS = {}


def _reference_run(model, policy):
    if policy in _RUNS:
        return _RUNS[policy]
    jb, jparams, _, batch = model
    spec = j_tier_spec(jb, 64, policy, **SPEC)
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
           "cache": jax.tree.map(np.asarray, cache),
           "metrics": {k: np.float32(metrics[k]) for k in METRICS}}
    _RUNS[policy] = run
    return run


def _assert_counters(ref, cache, metrics, label):
    assert cache["dense_len"] == int(ref["cache"]["dense_len"]), label
    assert cache["total_len"] == int(ref["cache"]["total_len"]), label
    for k in METRICS:
        assert (np.float32(metrics[k]).view(np.uint32)
                == ref["metrics"][k].view(np.uint32)), (
            f"{label}: {k} {metrics[k]!r} != {ref['metrics'][k]!r}")


@pytest.mark.parametrize("policy", list(JPolicy), ids=lambda p: p.name)
def test_served_prefill_and_teacher_forced_decode(model, policy):
    _, _, tparams, batch = model
    ref = _reference_run(model, policy)
    tpol = TPolicy(int(policy))
    tb = t_build(T_CFG, device="cpu")
    assert tb.cache_kind == "encdec_self"
    spec = t_tier_spec(tb, 64, tpol, **SPEC)
    assert spec.s_dense == ref["spec"].s_dense
    cache, logits = tb.prefill(tparams, {k: to_torch(v) for k, v in
                                         batch.items()}, spec)
    _close(logits, ref["prefill_logits"], "prefill")
    step = t_serve_step(tb, spec, tpol)
    metrics = zero_metrics()
    cross = {k: cache["layers"][k].clone()
             for k in ("ck4", "ck4_sc", "cv4", "cv4_sc")}
    for i, (tok, want) in enumerate(zip(ref["inputs"], ref["logits"])):
        _, lg, cache, metrics = step(tparams, cache, to_torch(tok), metrics)
        _close(lg, want, f"step {i}")
    _assert_counters(ref, cache, metrics, "teacher-forced")
    # the cross tier is static: never appended to, never repacked
    for k, v in cross.items():
        assert torch.equal(cache["layers"][k], v), k


@pytest.mark.parametrize("policy", list(JPolicy), ids=lambda p: p.name)
def test_served_free_running_counters(model, policy):
    """The port's own greedy tokens and frames: the counters do not
    depend on them."""
    _, _, tparams, _ = model
    ref = _reference_run(model, policy)
    tpol = TPolicy(int(policy))
    tb = t_build(T_CFG, device="cpu")
    spec = t_tier_spec(tb, 64, tpol, **SPEC)
    gen = torch.Generator().manual_seed(int(policy))
    batch = t_batch(T_CFG, BATCH, PROMPT, gen)
    assert batch["frames"].shape == (BATCH, 64, 128)
    assert batch["frames"].dtype == torch.bfloat16
    cache, logits = tb.prefill(tparams, batch, spec)
    first = torch.argmax(logits, -1).to(torch.int32)[:, None]
    toks, cache, metrics = t_decode_loop(tb, tparams, cache, first, STEPS,
                                         spec, tpol)
    assert toks.shape == (BATCH, STEPS)
    _assert_counters(ref, cache, metrics, "free-running")


def test_decode_step_from_the_reference_cache(model):
    """One decode step from the reference's own prefill cache (crossed
    by `interop`, the cross tier with it): logits within 2e-2, and the
    new K/V the reference's."""
    jb, jparams, tparams, _ = model
    ref = _reference_run(model, JPolicy.IPS)
    cache = cache_from_jax(ref["cache"], device="cpu")
    tok = ref["inputs"][0]
    jcache = jax.tree.map(jnp.asarray, ref["cache"])
    j_logits, (jk, jv) = jax.jit(lambda p, t, c: j_encdec.encdec_decode_step(
        p, J_CFG, t, c, quant_group=16))(jparams, jnp.asarray(tok), jcache)
    logits, (k, v) = t_encdec.encdec_decode_step(tparams, T_CFG,
                                                 to_torch(tok), cache,
                                                 quant_group=16)
    _close(logits, j_logits, "logits")
    _close_scaled(k, jk, "k_new")
    _close_scaled(v, jv, "v_new")


def test_serve_tick_leaves_the_cross_tier(model):
    """`serve_tick` on the `encdec_self` kind appends to and repacks the
    self tiers only, as on `gqa`."""
    spec = tlayout.TierSpec(s_max=64, hot_window=16, page_tokens=8,
                            group=16)
    layers = tlayout.gqa_layer_zeros(2, 1, spec, 2, 32, device="cpu")
    layers.update(tlayout.cross_static_zeros(2, 1, 8, 2, 32, 16,
                                             device="cpu"))
    for k in ("ck4", "cv4"):
        layers[k].fill_(7)
    cache = {"layers": layers, "dense_len": 0, "total_len": 16}
    kv = torch.ones((2, 1, 1, 2, 32), dtype=torch.bfloat16)
    out, m = tmanager.serve_tick(cache, "encdec_self", spec, TPolicy.IPS,
                                 (kv, kv))
    assert out["dense_len"] == 8 and out["total_len"] == 17
    assert float(m["stall_events"]) == 1.0
    assert int((out["layers"]["ck4"] == 7).all()) == 1
    assert int((out["layers"]["cv4_sc"] == 0).all()) == 1


def test_launcher_serves_whisper_on_the_cpu(capsys):
    t_launch.main(["--arch", NAME, "--reduced", "--device", "cpu",
                   "--prompt-len", "24", "--decode", "12", "--policy",
                   "ips"])
    out = capsys.readouterr().out
    assert "prefill 24 tokens x2" in out
    assert "policy=IPS:" in out and "sample tokens:" in out
