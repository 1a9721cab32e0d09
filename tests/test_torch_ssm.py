"""Port vs reference: the Mamba2 path — the plain version of the SSD
intra-chunk contraction (the `ssd_intra` kernel's), the chunked scan
around it, the Mamba2 block in both forms, and mamba2-370m reduced,
served end to end with the reference's weights carried across.

Inputs are made with numpy from a seed and handed to both; the
reference's Pallas kernel runs in interpret mode, as
tests/test_kernels.py runs it. Each tolerance is stated where it is
used.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.core.tiercache.manager import zero_metrics as j_zero
from repro.core.tiercache.policy import Policy as JPolicy
from repro.kernels.ssd_scan.kernel import ssd_intra_pallas
from repro.kernels.ssd_scan.ops import ssd_chunked_kernel as j_chunked_kernel
from repro.kernels.ssd_scan.ref import intra_chunk_ref as j_intra_ref
from repro.models import mamba2 as jm2
from repro.models.model_zoo import build_model as j_build
from repro.models.model_zoo import make_train_batch as j_batch
from repro.serve.engine import make_serve_step as j_serve_step
from repro.serve.engine import make_tier_spec as j_tier_spec
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.core.tiercache.manager import METRICS, zero_metrics
from repro_torch.core.tiercache.policy import Policy as TPolicy
from repro_torch.interop import cache_from_jax, model_params_from_jax
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ref import intra_chunk_ref as t_intra_ref
from repro_torch.launch import serve as t_launch
from repro_torch.models import mamba2 as tm2
from repro_torch.models.model_zoo import build_model as t_build
from repro_torch.models.model_zoo import make_train_batch as t_batch
from repro_torch.serve.engine import decode_loop as t_decode_loop
from repro_torch.serve.engine import make_serve_step as t_serve_step
from repro_torch.serve.engine import make_tier_spec as t_tier_spec
from torch_port_util import to_numpy, to_torch

# float32 on both sides, other summation orders: the reference's own
# tolerance for its kernel against its oracle (test_kernels.py). y and
# the states are sums of up to Q terms that cancel, so their 2e-5 is
# taken of the sum of the terms' magnitudes (the bound of a float32 sum
# in any order scales with it); cum is held at 1e-6 elementwise
Y_TOL, CUM_TOL = 2e-5, 1e-6
# bf16 activations through the model: the reference's own bf16 tolerance
# (test_integration.py), as tests/test_torch_serve.py holds gemma
TOL = 2e-2


def _close(ref, got, tol, label):
    got = to_numpy(got).astype(np.float32)
    assert np.isfinite(got).all(), f"{label}: non-finite values"
    np.testing.assert_allclose(got, np.asarray(ref, np.float32), rtol=tol,
                               atol=tol, err_msg=label)


def _intra_inputs(seed, bt, nc, q, nh, hd, n, a=None):
    """Chunked inputs; A is drawn per head from the seed unless given."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bt, nc, q, nh, hd)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((bt, nc, q, nh)))).astype(
        np.float32)
    A = (np.full(nh, a, np.float32) if a is not None else
         -np.exp(0.3 * rng.standard_normal(nh)).astype(np.float32))
    B = rng.standard_normal((bt, nc, q, n)).astype(np.float32)
    C = rng.standard_normal((bt, nc, q, n)).astype(np.float32)
    return x, dt, A, B, C


INTRA_SETS = [  # (bt, nc, q, nh, hd, n, A): test_kernels.py's, then the
    # overflow stress case (A = -1 at Q 256: exp(cum_i - cum_j) overflows
    # above the diagonal unless it is masked first)
    (2, 2, 16, 2, 16, 16, None), (2, 2, 32, 4, 32, 16, None),
    (2, 2, 64, 2, 64, 32, None), (1, 2, 256, 3, 16, 16, -1.0)]


def _term_magnitudes(x, dt, A, B, C):
    """y and states summed over |terms| (float64): the scale of each
    output's float32 rounding."""
    x, dt, A, B, C = (np.asarray(v, np.float64) for v in (x, dt, A, B, C))
    cum = np.cumsum(dt * A, axis=2)
    q = x.shape[2]
    causal = np.tril(np.ones((q, q), bool))[None, None, :, :, None]
    seg = np.where(causal, cum[:, :, :, None] - cum[:, :, None], 0.0)
    L = np.where(causal, np.exp(seg), 0.0)
    cb = np.einsum("bcin,bcjn->bcij", np.abs(C), np.abs(B))
    y = np.einsum("bcijh,bcjhp->bcihp", cb[..., None] * L * dt[:, :, None],
                  np.abs(x))
    w = np.exp(cum[:, :, -1:] - cum) * dt
    st = np.einsum("bcjn,bcjhp->bchpn", np.abs(B), np.abs(x) * w[..., None])
    return y, st


def _within_terms(ref, got, mag, label):
    got = to_numpy(got).astype(np.float64)
    assert np.isfinite(got).all(), f"{label}: non-finite values"
    err = np.abs(got - np.asarray(ref, np.float64))
    worst = float((err / (Y_TOL * mag + 1e-30)).max())
    assert worst <= 1.0, (f"{label}: error {float(err.max())}, "
                          f"{worst:.3f}x the tolerance")


@pytest.mark.parametrize("bt,nc,q,nh,hd,n,a", INTRA_SETS)
def test_intra_plain_version_matches_reference(bt, nc, q, nh, hd, n, a):
    ins = _intra_inputs(q * nh, bt, nc, q, nh, hd, n, a)
    ref = j_intra_ref(*map(jnp.asarray, ins))
    pal = ssd_intra_pallas(*map(jnp.asarray, ins), interpret=True)
    got = ssd_ops.ssd_intra(*map(to_torch, ins))       # CPU: plain version
    mags = _term_magnitudes(*ins)
    for r, p, t, name in zip(ref, pal, got, ("y", "states", "cum")):
        assert t.dtype == torch.float32 and t.shape == r.shape, name
        for want, label in ((r, "intra_chunk_ref"),
                            (p, "the Pallas kernel (interpret)")):
            if name == "cum":
                _close(want, t, CUM_TOL, f"cum vs {label}")
            else:
                _within_terms(want, t, mags[name == "states"],
                              f"{name} vs {label}")


def test_intra_reads_each_heads_own_A():
    """A drawn per head: swapping two heads' A changes exactly those
    heads' outputs."""
    x, dt, A, B, C = map(to_torch, _intra_inputs(5, 1, 1, 32, 3, 16, 16))
    y, st, cum = ssd_ops.ssd_intra(x, dt, A, B, C)
    y2, st2, cum2 = ssd_ops.ssd_intra(x, dt, A[[1, 0, 2]], B, C)
    assert torch.equal(y[..., 2, :], y2[..., 2, :])
    assert not torch.allclose(y[..., 0, :], y2[..., 0, :], rtol=1e-3,
                              atol=1e-3)
    assert not torch.allclose(cum[..., 1], cum2[..., 1])


def _tf32(a):
    """Round float32 to TF32 (10 mantissa bits) to nearest, ties away
    from zero, on the bit pattern: what cvt.rna.tf32.f32 does."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def _mm_tf32(a, b, passes):
    """a @ b in float32 from TF32 operands, as the tensor cores take
    them: one pass (big * big) or the 3xTF32 split (small * big + big *
    small + big * big, big = tf32(x), small = tf32(x - big))."""
    a_big, b_big = _tf32(a), _tf32(b)
    if passes == 1:
        return a_big @ b_big
    a_small = _tf32((a - a_big).astype(np.float32))
    b_small = _tf32((b - b_big).astype(np.float32))
    return (a_small @ b_big + a_big @ b_small) + a_big @ b_big


def _intra_tensor_cores(x, dt, A, B, C, passes):
    """The `ssd_intra` kernel's arithmetic on the CPU: the three products
    (C B^T, scores x x, the state product (decay-weighted x)^T x B) on
    TF32 operands, the decay, the mask and the weights in float32, the
    weights applied to x before the split as the kernel applies them;
    one chunk at a time (Bt = nc = 1)."""
    cum = np.cumsum((dt[0, 0] * A).astype(np.float64), axis=0).astype(
        np.float32)                                          # (Q, nh)
    xs, Bs, Cs, dts = x[0, 0], B[0, 0], C[0, 0], dt[0, 0]
    q, nh, hd = xs.shape
    causal = np.tril(np.ones((q, q), bool))
    cb = _mm_tf32(Cs, np.ascontiguousarray(Bs.T), passes)
    y = np.zeros_like(xs)
    states = np.zeros((nh, hd, Bs.shape[1]), np.float32)
    for h in range(nh):
        seg = np.where(causal, cum[:, None, h] - cum[None, :, h], 0.0)
        L = np.where(causal, np.exp(seg.astype(np.float32)), 0.0)
        scores = ((cb * L).astype(np.float32) * dts[None, :, h]).astype(
            np.float32)
        y[:, h] = _mm_tf32(scores, np.ascontiguousarray(xs[:, h]), passes)
        w = (np.exp(cum[-1, h] - cum[:, h]) * dts[:, h]).astype(np.float32)
        xw = (xs[:, h] * w[:, None]).astype(np.float32)   # as the kernel
        states[h] = _mm_tf32(np.ascontiguousarray(xw.T), Bs, passes)
    return y[None, None], states[None, None]


@pytest.mark.parametrize("hd,n", [(64, 128), (64, 64)],
                         ids=["mamba2-370m", "zamba2-1.2b"])
def test_3xtf32_products_meet_the_path_check(hd, n, record_property):
    """The kernel's 3xTF32 products, emulated on the CPU at the two
    models' head and state widths (Q 256, 3 heads), stay within the path
    check's 2e-5 of max |output| of the plain version; single-pass TF32
    is recorded beside it (not asserted): some 5e-4, why the split is
    needed."""
    ins = _intra_inputs(hd + n, 1, 1, 256, 3, hd, n)
    want = [to_numpy(t) for t in t_intra_ref(*map(to_torch, ins))[:2]]
    for passes in (3, 1):
        got = _intra_tensor_cores(*ins, passes=passes)
        rel = {name: float(np.abs(g - w).max() / np.abs(w).max())
               for name, g, w in zip(("y", "states"), got, want)}
        record_property(f"tf32_x{passes}_max_err_over_max_abs", rel)
        if passes == 3:
            for name, r in rel.items():
                assert r <= Y_TOL, f"3xTF32 {name}: {r:.3g} of max |out|"


def _scan_inputs(seed, b, s, nh, hd, n):
    rng = np.random.default_rng(seed)
    x = (0.5 * rng.standard_normal((b, s, nh, hd))).astype(jnp.bfloat16)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, nh)))).astype(np.float32)
    A = -np.exp(0.3 * rng.standard_normal(nh)).astype(np.float32)
    B = rng.standard_normal((b, s, n)).astype(np.float32)
    C = rng.standard_normal((b, s, n)).astype(np.float32)
    h0 = (0.3 * rng.standard_normal((b, nh, hd, n))).astype(np.float32)
    return x, dt, A, B, C, h0


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("b,s,nh,hd,n,chunk", [
    (2, 128, 2, 32, 16, 32),           # test_kernels.py's scan
    (1, 96, 3, 16, 16, 256),           # one chunk shorter than `chunk`
    (2, 64, 4, 16, 32, 16)])
def test_chunked_scan_matches_reference(b, s, nh, hd, n, chunk, with_h0):
    x, dt, A, B, C, h0 = _scan_inputs(s + nh, b, s, nh, hd, n)
    h0 = h0 if with_h0 else None
    jin = [jnp.asarray(v) for v in (x, dt, A, B, C)]
    jh0 = None if h0 is None else jnp.asarray(h0)
    y_ref, h_ref = jm2.ssd_chunked(*jin, chunk, h0=jh0)
    y_pal, h_pal = j_chunked_kernel(*jin, chunk, h0=jh0, interpret=True)
    y, h = tm2.ssd_chunked(*map(to_torch, (x, dt, A, B, C)), chunk,
                           h0=None if h0 is None else to_torch(h0))
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    for ref, label in ((y_ref, "models.mamba2.ssd_chunked"),
                       (y_pal, "ssd_chunked_kernel (interpret)")):
        # bf16 y: one bf16 rounding of float32 sums that differ in order,
        # 1e-2 (tighter than test_kernels.py's 5e-2)
        _close(ref, y, 1e-2, f"y vs {label}")
    for ref, label in ((h_ref, "models.mamba2.ssd_chunked"),
                       (h_pal, "ssd_chunked_kernel (interpret)")):
        # float32 states: test_kernels.py's 1e-4
        _close(ref, h, 1e-4, f"h_final vs {label}")


def test_chunked_state_equals_the_recurrence():
    """Chunked scan h_final == token-by-token recurrence (SSD duality)."""
    x, dt, A, B, C, h0 = map(to_torch, _scan_inputs(11, 1, 48, 2, 16, 16))
    x = x.to(torch.float32)
    _, h_chunked = tm2.ssd_chunked(x, dt, A, B, C, chunk=16, h0=h0)
    h = h0.clone()
    for t in range(x.shape[1]):
        decay = torch.exp(dt[:, t] * A[None])
        h = decay[:, :, None, None] * h + (
            dt[:, t][:, :, None, None] * x[:, t][:, :, :, None]
            * B[:, t][:, None, None, :])
    # float32, one recurrence against the chunked sums: 1e-4, as
    # test_kernels.py holds the reference's duality
    torch.testing.assert_close(h_chunked, h, rtol=1e-4, atol=1e-4)


def test_chunked_scan_takes_the_wrapper_from_the_module(monkeypatch):
    """The scan looks `ssd_intra` up on its module at each call, so a run
    that replaces it (chip_smoke.py's plain-version run, a planted fault)
    reaches every call site."""
    x, dt, A, B, C, _ = map(to_torch, _scan_inputs(3, 1, 32, 2, 16, 16))
    calls = []

    def plain(*args):
        calls.append(1)
        return t_intra_ref(*args)

    want = tm2.ssd_chunked(x, dt, A, B, C, 16)
    monkeypatch.setattr(ssd_ops, "ssd_intra", plain)
    got = tm2.ssd_chunked(x, dt, A, B, C, 16)
    assert calls == [1]
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_chunked_scan_refuses_a_ragged_length():
    x, dt, A, B, C, _ = map(to_torch, _scan_inputs(4, 1, 40, 2, 16, 16))
    with pytest.raises(ValueError, match="divisible"):
        tm2.ssd_chunked(x, dt, A, B, C, 16)


# ---------------------------------------------------------------------------
# the Mamba2 block
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def block():
    jcfg = J_ARCHS["mamba2-370m"].reduced()
    tcfg = T_ARCHS["mamba2-370m"].reduced()
    jp = jax.tree.map(np.asarray, jm2.init_mamba2(jax.random.PRNGKey(2),
                                                  jcfg))
    rng = np.random.default_rng(2)
    # a nonzero dt bias and per-head A_log, so each head decays its own way
    nh = jcfg.ssm.num_heads(jcfg.d_model)
    jp = dict(jp, A_log=(0.5 * rng.standard_normal(nh)).astype(np.float32),
              dt_bias=(0.5 * rng.standard_normal(nh)).astype(np.float32))
    tp = model_params_from_jax({"layers": {"mamba": jp}},
                               device="cpu")["layers"]["mamba"]
    return jcfg, tcfg, jp, tp, rng


@pytest.mark.parametrize("carry", [False, True])
def test_block_prefill_matches_reference(block, carry):
    jcfg, tcfg, jp, tp, rng = block
    s = jcfg.ssm
    b, seq = 2, 64
    d_xc = s.d_inner(jcfg.d_model) + 2 * s.d_state
    nh = s.num_heads(jcfg.d_model)
    x = (0.5 * rng.standard_normal((b, seq, jcfg.d_model))).astype(
        jnp.bfloat16)
    conv0 = ssm0 = None
    if carry:
        conv0 = rng.standard_normal((b, s.d_conv - 1, d_xc)).astype(
            jnp.bfloat16)
        ssm0 = (0.1 * rng.standard_normal((b, nh, s.head_dim, s.d_state))
                ).astype(np.float32)
    jy, (jconv, jh) = jm2.apply_mamba2(
        jax.tree.map(jnp.asarray, jp), jcfg, jnp.asarray(x),
        conv_state=None if conv0 is None else jnp.asarray(conv0),
        ssm_state=None if ssm0 is None else jnp.asarray(ssm0),
        return_state=True)
    ty, (tconv, th) = tm2.apply_mamba2(
        tp, tcfg, to_torch(x),
        conv_state=None if conv0 is None else to_torch(conv0),
        ssm_state=None if ssm0 is None else to_torch(ssm0),
        return_state=True)
    assert ty.dtype == torch.bfloat16 and tconv.dtype == torch.bfloat16
    _close(jy, ty, TOL, "block output")
    _close(jconv, tconv, 0.0, "conv state")      # the inputs' last rows
    _close(jh, th, TOL, "ssm state")


def test_block_decode_matches_reference(block):
    jcfg, tcfg, jp, tp, rng = block
    s = jcfg.ssm
    b = 3
    d_xc = s.d_inner(jcfg.d_model) + 2 * s.d_state
    nh = s.num_heads(jcfg.d_model)
    x = (0.5 * rng.standard_normal((b, 1, jcfg.d_model))).astype(jnp.bfloat16)
    conv = rng.standard_normal((b, s.d_conv - 1, d_xc)).astype(jnp.bfloat16)
    ssm = (0.1 * rng.standard_normal((b, nh, s.head_dim, s.d_state))).astype(
        np.float32)
    jy, (jconv, jh) = jm2.apply_mamba2_decode(
        jax.tree.map(jnp.asarray, jp), jcfg, jnp.asarray(x),
        jnp.asarray(conv), jnp.asarray(ssm))
    ty, (tconv, th) = tm2.apply_mamba2_decode(tp, tcfg, to_torch(x),
                                              to_torch(conv), to_torch(ssm))
    _close(jy, ty, TOL, "decode output")
    _close(jconv, tconv, 0.0, "conv state")
    _close(jh, th, 1e-5, "ssm state")   # float32 from the same bf16 inputs


def test_prefill_state_continues_as_decode(block):
    """Prefill of 64 tokens (two chunks) == prefill of the first 32, then
    32 decode steps: the states and each step's output."""
    _, tcfg, _, tp, rng = block
    x = to_torch((0.5 * rng.standard_normal((2, 64, tcfg.d_model))).astype(
        jnp.bfloat16))
    y_all, (conv_all, h_all) = tm2.apply_mamba2(tp, tcfg, x,
                                                return_state=True)
    _, (conv, h) = tm2.apply_mamba2(tp, tcfg, x[:, :32], return_state=True)
    for t in range(32, 64):
        y1, (conv, h) = tm2.apply_mamba2_decode(tp, tcfg, x[:, t:t + 1],
                                                conv, h)
        # bf16 outputs of two float32 orders (chunked vs recurrent)
        torch.testing.assert_close(y1.float(), y_all[:, t:t + 1].float(),
                                   rtol=TOL, atol=TOL)
    assert torch.equal(conv, conv_all)
    torch.testing.assert_close(h, h_all, rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# mamba2-370m reduced, served
# ---------------------------------------------------------------------------

PROMPT, STEPS, BATCH = 64, 24, 2


@pytest.fixture(scope="module")
def model():
    jcfg = J_ARCHS["mamba2-370m"].reduced()
    jb = j_build(jcfg)
    jparams = jax.jit(jb.init)(jax.random.PRNGKey(0))
    tparams = model_params_from_jax(jax.tree.map(np.asarray, jparams),
                                    device="cpu")
    tokens = np.asarray(j_batch(jcfg, BATCH, PROMPT)["tokens"])
    spec = j_tier_spec(jb, PROMPT + STEPS, JPolicy.IPS, hot_window=16,
                       page_tokens=8, group=16)
    cache, logits = jax.jit(lambda p, b: jb.prefill(p, b, spec))(
        jparams, {"tokens": jnp.asarray(tokens)})
    prefill = {"logits": np.asarray(logits),
               "cache": jax.tree.map(np.asarray, cache)}
    step = jax.jit(j_serve_step(jb, spec, JPolicy.IPS))
    metrics = j_zero()
    token = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
    inputs, step_logits = [], []
    for _ in range(STEPS):
        inputs.append(np.asarray(token))
        token, lg, cache, metrics = step(jparams, cache, token, metrics)
        step_logits.append(np.asarray(lg))
    ref = {"prefill": prefill, "inputs": inputs, "logits": step_logits,
           "cache": jax.tree.map(np.asarray, cache),
           "metrics": {k: np.float32(metrics[k]) for k in METRICS}}
    return tparams, tokens, ref


def _assert_metrics(ref, metrics, label):
    for k in METRICS:
        assert (np.float32(metrics[k]).view(np.uint32)
                == ref[k].view(np.uint32)), (
            f"{label}: {k} {metrics[k]!r} != {ref[k]!r}")


def test_ssm_prefill_and_teacher_forced_decode(model):
    tparams, tokens, ref = model
    tcfg = T_ARCHS["mamba2-370m"].reduced()
    tb = t_build(tcfg, device="cpu")
    assert tb.cache_kind == "ssm"
    spec = t_tier_spec(tb, PROMPT + STEPS, TPolicy.IPS, hot_window=16,
                       page_tokens=8, group=16)
    cache, logits = tb.prefill(tparams, {"tokens": to_torch(tokens)}, spec)
    _close(ref["prefill"]["logits"], logits, TOL, "prefill logits")
    want = cache_from_jax(ref["prefill"]["cache"], device="cpu")
    assert (cache["dense_len"], cache["total_len"]) == (
        want["dense_len"], want["total_len"]) == (PROMPT, PROMPT)
    _close(to_numpy(want["conv"]), cache["conv"], TOL, "prefill conv")
    _close(to_numpy(want["ssm"]), cache["ssm"], TOL, "prefill ssm")
    step = t_serve_step(tb, spec, TPolicy.IPS)
    metrics = zero_metrics()
    for i, (tok, lg_want) in enumerate(zip(ref["inputs"], ref["logits"])):
        _, lg, cache, metrics = step(tparams, cache, to_torch(tok), metrics)
        _close(lg_want, lg, TOL, f"step {i} logits")
    want = cache_from_jax(ref["cache"], device="cpu")
    assert (cache["dense_len"], cache["total_len"]) == (
        want["dense_len"], want["total_len"]) == (PROMPT + STEPS,) * 2
    _close(to_numpy(want["ssm"]), cache["ssm"], TOL, "final ssm")
    _assert_metrics(ref["metrics"], metrics, "teacher-forced")
    # the state bytes pass 2^24 only at full size; here the sum is exact
    per_step = cache["conv"].numel() * 2 + cache["ssm"].numel() * 4
    assert float(metrics["hbm_write_bytes"]) == STEPS * per_step
    assert float(metrics["appended_tokens"]) == STEPS


@pytest.mark.parametrize("policy", list(TPolicy), ids=lambda p: p.name)
def test_ssm_policy_changes_nothing(model, policy):
    """An ssm model has no KV cache: every policy serves the same tokens
    with the same counters, the reference's IPS run's."""
    tparams, tokens, ref = model
    tcfg = T_ARCHS["mamba2-370m"].reduced()
    tb = t_build(tcfg, device="cpu")
    spec = t_tier_spec(tb, PROMPT + STEPS, policy, hot_window=16,
                       page_tokens=8, group=16)
    cache, logits = tb.prefill(tparams, {"tokens": to_torch(tokens)}, spec)
    first = torch.argmax(logits, -1).to(torch.int32)[:, None]
    toks, cache, metrics = t_decode_loop(tb, tparams, cache, first, STEPS,
                                         spec, policy)
    assert toks.shape == (BATCH, STEPS) and toks.dtype == torch.int32
    _assert_metrics(ref["metrics"], metrics, policy.name)
    assert cache["dense_len"] == cache["total_len"] == PROMPT + STEPS


def test_ssm_bundle_makes_zero_states():
    tcfg = T_ARCHS["mamba2-370m"].reduced()
    jcfg = J_ARCHS["mamba2-370m"].reduced()
    tb = t_build(tcfg, device="cpu")
    got = tb.make_decode_cache(3, 40)
    want = jax.tree.map(np.asarray, j_build(jcfg).make_decode_cache(3, 40))
    for k in ("conv", "ssm"):
        assert got[k].shape == want[k].shape, k
        assert to_numpy(got[k]).dtype == want[k].dtype, k
        assert not got[k].any()
    assert got["dense_len"] == got["total_len"] == 40
    # a fresh model from the port's own generator serves as well
    params = tb.init(torch.Generator().manual_seed(0))
    batch = t_batch(tcfg, 2, 32, torch.Generator().manual_seed(1))
    cache, logits = tb.prefill(params, batch)
    assert logits.shape == (2, tcfg.vocab_size)
    assert torch.isfinite(logits).all()


def test_launcher_runs_mamba2_on_the_cpu(capsys):
    t_launch.main(["--arch", "mamba2-370m", "--reduced", "--device", "cpu",
                   "--prompt-len", "32", "--decode", "8", "--policy",
                   "baseline"])
    out = capsys.readouterr().out
    assert "prefill 32 tokens x2" in out
    assert "policy=BASELINE:" in out and "stalls=0" in out
    assert "repacked=0 tok" in out and "sample tokens:" in out
