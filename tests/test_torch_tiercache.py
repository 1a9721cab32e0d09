"""Port vs reference: the tiered KV cache — the int4 quantizer, the
arena repack, the policy plans and the manager's ticks — held bit for
bit (every byte, every bf16, every float32 metric), and the copied
configuration modules.

Inputs are made with numpy from a seed and handed to both packages; the
Pallas repack kernel runs in interpret mode, as tests/test_kernels.py
runs it. The reference is held as it runs compiled (`jax.jit`), which is
how its serving path and its kernel run: compiled, XLA computes the int4
scale as `absmax * float32(1/7)` where the source divides by 7
(`test_scale_site_follows_the_compiled_reference`).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.tiercache import layout as jlayout
from repro.core.tiercache import manager as jmanager
from repro.core.tiercache import policy as jpolicy
from repro.core.tiercache.quant import dequantize_int4 as j_dequant
from repro.core.tiercache.quant import quantize_int4 as j_quant
from repro.kernels.ips_repack.kernel import repack_pallas
from repro.kernels.ips_repack.ref import repack_ref as j_repack_ref
from repro.kernels.ips_repack.ref import unpack_ref as j_unpack_ref
from repro_torch import configs as tconfigs
from repro_torch.core.tiercache import layout as tlayout
from repro_torch.core.tiercache import manager as tmanager
from repro_torch.core.tiercache import policy as tpolicy
from repro_torch.core.tiercache.quant import dequantize_int4 as t_dequant
from repro_torch.core.tiercache.quant import quantize_int4 as t_quant
from repro_torch.interop import cache_from_jax
from repro_torch.kernels.ips_repack import ops as repack_ops
from repro_torch.kernels.ips_repack.ref import (INV_INT4_MAX,
                                                quantize_into_ref,
                                                quantize_rows_ref)
from repro_torch.kernels.ips_repack.ref import repack_ref as t_repack_ref
from repro_torch.kernels.ips_repack.ref import unpack_ref as t_unpack_ref
from torch_port_util import assert_leaf_equal, to_torch

POLICIES = list(jpolicy.Policy)
J_QUANT = jax.jit(j_quant, static_argnums=1)
J_DEQUANT = jax.jit(j_dequant, static_argnums=(2, 3))
# the reference manager's `_dus_dim2`: an update written at position s of
# axis 2, s clamped into range by `dynamic_update_slice`
J_DUS = jax.jit(lambda buf, update, s: jax.lax.dynamic_update_slice(
    buf, update.astype(buf.dtype), (0, 0, s) + (0,) * (buf.ndim - 3)))


def _values(rng, shape, kind):
    """bf16 test values with exact .5 ties, all-zero groups and +-absmax."""
    x = rng.standard_normal(shape).astype(np.float32)
    if kind == "ties":
        # absmax 7 * 2^k: the scale is a power of two, so every x / scale
        # on a half step is an exact tie for round-half-to-even
        k = rng.integers(-3, 4)
        x = rng.integers(-14, 15, shape).astype(np.float32) * 0.5 * 2.0 ** k
        x[..., 0] = 7.0 * 2.0 ** k
        x[..., 1] = -7.0 * 2.0 ** k
    elif kind == "zeros":
        x[..., : shape[-1] // 2] = 0.0
    elif kind == "scaled":
        x *= rng.uniform(1e-3, 1e3, shape[:-1] + (1,)).astype(np.float32)
    return x.astype(ml_dtypes.bfloat16)


# ---------------------------------------------------------------------------
# configurations and plans (copies)
# ---------------------------------------------------------------------------


def test_arch_configs_are_copies():
    assert tuple(tconfigs.ARCH_IDS) == tuple(jconfigs.ARCH_IDS)
    for name in jconfigs.ARCH_IDS:
        j, t = jconfigs.get_arch(name), tconfigs.get_arch(name)
        assert dataclasses.asdict(t) == dataclasses.asdict(j), name
        assert t.param_count() == j.param_count(), name
        assert (dataclasses.asdict(t.reduced(num_layers=2))
                == dataclasses.asdict(j.reduced(num_layers=2))), name
    with pytest.raises(KeyError):
        tconfigs.get_arch("no-such-arch")


@pytest.mark.parametrize("hot,page", [(16, 4), (1024, 256), (32, 8)])
def test_policy_plans_are_copies(hot, page):
    for p in POLICIES:
        tp = tpolicy.Policy(int(p))
        assert tp.name == p.name
        assert (dataclasses.asdict(tpolicy.plan_for(tp, hot, page))
                == dataclasses.asdict(jpolicy.plan_for(p, hot, page)))


@pytest.mark.parametrize("s", [0, 5, 16, 24, 100, 2048])
def test_split_for_prefill(s):
    for hot, page in ((16, 8), (1024, 256), (4096, 256)):
        js = jlayout.TierSpec(s_max=64, hot_window=hot, page_tokens=page)
        ts = tlayout.TierSpec(s_max=64, hot_window=hot, page_tokens=page)
        assert ts.s_dense == js.s_dense
        assert tlayout.split_for_prefill(s, ts) == jlayout.split_for_prefill(
            s, js)


# ---------------------------------------------------------------------------
# the quantizer: bit-exact
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["normal", "ties", "zeros", "scaled"])
@pytest.mark.parametrize("feat,group", [(64, 16), (128, 32), (256, 64),
                                        (32, 32)])
def test_quantize_int4_bitassert_leaf_equal(kind, feat, group):
    rng = np.random.default_rng(feat * 7 + group)
    x = _values(rng, (3, 40, feat), kind)
    pj, sj = J_QUANT(jnp.asarray(x), group)
    pt, st = t_quant(to_torch(x), group)
    assert_leaf_equal(pj, pt, "packed")
    assert_leaf_equal(sj, st, "scales")
    # the plain version called directly, and for float32
    pt2, st2 = quantize_rows_ref(to_torch(x).reshape(-1, feat), group)
    assert torch.equal(pt.reshape(-1, feat // 2), pt2)
    assert torch.equal(st.reshape(-1, feat // group), st2)
    xf = x.astype(np.float32)
    pj, sj = J_QUANT(jnp.asarray(xf), group)
    pt, st = t_quant(to_torch(xf), group)
    assert_leaf_equal(pj, pt, "packed f32")
    assert_leaf_equal(sj, st, "scales f32")
    for dt, tdt in ((jnp.bfloat16, torch.bfloat16),
                    (jnp.float32, torch.float32)):
        assert_leaf_equal(J_DEQUANT(pj, sj, group, dt),
                          t_dequant(pt, st, group, tdt), f"dequantized {dt}")


def test_scale_site_follows_the_compiled_reference():
    """The one rounding site where the compiled reference differs from its
    source: `absmax / INT4_MAX` becomes `absmax * float32(1/7)` under jit.
    The port (and its kernel) compute the product; JAX's op-by-op dispatch
    divides and so differs from its own compiled form."""
    rng = np.random.default_rng(3)
    x = _values(rng, (256, 64), "scaled")
    xf = x.astype(np.float32).reshape(256, 4, 16)
    absmax = np.abs(xf).max(-1)
    _, s_jit = J_QUANT(jnp.asarray(x), 16)
    _, s_eager = j_quant(jnp.asarray(x), 16)
    _, s_port = t_quant(to_torch(x), 16)
    np.testing.assert_array_equal(np.asarray(s_jit),
                                  absmax * np.float32(1.0 / 7.0))
    np.testing.assert_array_equal(np.asarray(s_eager),
                                  absmax / np.float32(7.0))
    assert np.any(np.asarray(s_jit) != np.asarray(s_eager))
    assert_leaf_equal(s_jit, s_port, "scales")


def test_quantize_cpu_wrapper_does_not_count_launches():
    repack_ops.reset()
    x = to_torch(_values(np.random.default_rng(1), (8, 64), "normal"))
    repack_ops.quantize_rows(x, 16)
    arena = torch.zeros((2, 4 * 64 * 2), dtype=torch.uint8)
    repack_ops.repack_arena(arena, tokens=4, feat=64, group=16)
    assert repack_ops.LAUNCHER.launches == 0


# ---------------------------------------------------------------------------
# the in-place tier form: quantize straight into the dense tier
# ---------------------------------------------------------------------------

INTO_FEAT = {2: 16, 6: 48, 48: 96, 64: 128, 128: 256, 256: 256}


@pytest.mark.parametrize("kind", ["ties", "zeros", "scaled"])
@pytest.mark.parametrize("group", sorted(INTO_FEAT))
def test_quantize_into_ref_is_quantize_then_update_slice(kind, group):
    """`quantize_into_ref` on a strided hot-tier slice equals the compiled
    reference's `quantize_int4` written into a dense tier by
    `dynamic_update_slice`: every byte and scale, the rest of the tier
    untouched, in bf16 and float32 scale tiers, at a start in range and at
    starts that `dynamic_update_slice` clamps (past the end) or counts
    from the end (negative)."""
    feat = INTO_FEAT[group]
    rng = np.random.default_rng(group * 31 + len(kind))
    a, b, w, t, h, s_len = 2, 2, 8, 5, 2, 12
    hot = _values(rng, (a, b, w, h, feat), kind)
    pj, sj = J_QUANT(jnp.asarray(hot[:, :, :t]), group)
    for jdt in (jnp.bfloat16, jnp.float32):
        pk0 = rng.integers(0, 256, (a, b, s_len, h, feat // 2),
                           dtype=np.uint8)
        sc0 = np.asarray(jnp.asarray(rng.standard_normal(
            (a, b, s_len, h, feat // group)), jdt))
        for start in (3, 10, -4, -20):
            pk, sc = to_torch(pk0), to_torch(sc0)
            quantize_into_ref([(to_torch(hot)[:, :, :t], pk, sc)], start,
                              group)
            label = f"{jdt.__name__} start {start}"
            assert_leaf_equal(J_DUS(jnp.asarray(pk0), pj, start), pk,
                              f"packed {label}")
            assert_leaf_equal(J_DUS(jnp.asarray(sc0), sj, start), sc,
                              f"scales {label}")


def test_quantize_into_on_cpu_takes_the_plain_version():
    """The wrapper on CPU tensors: K and V in one call, each equal to its
    own plain call, and no launch counted."""
    rng = np.random.default_rng(5)
    hot = [to_torch(_values(rng, (2, 3, 16, 2, 64), "scaled"))
           for _ in range(2)]
    tiers = [(torch.zeros((2, 3, 40, 2, 32), dtype=torch.uint8),
              torch.zeros((2, 3, 40, 2, 4), dtype=torch.bfloat16))
             for _ in range(2)]
    repack_ops.reset()
    repack_ops.quantize_into([(x[:, :, :8], pk, sc)
                              for x, (pk, sc) in zip(hot, tiers)], 36, 16)
    assert repack_ops.LAUNCHER.launches == 0
    for x, (pk, sc) in zip(hot, tiers):
        want_pk, want_sc = torch.zeros_like(pk), torch.zeros_like(sc)
        quantize_into_ref([(x[:, :, :8], want_pk, want_sc)], 32, 16)
        assert torch.equal(pk, want_pk) and torch.equal(sc, want_sc)
        assert bool(pk[:, :, 32:].any()) and not bool(pk[:, :, :32].any())


def _bf16_patterns():
    """Every finite bf16 value, as float32."""
    bits = torch.arange(1 << 16, dtype=torch.int32).to(torch.int16)
    x = bits.view(torch.bfloat16).to(torch.float32)
    return x[torch.isfinite(x)]


@pytest.mark.parametrize("rcp_ulps", [-1, 0, 1])
def test_reciprocal_route_decides_as_the_division(rcp_ulps):
    """The kernel's quotient, emulated in float32 (each operation one
    IEEE rounding, as `__fmul_rn` / `__fadd_rn` are): v = x * rcp(safe)
    with the reciprocal up to one ulp off (what `rcp.approx` may give),
    rounded by adding 1.5 * 2^23 + 8; a v within 2^-17 of a half-integer
    takes the exact division. Over every finite bf16 x against absmax
    values from zero through the subnormals, 7 * 2^k (exact half-integer
    quotients) and random values, the nibble equals the reference's
    `clip(round(x / safe), -7, 7) + 8`."""
    x = _bf16_patterns()
    rng = np.random.default_rng(11)
    sub = torch.tensor([1, 2, 3, 5, 17, 100, 127], dtype=torch.int16)
    rand = torch.from_numpy(rng.integers(0x0080, 0x7f80, 80).astype(
        np.int16))
    amaxes = torch.cat([
        torch.zeros(1), sub.view(torch.bfloat16).to(torch.float32),
        7.0 * 2.0 ** torch.arange(-30, 31, 3, dtype=torch.float32),
        rand.view(torch.bfloat16).to(torch.float32)])
    magic = np.float32(12582920.0)
    near = np.float32(0.5 - 2.0 ** -17)
    ties = flagged = 0
    for amax in amaxes:
        xs = x[x.abs() <= amax]
        scale = amax * np.float32(INV_INT4_MAX)
        safe = torch.clamp(scale, min=1e-12)
        rcp = 1.0 / safe
        for _ in range(abs(rcp_ulps)):
            rcp = torch.nextafter(rcp, torch.tensor(
                float("inf") if rcp_ulps > 0 else 0.0))
        v = xs * rcp
        m = v + magic
        d = v - (m - magic)
        fast = m.view(torch.int32) & 0xF
        exact_q = torch.clamp(torch.round(xs / safe), -7, 7) + 8
        exact = d.abs() > near
        got = torch.where(exact, exact_q.to(torch.int32), fast)
        assert torch.equal(got, exact_q.to(torch.int32)), float(amax)
        quot = xs / safe
        ties += int((quot - quot.floor() == 0.5).sum())
        flagged += int(exact.sum())
    assert ties > 300 and flagged >= ties


# ---------------------------------------------------------------------------
# the arena repack: bytes exact, stale tail included
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tokens,feat,group,tail", [
    (16, 64, 16, 0), (32, 128, 32, 64), (8, 256, 64, 36), (64, 128, 64, 0),
])
def test_repack_arena_bytesassert_leaf_equal(tokens, feat, group, tail):
    rng = np.random.default_rng(tokens * feat + tail)
    pages = 3
    vals = _values(rng, (pages, tokens, feat), "scaled")
    data = vals.view(np.uint8).reshape(pages, tokens * feat * 2)
    junk = rng.integers(0, 256, (pages, tail), dtype=np.uint8)
    arena = np.concatenate([data, junk], axis=1)
    ref_j = jax.jit(functools.partial(j_repack_ref, tokens=tokens, feat=feat,
                                      group=group))(jnp.asarray(arena))
    pal_j = repack_pallas(jnp.asarray(arena), tokens=tokens, feat=feat,
                          group=group, interpret=True)
    got = t_repack_ref(to_torch(arena), tokens, feat, group)
    assert_leaf_equal(ref_j, got, "repack_ref")
    assert_leaf_equal(pal_j, got, "repack_pallas")
    # the wrapper works in place on the same storage
    buf = to_torch(arena)
    ptr = buf.data_ptr()
    out = repack_ops.repack_arena(buf, tokens=tokens, feat=feat, group=group)
    assert out.data_ptr() == ptr
    assert_leaf_equal(ref_j, buf, "repack_arena in place")
    assert_leaf_equal(j_unpack_ref(ref_j, tokens, feat, group),
                      t_unpack_ref(got, tokens, feat, group), "unpack")


# ---------------------------------------------------------------------------
# the manager: every leaf and every metric exact over repack generations
# ---------------------------------------------------------------------------

L, B, HKV, HD, GROUP = 2, 2, 2, 32, 16
STEPS = 60


def _j_cache(spec):
    return {"layers": jlayout.gqa_layer_zeros(L, B, spec, HKV, HD),
            "total_len": jnp.int32(0), "dense_len": jnp.int32(0)}


def _assert_metrics(jm, tm, label):
    for k in tmanager.METRICS:
        j = np.float32(jm[k])
        assert np.asarray(tm[k]).dtype == np.float32, k
        assert j.view(np.uint32) == np.float32(tm[k]).view(np.uint32), (
            f"{label}: {k} {tm[k]!r} != {j!r}")


def _assert_cache(jc, tc, label):
    assert tc["dense_len"] == int(jc["dense_len"]), label
    assert tc["total_len"] == int(jc["total_len"]), label
    for name, leaf in jc["layers"].items():
        assert_leaf_equal(leaf, tc["layers"][name], f"{label}: {name}")


@pytest.mark.parametrize("policy", POLICIES, ids=lambda p: p.name)
def test_serve_tickassert_leaf_equal(policy):
    jspec = jlayout.TierSpec(s_max=64, hot_window=16, page_tokens=4,
                             group=GROUP)
    tspec = tlayout.TierSpec(s_max=64, hot_window=16, page_tokens=4,
                             group=GROUP)
    tpol = tpolicy.Policy(int(policy))
    rng = np.random.default_rng(int(policy))
    kvs = [tuple(_values(rng, (L, B, 1, HKV, HD), "scaled")
                 for _ in range(2)) for _ in range(STEPS)]
    step = jax.jit(lambda c, kv, m: jmanager.serve_tick(
        c, "gqa", jspec, policy, kv, m))
    jc, jm = _j_cache(jspec), jmanager.zero_metrics()
    tc = cache_from_jax(jax.tree.map(np.asarray, jc), device="cpu")
    tm = tmanager.zero_metrics()
    repacks = 0
    for i, (k, v) in enumerate(kvs):
        before = tc["dense_len"]
        jc, jm = step(jc, (jnp.asarray(k), jnp.asarray(v)), jm)
        tc, tm = tmanager.serve_tick(tc, "gqa", tspec, tpol,
                                     (to_torch(k), to_torch(v)), tm)
        repacks += tc["dense_len"] > before
        _assert_metrics(jm, tm, f"step {i}")
        if i % 10 == 9 or tc["dense_len"] != before:
            _assert_cache(jc, tc, f"step {i}")
    _assert_cache(jc, tc, "end")
    assert repacks >= 3
    assert (tmanager.write_amplification(tm).view(np.uint32)
            == np.float32(jmanager.write_amplification(jm)).view(np.uint32))


def test_metrics_exact_past_2_pow_24():
    """Byte counts whose float32 sums round: the port adds in the
    reference's order and rounds where it rounds."""
    l, b, hkv, hd = 4, 8, 4, 256
    jspec = jlayout.TierSpec(s_max=256, hot_window=64, page_tokens=16)
    tspec = tlayout.TierSpec(s_max=256, hot_window=64, page_tokens=16)
    policy = jpolicy.Policy.BASELINE
    jc = {"layers": jlayout.gqa_layer_zeros(l, b, jspec, hkv, hd),
          "total_len": jnp.int32(0), "dense_len": jnp.int32(0)}
    tc = cache_from_jax(jax.tree.map(np.asarray, jc), device="cpu")
    jm, tm = jmanager.zero_metrics(), tmanager.zero_metrics()
    step = jax.jit(lambda c, kv, m: jmanager.serve_tick(
        c, "gqa", jspec, policy, kv, m))
    kv = np.full((l, b, 1, hkv, hd), 0.5, ml_dtypes.bfloat16)
    for _ in range(200):
        jc, jm = step(jc, (jnp.asarray(kv), jnp.asarray(kv)), jm)
        tc, tm = tmanager.serve_tick(tc, "gqa", tspec,
                                     tpolicy.Policy.BASELINE,
                                     (to_torch(kv), to_torch(kv)), tm)
    assert float(tm["hbm_write_bytes"]) > 2 ** 24
    _assert_metrics(jm, tm, "end")
    assert tc["dense_len"] == int(jc["dense_len"])


def test_cache_from_jax_refuses_unknown_leaves():
    spec = jlayout.TierSpec(s_max=8, hot_window=8, page_tokens=4)
    jc = jax.tree.map(np.asarray, _j_cache(spec))
    got = cache_from_jax(jc, device="cpu")
    _assert_cache(jc, got, "crossed")
    # the mla tiers cross (tests/test_torch_mla.py); the encoder-decoder's
    # static cross-attention cache crosses in the layers, in its own
    # dtypes, and nowhere beside them (tests/test_torch_encdec.py); the
    # Mamba2 states cross, each in its own dtype only
    with pytest.raises(ValueError, match="xk4"):
        cache_from_jax({**jc, "layers": {**jc["layers"],
                                         "xk4": jc["layers"]["k4"]}},
                       device="cpu")
    with pytest.raises(TypeError, match="ck4"):
        cache_from_jax({**jc, "layers": {**jc["layers"],
                                         "ck4": jc["layers"]["kh"]}},
                       device="cpu")
    with pytest.raises(ValueError, match="ck4"):
        cache_from_jax({**jc, "ck4": jc["layers"]["k4"]}, device="cpu")
    with pytest.raises(TypeError, match="macro_ssm"):
        cache_from_jax({**jc, "macro_ssm": jc["layers"]["kh"]},
                       device="cpu")
