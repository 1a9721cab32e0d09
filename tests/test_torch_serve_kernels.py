"""Port vs reference: the plain versions of the serving path's attention
kernels — the tiered decode partial and the causal flash forward — and
the wrappers' CPU routing.

The reference's Pallas kernels run in interpret mode, as
tests/test_kernels.py runs them, at its parameter sets. Each tolerance
is stated where it is used.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.core.tiercache.quant import quantize_int4 as j_quant
from repro.kernels.flash_attention.kernel import flash_fwd_pallas
from repro.kernels.flash_attention.ref import flash_ref as j_flash_ref
from repro.kernels.tiered_attention.kernel import dense_tier_partial_pallas
from repro.kernels.tiered_attention.ops import (
    tiered_decode_attention as j_tiered)
from repro.kernels.tiered_attention.ref import (
    dense_tier_partial_ref as j_partial_ref)
from repro.models import attention as jattn
from repro.models import transformer as jtx
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import flash_ref as t_flash_ref
from repro_torch.kernels.tiered_attention import ops as tiered_ops
from repro_torch.kernels.tiered_attention.ref import (
    dense_tier_partial_ref as t_partial_ref, merge_splits,
    split_partials_ref)
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttx
from repro_torch.interop import model_params_from_jax
from torch_port_util import to_numpy, to_torch

J_QUANT = jax.jit(j_quant, static_argnums=1)


def _close(ref, got, tol, label):
    np.testing.assert_allclose(to_numpy(got).astype(np.float32),
                               np.asarray(ref, np.float32), rtol=tol,
                               atol=tol, err_msg=label)


def _tier(rng, b, s, hkv, g, hd, group):
    q = rng.standard_normal((b, hkv, g, hd)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, hd)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, hd)).astype(np.float32)
    k4, ksc = map(np.asarray, J_QUANT(jnp.asarray(k), group))
    v4, vsc = map(np.asarray, J_QUANT(jnp.asarray(v), group))
    return q, k4, ksc, v4, vsc


# ---------------------------------------------------------------------------
# tiered decode: the dense-tier partial
# ---------------------------------------------------------------------------

TIER_SETS = [(64, 2, 4, 32, 16, 32), (128, 1, 7, 64, 64, 64),
             (32, 4, 1, 64, 32, 32)]          # test_kernels.py's sets


@pytest.mark.parametrize("s,hkv,g,hd,group,block_t", TIER_SETS)
@pytest.mark.parametrize("fill", ["empty", "partial", "full"])
def test_dense_partial_matches_reference(s, hkv, g, hd, group, block_t,
                                         fill):
    rng = np.random.default_rng(s + hkv + g)
    q, k4, ksc, v4, vsc = _tier(rng, 2, s, hkv, g, hd, group)
    dense_len = {"empty": 0, "partial": s - s // 4 - 3, "full": s}[fill]
    ref = j_partial_ref(*map(jnp.asarray, (q, k4, ksc, v4, vsc)),
                        jnp.int32(dense_len), group)
    pal = dense_tier_partial_pallas(*map(jnp.asarray, (q, k4, ksc, v4, vsc)),
                                    jnp.int32(dense_len), group=group,
                                    block_t=block_t, interpret=True)
    got = tiered_ops.dense_tier_partial(*map(to_torch, (q, k4, ksc, v4, vsc)),
                                        dense_len, group=group)
    for r, p, t, name in zip(ref, pal, got, ("m", "l", "acc")):
        # float32 on both sides, other summation orders: 1e-5
        _close(r, t, 1e-5, f"{name} vs ref")
        # the Pallas kernel's blocked online softmax: the reference
        # test's own tolerance (test_kernels.py)
        _close(p, t, 2e-4, f"{name} vs pallas")
    if fill == "empty":
        # exactly the reference's masked form: m -1e30, l 0, acc 0
        assert torch.all(got[0] == -1e30) and torch.all(got[1] == 0)
        assert torch.all(got[2] == 0)


@pytest.mark.parametrize("fill", ["empty", "partial", "full"])
def test_tiered_decode_attention_matches_reference(fill, monkeypatch):
    rng = np.random.default_rng(7)
    b, s, w, hkv, g, hd, group = 2, 64, 16, 2, 3, 32, 16
    _, k4, ksc, v4, vsc = _tier(rng, b, s, hkv, g, hd, group)
    bf = lambda *sh: rng.standard_normal(sh).astype(jnp.bfloat16)
    lc = {"k4": k4, "k4_sc": ksc.astype(jnp.bfloat16), "v4": v4,
          "v4_sc": vsc.astype(jnp.bfloat16), "kh": bf(b, w, hkv, hd),
          "vh": bf(b, w, hkv, hd)}
    q = rng.standard_normal((b, 1, hkv * g, hd)).astype(np.float32)
    k_new, v_new = bf(b, 1, hkv, hd), bf(b, 1, hkv, hd)
    dense_len = {"empty": 0, "partial": 37, "full": s}[fill]
    total_len = dense_len + 11
    ref = j_tiered(jnp.asarray(q), {k: jnp.asarray(x) for k, x in lc.items()},
                   jnp.int32(dense_len), jnp.int32(total_len),
                   jnp.asarray(k_new), jnp.asarray(v_new), group=group,
                   use_pallas=False)
    tlc = {k: to_torch(x) for k, x in lc.items()}
    got = tiered_ops.tiered_decode_attention(
        to_torch(q), tlc, dense_len, total_len, to_torch(k_new),
        to_torch(v_new), group=group)
    _close(ref, got, 1e-5, "tiered_decode_attention")   # float32 throughout
    # the dense partial is looked up on the module at each call, so a run
    # that replaces it (chip_smoke.py's plain-version run) reaches it
    calls = []

    def plain(*args, **kwargs):
        calls.append(1)
        return t_partial_ref(*args, **kwargs)

    monkeypatch.setattr(tiered_ops, "dense_tier_partial", plain)
    again = tiered_ops.tiered_decode_attention(
        to_torch(q), tlc, dense_len, total_len, to_torch(k_new),
        to_torch(v_new), group=group)
    assert calls == [1] and torch.equal(got, again)


@pytest.mark.parametrize("fill", ["empty", "partial", "full"])
def test_bf16_form_matches_the_serving_path(fill):
    """The port's decode attention (the bf16-rounded dense tier) against
    the reference's `gqa_decode_tiered`, which dequantizes to bf16 and
    attends over the concatenated tiers, on the same tier and weights."""
    jcfg = J_ARCHS["gemma-2b"].reduced(num_layers=1)
    tcfg = T_ARCHS["gemma-2b"].reduced(num_layers=1)
    rng = np.random.default_rng(11)
    b, s, w, group = 2, 48, 16, 16
    hkv, hd, d = jcfg.num_kv_heads, jcfg.head_dim, jcfg.d_model
    jparams = jax.tree.map(np.asarray, jattn.init_attention(
        jax.random.PRNGKey(3), jcfg))
    tparams = model_params_from_jax({"layers": {"attn": jparams}},
                                    device="cpu")["layers"]["attn"]
    kv = rng.standard_normal((2, b, s, hkv, hd)).astype(np.float32) * 3
    (k4, ksc), (v4, vsc) = (map(np.asarray, J_QUANT(jnp.asarray(x), group))
                            for x in kv)
    bf = lambda *sh: rng.standard_normal(sh).astype(jnp.bfloat16)
    lc = {"k4": k4, "k4_sc": ksc.astype(jnp.bfloat16), "v4": v4,
          "v4_sc": vsc.astype(jnp.bfloat16), "kh": bf(b, w, hkv, hd),
          "vh": bf(b, w, hkv, hd)}
    x = bf(b, 1, d)
    dense_len = {"empty": 0, "partial": 29, "full": s}[fill]
    total_len = dense_len + 9
    ref, (rk, rv) = jtx.gqa_decode_tiered(
        jparams, jcfg, jnp.asarray(x), jnp.asarray([total_len], jnp.int32),
        {k: jnp.asarray(a) for k, a in lc.items()}, jnp.int32(dense_len),
        jnp.int32(total_len), group)
    got, (tk, tv) = ttx.gqa_decode_tiered(
        tparams, tcfg, to_torch(x), torch.tensor([total_len],
                                                 dtype=torch.int32),
        {k: to_torch(a) for k, a in lc.items()}, dense_len, total_len, group)
    # bf16 activations through two projections: 2e-2, the reference's own
    # bf16 tolerance (test_integration.py)
    _close(ref, got, 2e-2, "attention output")
    _close(rk, tk, 2e-2, "k_new")
    _close(rv, tv, 2e-2, "v_new")


# the CUDA kernel's split of [0, dense_len) over blocks and its merge, in
# the plain version's arithmetic: splits of 32 tokens, the last one partly
# past dense_len, and one more past it with no token at all
@pytest.mark.parametrize("dense_len", [0, 1, 31, 33, 100, 160])
@pytest.mark.parametrize("form", ["float32", "bf16"])
def test_split_partials_merge_to_the_unsplit_partial(dense_len, form):
    rng = np.random.default_rng(dense_len + 5)
    b, s, hkv, g, hd, group, split = 2, 160, 2, 4, 32, 16, 32
    q, k4, ksc, v4, vsc = _tier(rng, b, s, hkv, g, hd, group)
    deq = torch.float32 if form == "float32" else torch.bfloat16
    tier = (to_torch(q), to_torch(k4), to_torch(ksc).to(deq), to_torch(v4),
            to_torch(vsc).to(deq))
    splits = -(-dense_len // split) + 1
    parts = split_partials_ref(*tier, dense_len, split, splits, group, deq)
    assert torch.all(parts[-1][0] == -1e30) and torch.all(parts[-1][1] == 0)
    got = merge_splits(parts)
    want = t_partial_ref(*tier, dense_len, group, deq)
    for w, t, name in zip(want, got, ("m", "l", "acc")):
        # float32 on both sides, the sums split at other places: 1e-5
        _close(to_numpy(w), t, 1e-5, f"{name} vs unsplit")
    if form == "float32":
        ref = j_partial_ref(*map(jnp.asarray, (q, k4, ksc, v4, vsc)),
                            jnp.int32(dense_len), group)
        for r, t, name in zip(ref, got, ("m", "l", "acc")):
            _close(r, t, 1e-5, f"{name} vs reference")
    if dense_len == 0:
        # the empty tier's identity survives the merge exactly
        assert torch.all(got[0] == -1e30) and torch.all(got[1] == 0)
        assert torch.all(got[2] == 0)


@pytest.mark.parametrize("dense_len,b,hkv,g", [
    (0, 4, 1, 8), (1, 4, 1, 8), (1000, 4, 1, 8), (2048, 4, 1, 8),
    (3200, 4, 1, 8), (2048, 4, 32, 1), (1536, 4, 32, 1), (100000, 1, 1, 3)])
def test_split_plan_covers_the_tier_and_fills_the_card(dense_len, b, hkv, g):
    tokens, splits = tiered_ops.split_plan(dense_len, b, hkv, g)
    assert tokens % (128 if g == 1 else 32) == 0
    assert 1 <= splits <= tiered_ops.MAX_SPLITS
    # every token in exactly one split, none past dense_len but the last's
    assert (splits - 1) * tokens < max(dense_len, 1) <= splits * tokens
    if dense_len >= 1000 and b * hkv <= 4:
        # gemma-2b's shape: more blocks than (batch, KV head) pairs
        assert b * hkv * splits >= 32
    if (dense_len, b, hkv, g) == (2048, 4, 1, 8):
        assert (tokens, splits) == (32, 64)
    if (dense_len, b, hkv, g) == (2048, 4, 32, 1):
        assert (tokens, splits) == (256, 8)


# ---------------------------------------------------------------------------
# flash forward
# ---------------------------------------------------------------------------

FLASH_SETS = [(64, 2, 3, 32, 16, 16), (32, 1, 4, 64, 32, 8),
              (48, 4, 1, 16, 16, 24)]        # test_kernels.py's sets


@pytest.mark.parametrize("s,hkv,g,hd,bq,bk", FLASH_SETS)
def test_flash_ref_matches_reference(s, hkv, g, hd, bq, bk):
    rng = np.random.default_rng(s + hd)
    b = 2
    q = rng.standard_normal((b, s, hkv * g, hd)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, hd)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, hd)).astype(np.float32)
    o_r, lse_r = j_flash_ref(*map(jnp.asarray, (q, k, v)), chunk=bk)
    o_p, lse_p = flash_fwd_pallas(*map(jnp.asarray, (q, k, v)), bq=bq, bk=bk,
                                  interpret=True)
    o_t, lse_t = flash_ops.flash_fwd(*map(to_torch, (q, k, v)), chunk=bk)
    # float32 on every side, other summation orders: 2e-5, the reference
    # test's tolerance
    for ref, label in ((o_r, "ref"), (o_p, "pallas")):
        _close(ref, o_t, 2e-5, f"out vs {label}")
    for ref, label in ((lse_r, "ref"), (lse_p, "pallas")):
        _close(ref, lse_t, 2e-5, f"lse vs {label}")


def _bf16_terms(p, terms):
    """p (float32) as `flash_fwd.cu` splits it for its second product:
    t1 = bf16(p), t2 = bf16(p - t1), ..., each difference in float32."""
    out, rest = [], p
    for _ in range(terms):
        t = rest.bfloat16().float()
        out.append(t)
        rest = rest - t
    return out


def _flash_p_terms(q, k, v, terms):
    """The causal softmax attention as `flash_fwd.cu`'s bf16 form sums it:
    scores and P in float32, l over P, and P reaching the bf16 V as
    `terms` bf16 terms (None: float32 P, the plain version's), their
    products summed in float32. Returns (B, H, S, hd) float32."""
    b, s, h, hd = q.shape
    g = h // k.shape[2]
    ke = k.float().repeat_interleave(g, dim=2)
    ve = v.float().repeat_interleave(g, dim=2)
    sc = torch.einsum("bqhd,bkhd->bhqk", q.float() / hd ** 0.5, ke)
    pos = torch.arange(s)
    sc = torch.where(pos[None, :] <= pos[:, None], sc, float("-inf"))
    p = torch.exp(sc - sc.amax(-1, keepdim=True))
    pv = p if terms is None else sum(_bf16_terms(p, terms))
    return torch.einsum("bhqk,bkhd->bhqd", pv, ve) / p.sum(-1)[..., None]


def test_three_bf16_terms_sum_to_p_exactly():
    """P in [2^-100, 1] (exp2 of a non-positive score; a row's largest P
    is 1): three bf16 terms, each difference exact in float32, sum back
    to P bit for bit; two do not. Below some 2^-110 the last term falls
    under bf16's subnormals and P loses at most 2^-133, nothing beside
    the row's 1."""
    gen = torch.Generator().manual_seed(7)
    p = torch.exp2(-100.0 * torch.rand(1 << 16, generator=gen))
    p = torch.cat([p, torch.tensor([1.0, 0.5, 2.0 ** -100, 0.9999999])])
    three = _bf16_terms(p, 3)
    assert torch.equal(three[0] + three[1] + three[2], p)
    two = _bf16_terms(p, 2)
    assert not torch.equal(two[0] + two[1], p)
    tiny = torch.exp2(-126.0 * torch.rand(1 << 12, generator=gen))
    three = _bf16_terms(tiny, 3)
    assert float((three[0] + three[1] + three[2] - tiny).abs().max()) \
        <= 2.0 ** -133


# flash at llava-next-34b's heads (G 7, hd 128), gemma-2b's (G 8, hd 256)
# and whisper-tiny's (G 1, hd 64)
P_TERM_SHAPES = [(256, 14, 2, 128), (512, 8, 1, 256), (333, 6, 6, 64)]


def _p_term_errors(s, h, hkv, hd):
    gen = torch.Generator().manual_seed(s + hd)
    q, k, v = (torch.randn((2, s, n, hd), generator=gen).bfloat16()
               for n in (h, hkv, hkv))
    want, _ = t_flash_ref(q, k, v, chunk=64)
    scale = float(want.abs().max())
    return {terms: float((_flash_p_terms(q, k, v, terms) - want).abs().max())
            / scale for terms in (None, 1, 2, 3)}


@pytest.mark.parametrize("s,h,hkv,hd", P_TERM_SHAPES)
def test_flash_p_in_three_bf16_terms_is_float32_p(s, h, hkv, hd):
    """`flash_fwd.cu` hands P to its second product as three bf16 terms:
    the same error against the plain version as float32 P (the plain
    version's own, another summation order), some 2e-7 of max |output|
    on bf16 inputs."""
    err = _p_term_errors(s, h, hkv, hd)
    assert err[3] == err[None] <= 1e-6, err


@pytest.mark.parametrize("s,h,hkv,hd", P_TERM_SHAPES)
def test_flash_p_in_fewer_bf16_terms_misses_float32_p(s, h, hkv, hd):
    """One bf16 term (as the kernel rounded P before) is some 1e-3 of max
    |output| off, two terms some 2e-6: both over four times float32 P's
    error. One term put llava-next-34b's logits at 48 and 60 layers
    1.3-1.5x further from the plain version's than the plain version's
    own floor, two terms still 1.2-1.32x (PERF.md §6)."""
    err = _p_term_errors(s, h, hkv, hd)
    assert err[1] > err[2] > 4 * err[None], err


@pytest.mark.parametrize("s", [37, 100])
def test_flash_takes_a_ragged_length(s):
    """A length that is no multiple of the chunk, which the Pallas kernel
    refuses: the port pads and masks it, and agrees with its own
    attend_chunked (float32: 2e-5)."""
    rng = np.random.default_rng(s)
    b, hkv, g, hd = 2, 2, 2, 32
    q, k, v = (to_torch(rng.standard_normal((b, s, h, hd)).astype(np.float32))
               for h in (hkv * g, hkv, hkv))
    out, lse = flash_ops.flash_attention_fwd(q, k, v, chunk=16)
    pos = torch.arange(s, dtype=torch.int32)
    want = tattn.attend_chunked(q, k, v, q_positions=pos, kv_positions=pos,
                                causal=True, chunk=16)
    _close(to_numpy(want), out, 2e-5, "ragged out")
    assert out.shape == (b, s, hkv * g, hd) and torch.isfinite(lse).all()
    # the same through the reference, which pads the same way
    ref = jattn.attend_chunked(*map(jnp.asarray, (to_numpy(q), to_numpy(k),
                                                  to_numpy(v))),
                               q_positions=jnp.arange(s),
                               kv_positions=jnp.arange(s), causal=True,
                               chunk=16)
    _close(ref, out, 2e-5, "ragged out vs reference attend_chunked")


def test_prefill_attention_matches_reference_bf16():
    """`attend_chunked` on the prefill's iota positions (the flash path)
    against the reference's, in bf16 (2e-2)."""
    rng = np.random.default_rng(5)
    b, s, hkv, g, hd = 2, 40, 1, 4, 32
    q, k, v = (rng.standard_normal((b, s, h, hd)).astype(jnp.bfloat16)
               for h in (hkv * g, hkv, hkv))
    pos = np.arange(s, dtype=np.int32)
    ref = jattn.attend_chunked(*map(jnp.asarray, (q, k, v)),
                               q_positions=jnp.asarray(pos),
                               kv_positions=jnp.asarray(pos), causal=True,
                               chunk=16)
    got = tattn.attend_chunked(*map(to_torch, (q, k, v)),
                               q_positions=to_torch(pos),
                               kv_positions=to_torch(pos), causal=True,
                               chunk=16, iota=True)
    assert got.dtype == torch.bfloat16
    _close(ref, got, 2e-2, "prefill attention")


def test_cpu_tensors_take_the_plain_versions():
    """On the CPU each wrapper returns its plain version's result and
    counts no launch."""
    rng = np.random.default_rng(2)
    flash_ops.reset()
    tiered_ops.reset()
    q, k, v = (to_torch(rng.standard_normal((1, 24, h, 16))
                        .astype(np.float32)) for h in (2, 1, 1))
    out, lse = flash_ops.flash_fwd(q, k, v, chunk=8)
    o2, l2 = t_flash_ref(q, k, v, chunk=8)
    assert torch.equal(out, o2) and torch.equal(lse, l2)
    tq, k4, ksc, v4, vsc = map(to_torch, _tier(rng, 1, 32, 1, 2, 32, 16))
    got = tiered_ops.dense_tier_partial(tq, k4, ksc, v4, vsc, 20, group=16)
    want = t_partial_ref(tq, k4, ksc, v4, vsc, 20, 16)
    assert all(torch.equal(a, b_) for a, b_ in zip(got, want))
    assert flash_ops.LAUNCHER.launches == 0
    assert tiered_ops.LAUNCHER.launches == 0
