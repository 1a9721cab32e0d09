"""Port vs reference: Multi-head Latent Attention
(`repro_torch/models/mla.py`), its latent tier (the `mla` cache kind of
`core/tiercache`), the plain version of the latent form of the tiered
decode kernel, and deepseek-v2-lite-16b reduced served end to end.

The reference's weights and caches cross by `interop`; inputs are made
with numpy from a seed; the reference runs compiled (`jax.jit`), as its
serving path does. Tolerances: float32 parameters at 1e-5 (summation
order), bf16 at 2e-2 (bf16 activations, the serving tests' tolerance);
the tier's buffers, watermarks and five metrics exactly. The served
model is held as tests/test_torch_serve.py holds gemma-2b, with its MoE
routes teacher-forced as tests/test_torch_moe.py explains.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.core.tiercache import layout as jlayout
from repro.core.tiercache import manager as jmanager
from repro.core.tiercache.policy import Policy as JPolicy
from repro.core.tiercache.quant import dequantize_int4 as j_dequant
from repro.models import mla as j_mla
from repro.models import moe as j_moe
from repro.models.model_zoo import build_model as j_build
from repro.models.model_zoo import make_train_batch as j_batch
from repro.serve.engine import make_serve_step as j_serve_step
from repro.serve.engine import make_tier_spec as j_tier_spec
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.core.tiercache import layout as tlayout
from repro_torch.core.tiercache import manager as tmanager
from repro_torch.core.tiercache.policy import Policy as TPolicy
from repro_torch.core.tiercache.quant import dequantize_int4 as t_dequant
from repro_torch.interop import cache_from_jax, model_params_from_jax
from repro_torch.kernels.tiered_attention import ops as tiered
from repro_torch.kernels.tiered_attention import ref as tiered_ref
from repro_torch.launch import serve as t_launch
from repro_torch.models import mla as t_mla
from repro_torch.models import moe as t_moe
from repro_torch.models.model_zoo import build_model as t_build
from repro_torch.models.model_zoo import make_train_batch as t_batch
from repro_torch.serve.engine import decode_loop as t_decode_loop
from repro_torch.serve.engine import make_serve_step as t_serve_step
from repro_torch.serve.engine import make_tier_spec as t_tier_spec
from torch_port_util import (assert_leaf_equal, recorded_routes,
                             replayed_routes, to_torch)

NAME = "deepseek-v2-lite-16b"
J_CFG, T_CFG = J_ARCHS[NAME].reduced(), T_ARCHS[NAME].reduced()
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
B, S = 2, 24
R = J_CFG.mla.kv_lora_rank
P = J_CFG.mla.qk_rope_head_dim
SCALE = 1.0 / ((J_CFG.mla.qk_nope_head_dim + P) ** 0.5)


def _np(dtype):
    return ml_dtypes.bfloat16 if dtype == jnp.bfloat16 else np.float32


def _params(dtype, seed=0):
    jp = j_mla.init_mla(jax.random.PRNGKey(seed), J_CFG, dtype=dtype)
    # a non-zero latent norm weight, so that it is exercised
    jp = dict(jp, kv_norm=(0.1 * jax.random.normal(
        jax.random.PRNGKey(seed + 1), jp["kv_norm"].shape)).astype(dtype))
    tp = model_params_from_jax(
        {"layers": {"attn": jax.tree.map(np.asarray, jp)}},
        device="cpu")["layers"]["attn"]
    return jp, tp


def _normal(rng, shape, dtype_np, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32).astype(
        dtype_np)


def _close(got, want, tol, label):
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=label)


# ---------------------------------------------------------------------------
# the layer: projection, prefill, absorbed decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_latent_project_matches(dtype):
    jdt, tdt, tol = DTYPES[dtype]
    jp, tp = _params(jdt)
    x = _normal(np.random.default_rng(1), (B, S, J_CFG.d_model), _np(jdt))
    pos = np.arange(S, dtype=np.int32)
    jc, jk = jax.jit(lambda p, x, pos: j_mla.latent_project(
        p, J_CFG, x, pos))(jp, jnp.asarray(x), jnp.asarray(pos))
    tc, tk = t_mla.latent_project(tp, T_CFG, to_torch(x), to_torch(pos))
    assert tc.dtype == tdt and tc.shape == (B, S, R)
    assert tk.shape == (B, S, P)
    _close(tc, jc, tol, "c_kv")
    _close(tk, jk, tol, "k_rope")


@pytest.mark.parametrize("chunk", [8, 512])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_apply_mla_prefill_matches(dtype, chunk):
    """The prefill: per-head K (192 = 128 + 64 wide at full size) and V
    from the latent, causal attention (on the CPU the flash kernel's
    plain version, with the reference's scale 1/sqrt(qk) and a v width
    of its own)."""
    jdt, _, tol = DTYPES[dtype]
    jp, tp = _params(jdt)
    x = _normal(np.random.default_rng(2), (B, S, J_CFG.d_model), _np(jdt))
    pos = np.arange(S, dtype=np.int32)
    jy, (jc, jk) = jax.jit(lambda p, x, pos: j_mla.apply_mla(
        p, J_CFG, x, pos, chunk=chunk))(jp, jnp.asarray(x), jnp.asarray(pos))
    ty, (tc, tk) = t_mla.apply_mla(tp, T_CFG, to_torch(x), to_torch(pos),
                                   chunk=chunk)
    assert ty.shape == (B, S, J_CFG.d_model)
    _close(ty, jy, tol, "y")
    _close(tc, jc, tol, "c_kv")
    _close(tk, jk, tol, "k_rope")


def _tier(spec, prompt, seed, layers=1):
    """A reference `mla` tier filled (compiled) by a prompt of random
    latents, and the port's copy of it."""
    rng = np.random.default_rng(seed)
    c = _normal(rng, (layers, B, prompt, R), ml_dtypes.bfloat16)
    kr = _normal(rng, (layers, B, prompt, P), ml_dtypes.bfloat16)

    def fill(c, kr):
        lay = jlayout.mla_layer_zeros(layers, B, spec, R, P)
        lay, w0 = jlayout.fill_quant_channel(lay, "c4", "c4_sc", "ch", c,
                                             spec)
        lay, _ = jlayout.fill_raw_channel(lay, "krope", kr, spec)
        return lay

    lay = jax.jit(fill)(jnp.asarray(c), jnp.asarray(kr))
    w0, _ = jlayout.split_for_prefill(prompt, spec)
    jc = {"layers": lay, "dense_len": jnp.int32(w0),
          "total_len": jnp.int32(prompt)}
    return jc, cache_from_jax(jax.tree.map(np.asarray, jc), device="cpu")


def _spec(j=True, **kw):
    kw = {"s_max": 64, "hot_window": 16, "page_tokens": 8, "group": 16,
          **kw}
    return (jlayout if j else tlayout).TierSpec(**kw)


@jax.jit
def _j_decode(jp, x, lay, dense_len, total_len):
    """The reference's MLA decode as its `lm_decode_step` runs it
    (transformer.py:250-259): the tier dequantized to bf16, the hot tail
    beside it, the validity mask."""
    lc = jax.tree.map(lambda a: a[0], lay)
    c_dense = j_dequant(lc["c4"], lc["c4_sc"], 16)
    c_all = jnp.concatenate([c_dense, lc["ch"]], axis=1)
    sd, w = c_dense.shape[1], lc["ch"].shape[1]
    valid = jnp.concatenate([jnp.arange(sd) < dense_len,
                             dense_len + jnp.arange(w) < total_len], 0)
    return j_mla.apply_mla_decode(jp, J_CFG, x, total_len[None], c_all,
                                  lc["krope"], valid)


@pytest.mark.parametrize("prompt", [5, 24, 40])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_apply_mla_decode_matches(dtype, prompt):
    """The absorbed decode over the tier (prompt 5: all hot; 24 and 40:
    a dense tier and a hot tail): the port's latent partial of the int4
    tier merged with the hot tail's and the current token's, against the
    reference's softmax over the dequantized view."""
    jdt, tdt, tol = DTYPES[dtype]
    jp, tp = _params(jdt)
    jc, tc = _tier(_spec(), prompt, seed=prompt)
    x = _normal(np.random.default_rng(3), (B, 1, J_CFG.d_model), _np(jdt))
    jy, (jcn, jkn) = _j_decode(jp, jnp.asarray(x), jc["layers"],
                               jc["dense_len"], jc["total_len"])
    lc = {k: v[0] for k, v in tc["layers"].items()}
    pos = torch.full((1,), tc["total_len"], dtype=torch.int32)
    ty, (tcn, tkn) = t_mla.apply_mla_decode(
        tp, T_CFG, to_torch(x), pos, lc, tc["dense_len"], tc["total_len"],
        16)
    assert ty.dtype == tdt and ty.shape == (B, 1, J_CFG.d_model)
    _close(ty, jy, tol, "y")
    _close(tcn, jcn, tol, "c_new")
    _close(tkn, jkn, tol, "k_rope_new")


@pytest.mark.parametrize("prompt", [0, 24, 40])
def test_latent_partials_merge_to_the_reference_attention(prompt):
    """`latent_tier_partial_ref` over the int4 tier, merged with the hot
    tail's and the current token's partials, against the reference's
    absorbed softmax (mla.py:91-100) over the dequantized view, in
    float32 at 1e-5."""
    jc, tc = _tier(_spec(), max(prompt, 1), seed=prompt + 7)
    dense_len = int(jc["dense_len"]) if prompt else 0
    total_len = int(jc["total_len"])
    rng = np.random.default_rng(prompt)
    h = J_CFG.num_heads
    q_lat = _normal(rng, (B, h, R), ml_dtypes.bfloat16).astype(np.float32)
    q_rope = _normal(rng, (B, h, P), ml_dtypes.bfloat16).astype(np.float32)
    c_new = _normal(rng, (B, 1, R), ml_dtypes.bfloat16)
    kr_new = _normal(rng, (B, 1, P), ml_dtypes.bfloat16)
    lc = {k: v[0] for k, v in tc["layers"].items()}
    got = tiered.latent_decode_attention(
        to_torch(q_lat), to_torch(q_rope), lc, dense_len, total_len,
        to_torch(c_new), to_torch(kr_new), group=16, scale=SCALE)

    @jax.jit
    def want(lay, q_lat, q_rope, c_new, kr_new):
        lc = jax.tree.map(lambda a: a[0], lay)
        c_dense = j_dequant(lc["c4"], lc["c4_sc"], 16)
        sd, w = c_dense.shape[1], lc["ch"].shape[1]
        c_all = jnp.concatenate([c_dense, lc["ch"], c_new],
                                axis=1).astype(jnp.float32)
        k_all = jnp.concatenate([lc["krope"], kr_new],
                                axis=1).astype(jnp.float32)
        valid = jnp.concatenate([jnp.arange(sd) < dense_len,
                                 dense_len + jnp.arange(w) < total_len,
                                 jnp.ones((1,), bool)])
        s = (jnp.einsum("bhr,btr->bht", q_lat, c_all)
             + jnp.einsum("bhp,btp->bht", q_rope, k_all)) * SCALE
        s = jnp.where(valid[None, None], s, -1e30)
        return jnp.einsum("bht,btr->bhr", jax.nn.softmax(s, -1), c_all)

    ref = want(jc["layers"], jnp.asarray(q_lat), jnp.asarray(q_rope),
               jnp.asarray(c_new), jnp.asarray(kr_new))
    _close(got, ref, 1e-5, "ctx")


def test_latent_tier_partial_ref_contract():
    """The plain version: an empty tier gives (-1e30, 0, 0); the tokens
    past dense_len and the hot rows of krope are not read; its split
    into the kernel's plan merges back to the whole."""
    spec = _spec(j=False)
    rng = np.random.default_rng(11)
    h, s_dense = J_CFG.num_heads, spec.s_dense
    c4 = to_torch(rng.integers(0, 256, (B, s_dense, R // 2), dtype=np.uint8))
    sc = to_torch(_normal(rng, (B, s_dense, R // 16), ml_dtypes.bfloat16,
                          0.1))
    kr = to_torch(_normal(rng, (B, s_dense + spec.hot_window, P),
                          ml_dtypes.bfloat16))
    q_lat = torch.randn((B, h, R), generator=torch.Generator().manual_seed(0))
    q_rope = torch.randn((B, h, P), generator=torch.Generator().manual_seed(1))
    m, l, acc = tiered_ref.latent_tier_partial_ref(q_lat, q_rope, c4, sc, kr,
                                                   0, 16, SCALE)
    assert bool((m == -1e30).all()) and bool((l == 0).all())
    assert bool((acc == 0).all())
    dense_len = 37
    whole = tiered_ref.latent_tier_partial_ref(q_lat, q_rope, c4, sc, kr,
                                               dense_len, 16, SCALE)
    c4b, scb, krb = c4.clone(), sc.clone(), kr.clone()
    c4b[:, dense_len:] = 0x77
    scb[:, dense_len:] = 1e3
    krb[:, dense_len:] = 1e3
    again = tiered_ref.latent_tier_partial_ref(q_lat, q_rope, c4b, scb, krb,
                                               dense_len, 16, SCALE)
    for a, b_ in zip(whole, again):
        assert torch.equal(a, b_)
    tokens, splits = tiered.latent_split_plan(dense_len, B)
    parts = []
    for i in range(splits):
        end = min((i + 1) * tokens, dense_len)
        sl = slice(i * tokens, end)
        parts.append(tiered_ref.latent_tier_partial_ref(
            q_lat, q_rope, c4[:, sl], sc[:, sl], kr[:, sl], end - i * tokens,
            16, SCALE))
    merged = tiered_ref.merge_splits(parts)
    for a, b_ in zip(merged, whole):
        torch.testing.assert_close(a, b_, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dense_len,b", [(0, 4), (1, 1), (255, 4),
                                         (1536, 4), (2048, 4), (2048, 1),
                                         (40000, 4)])
def test_latent_split_plan(dense_len, b):
    """Tokens a block: whole 64-token tiles; splits cover [0, dense_len)
    with none empty (one, empty, at 0), at most MAX_SPLITS, as the C entry
    requires (else it returns -7); at deepseek's decode (B 4, dense_len
    2048) one tile a block: 128 blocks, one on each of 128 of the 132
    SMs."""
    tokens, splits = tiered.latent_split_plan(dense_len, b)
    assert tokens % tiered.LATENT_TILE == 0 and tokens >= tiered.LATENT_TILE
    assert 1 <= splits <= tiered.MAX_SPLITS
    if dense_len:
        assert (splits - 1) * tokens < dense_len <= splits * tokens
    else:
        assert splits == 1
    if (dense_len, b) == (2048, 4):
        assert (tokens, splits) == (64, 32)


def _latent_args(b=1, h=4, r=128, p=32, s=40, s_raw=48, group=32):
    return (torch.zeros((b, h, r)), torch.zeros((b, h, p)),
            torch.zeros((b, s, r // 2), dtype=torch.uint8),
            torch.zeros((b, s, r // group), dtype=torch.bfloat16),
            torch.zeros((b, s_raw, p), dtype=torch.bfloat16))


@pytest.mark.parametrize("kw,dense_len,group,match", [
    ({"h": 0}, 8, 32, "heads"), ({"h": 17}, 8, 32, "heads"),
    ({"r": 80, "group": 16}, 8, 32, "rank"),
    ({"r": 576, "group": 64}, 8, 64, "rank"),
    ({"p": 48}, 8, 32, "rope dim"),
    ({"group": 2}, 8, 3, "group"), ({"group": 64}, 8, 6, "group"),
    ({}, 41, 32, "dense_len"), ({"s_raw": 39}, 8, 32, "krope shorter"),
    ({"b": 65536, "s": 1, "s_raw": 1, "h": 1}, 1, 32, "batch"),
    ({"r": 16, "group": 16}, 8, 16, "rank")])
def test_latent_check_refuses_what_the_kernel_does_not_take(kw, dense_len,
                                                            group, match):
    """The wrapper's checks before a launch, mirroring the C entry's
    return codes: heads outside 1..16 (-2), a rank that is not a multiple
    of 32 up to 512 or a RoPE width other than 16, 32, 64 (-3), an odd
    group or one that does not divide the rank (-4), dense_len past the
    tier or a RoPE key shorter than it (-5), more than 65535 batch rows
    (-6); and a tensor of another dtype."""
    args = _latent_args(**kw)
    with pytest.raises(ValueError, match=match):
        tiered.latent_check(*args, dense_len, group)
    args = _latent_args()
    tiered.latent_check(*args, 40, 32)
    with pytest.raises(TypeError, match="c4_sc"):
        tiered.latent_check(*args[:3], args[3].float(), args[4], 40, 32)


def _latent_kernel_emulation(q_lat, q_rope, c4, c4_sc, krope, dense_len,
                             group, scale, q_terms=3, p_terms=2):
    """`csrc/latent_decode.cu`'s arithmetic in torch: the wrapper's split
    plan, tiles of 64 tokens, C exact in bf16, q in `q_terms` bf16 terms
    (the kernel: q_hi, q_lo and q_lo2), the float32 p of each tile's online
    softmax in `p_terms` bf16 terms (the kernel: p_hi and p_lo), every
    product summed in float32; then the merge of the splits in order."""
    def terms(x, n):
        out, rest = [], x
        for _ in range(n):
            t = rest.to(torch.bfloat16).to(torch.float32)
            out.append(t)
            rest = rest - t
        return out
    b, h, r = q_lat.shape
    c = t_dequant(c4, c4_sc, group, torch.bfloat16).float()
    kr = krope.float()
    qs = terms(q_lat, q_terms)
    qr = terms(q_rope, q_terms)
    tokens, splits = tiered.latent_split_plan(dense_len, b)
    parts = []
    for i in range(splits):
        m = torch.full((b, h), -1e30)
        l = torch.zeros((b, h))
        acc = torch.zeros((b, h, r))
        end = min((i + 1) * tokens, dense_len)
        for t0 in range(i * tokens, end, tiered.LATENT_TILE):
            sl = slice(t0, min(t0 + tiered.LATENT_TILE, end))
            s = sum(torch.einsum("bhr,btr->bht", q, c[:, sl]) for q in qs)
            s = s + sum(torch.einsum("bhp,btp->bht", q, kr[:, sl])
                        for q in qr)
            s = s * scale
            m_new = torch.maximum(m, s.amax(-1))
            corr = torch.exp(m - m_new)
            pr = torch.exp(s - m_new[..., None])
            l = l * corr + pr.sum(-1)
            acc = acc * corr[..., None] + sum(
                torch.einsum("bht,btr->bhr", pt, c[:, sl])
                for pt in terms(pr, p_terms))
            m = m_new
        parts.append((m, l, acc))
    return tiered_ref.merge_splits(parts)


def _deepseek_latent_inputs(exact_q: bool, seed=7):
    """deepseek-v2-lite's decode (B 4, H 16, r 512, p 64, group 64) over
    a 2048-token latent tier, from numpy: the latent quantized as the
    tier quantizes it; q bf16-exact (as the serving path forms it) or
    float32 that is not."""
    from repro_torch.kernels.ips_repack.ref import quantize_rows_ref
    rng = np.random.default_rng(seed)
    b, s, h, r, p = 4, 2048, 16, 512, 64
    c4, sc = quantize_rows_ref(torch.from_numpy(
        2.0 * rng.standard_normal((b * s, r)).astype(np.float32)), 64)
    q = [torch.from_numpy(rng.standard_normal((b, h, n)).astype(np.float32))
         for n in (r, p)]
    if exact_q:
        q = [x.to(torch.bfloat16).float() for x in q]
    kr = to_torch(_normal(rng, (b, s, p), ml_dtypes.bfloat16))
    return (*q, c4.reshape(b, s, r // 2),
            sc.reshape(b, s, r // 64).to(torch.bfloat16), kr)


def _latent_err(got, want):
    return max(float((a - w).abs().max()) / float(w.abs().max())
               for a, w in zip(got, want))


LATENT_TOL = 2e-5               # of max |output|, as chip_smoke.py holds it


@pytest.mark.parametrize("exact_q", [True, False], ids=["q_bf16", "q_f32"])
def test_latent_kernel_arithmetic_meets_the_bar(exact_q):
    """The kernel's split arithmetic (three bf16 terms of q, two of p, C
    exact in bf16, float32 sums) within 2e-5 of max |output| of
    `latent_tier_partial_ref` at deepseek's shape, for the served q
    (bf16-exact: q_lo is 0) and a float32 q that is not."""
    args = _deepseek_latent_inputs(exact_q)
    scale = 1.0 / 192 ** 0.5
    want = tiered_ref.latent_tier_partial_ref(*args, 2048, 64, scale)
    got = _latent_kernel_emulation(*args, 2048, 64, scale)
    assert _latent_err(got, want) <= LATENT_TOL


@pytest.mark.parametrize("terms", ["p", "q"])
def test_latent_one_bf16_term_misses_the_bar(terms):
    """Why the kernel carries more terms: p in one bf16 term (2^-9 of
    itself), or a float32 q in one, misses 2e-5 of max |output| at
    deepseek's shape."""
    args = _deepseek_latent_inputs(exact_q=False)
    scale = 1.0 / 192 ** 0.5
    want = tiered_ref.latent_tier_partial_ref(*args, 2048, 64, scale)
    got = _latent_kernel_emulation(*args, 2048, 64, scale,
                                   p_terms=1 if terms == "p" else 2,
                                   q_terms=1 if terms == "q" else 3)
    assert _latent_err(got, want) > LATENT_TOL


def test_served_latent_queries_are_bf16_exact(deepseek, monkeypatch):
    """The serving path hands the latent kernel bf16 values in its
    float32 q_lat and q_rope (MLA forms them by bf16 einsums and RoPE),
    so the kernel's q_lo products are skipped: every decode step of the
    reduced deepseek, every layer."""
    _, _, tparams, tokens = deepseek
    tb = t_build(T_CFG, device="cpu")
    spec = t_tier_spec(tb, 128, TPolicy.IPS, hot_window=16, page_tokens=8,
                       group=16)
    seen = []
    inner = t_mla.latent_decode_attention

    def spy(q_lat, q_rope, *args, **kw):
        for q in (q_lat, q_rope):
            assert q.dtype == torch.float32
            seen.append(torch.equal(q, q.to(torch.bfloat16).float()))
        return inner(q_lat, q_rope, *args, **kw)
    monkeypatch.setattr(t_mla, "latent_decode_attention", spy)
    cache, logits = tb.prefill(tparams, {"tokens": to_torch(tokens)}, spec)
    first = torch.argmax(logits, -1).to(torch.int32)[:, None]
    t_decode_loop(tb, tparams, cache, first, 4, spec, TPolicy.IPS)
    assert len(seen) == 2 * T_CFG.num_layers * 4 and all(seen)


def test_latent_wrapper_takes_the_plain_version_on_the_cpu():
    """On CPU tensors the wrapper is its plain version and launches
    nothing; the contract's checks belong to the card (test_torch_cuda)."""
    spec = _spec(j=False)
    _, tc = _tier(_spec(), 24, seed=5)
    lc = {k: v[0] for k, v in tc["layers"].items()}
    h = T_CFG.num_heads
    q_lat = torch.randn((B, h, R), generator=torch.Generator().manual_seed(2))
    q_rope = torch.randn((B, h, P), generator=torch.Generator().manual_seed(3))
    tiered.reset()
    got = tiered.latent_tier_partial(q_lat, q_rope, lc["c4"], lc["c4_sc"],
                                     lc["krope"], tc["dense_len"], group=16,
                                     scale=SCALE)
    want = tiered_ref.latent_tier_partial_ref(
        q_lat, q_rope, lc["c4"], lc["c4_sc"], lc["krope"], tc["dense_len"],
        16, SCALE)
    for a, b_ in zip(got, want):
        assert torch.equal(a, b_)
    assert tiered.LATENT_LAUNCHER.launches == 0
    assert lc["krope"].shape[1] == spec.s_dense + spec.hot_window


# ---------------------------------------------------------------------------
# the `mla` tier: layout, fill, repack, ticks — exact
# ---------------------------------------------------------------------------


def test_mla_layer_zeros_and_fills_are_the_reference_s():
    jspec, tspec = _spec(), _spec(j=False)
    jz = jax.tree.map(np.asarray, jlayout.mla_layer_zeros(3, B, jspec, R, P))
    tz = tlayout.mla_layer_zeros(3, B, tspec, R, P, device="cpu")
    assert sorted(jz) == sorted(tz)
    for k, leaf in jz.items():
        assert_leaf_equal(leaf, tz[k], k)
    assert tlayout.QUANT_CHANNELS["mla"] == jlayout.QUANT_CHANNELS["mla"]
    assert tlayout.RAW_CHANNELS["mla"] == jlayout.RAW_CHANNELS["mla"]
    for prompt in (5, 16, 24, 40):
        jc, _ = _tier(jspec, prompt, seed=prompt, layers=3)
        rng = np.random.default_rng(prompt)
        c = _normal(rng, (3, B, prompt, R), ml_dtypes.bfloat16)
        kr = _normal(rng, (3, B, prompt, P), ml_dtypes.bfloat16)
        lay = tlayout.mla_layer_zeros(3, B, tspec, R, P, device="cpu")
        lay, w0 = tlayout.fill_quant_channels(
            lay, tlayout.QUANT_CHANNELS["mla"], (to_torch(c),), tspec)
        lay, w1 = tlayout.fill_raw_channel(lay, "krope", to_torch(kr), tspec)
        assert w0 == w1 == int(jc["dense_len"])
        for k, leaf in jax.tree.map(np.asarray, jc["layers"]).items():
            assert_leaf_equal(leaf, lay[k], f"prompt {prompt}: {k}")


@pytest.mark.parametrize("staging", [False, True])
def test_mla_repack_pages_is_the_reference_s(staging):
    jspec, tspec = _spec(), _spec(j=False)
    jc, tc = _tier(jspec, 24, seed=9, layers=2)
    jl, jrb, jwb = jax.jit(lambda lay: jmanager.repack_pages(
        lay, "mla", jspec, jnp.int32(8), 1, staging))(jc["layers"])
    tl, trb, twb = tmanager.repack_pages(tc["layers"], "mla", tspec, 8, 1,
                                         staging)
    assert (trb, twb) == (float(jrb), float(jwb))
    for k, leaf in jax.tree.map(np.asarray, jl).items():
        assert_leaf_equal(leaf, tl[k], k)


@pytest.mark.parametrize("policy", list(JPolicy), ids=lambda p: p.name)
def test_mla_serve_tick_is_the_reference_s(policy):
    """60 ticks of the manager on the `mla` kind: every buffer (c4,
    c4_sc, ch, krope), both watermarks and the five metrics equal the
    compiled reference's, bit for bit."""
    jspec, tspec = _spec(hot_window=16, page_tokens=4), _spec(
        j=False, hot_window=16, page_tokens=4)
    tpol = TPolicy(int(policy))
    rng = np.random.default_rng(int(policy) + 20)
    news = [(_normal(rng, (2, B, 1, R), ml_dtypes.bfloat16, 3.0),
             _normal(rng, (2, B, 1, P), ml_dtypes.bfloat16))
            for _ in range(60)]
    step = jax.jit(lambda c, kv, m: jmanager.serve_tick(
        c, "mla", jspec, policy, kv, m))
    jc = {"layers": jlayout.mla_layer_zeros(2, B, jspec, R, P),
          "dense_len": jnp.int32(0), "total_len": jnp.int32(0)}
    tc = cache_from_jax(jax.tree.map(np.asarray, jc), device="cpu")
    jm, tm = jmanager.zero_metrics(), tmanager.zero_metrics()
    repacks = 0
    for i, (c, kr) in enumerate(news):
        before = tc["dense_len"]
        jc, jm = step(jc, (jnp.asarray(c), jnp.asarray(kr)), jm)
        tc, tm = tmanager.serve_tick(tc, "mla", tspec, tpol,
                                     (to_torch(c), to_torch(kr)), tm)
        repacks += tc["dense_len"] > before
        for k in tmanager.METRICS:
            assert (np.float32(jm[k]).view(np.uint32)
                    == np.float32(tm[k]).view(np.uint32)), (i, k)
        if i % 10 == 9 or tc["dense_len"] != before:
            assert tc["dense_len"] == int(jc["dense_len"]), i
            assert tc["total_len"] == int(jc["total_len"]), i
            for k, leaf in jax.tree.map(np.asarray, jc["layers"]).items():
                assert_leaf_equal(leaf, tc["layers"][k], f"step {i}: {k}")
    assert repacks >= 3


# ---------------------------------------------------------------------------
# deepseek-v2-lite-16b reduced served end to end
# ---------------------------------------------------------------------------

PROMPT, STEPS, BATCH = 24, 48, 2
TOL = 2e-2
ROUTE_FLIPS = 0.02          # as tests/test_torch_moe.py
_RUNS = {}


@pytest.fixture(scope="module")
def deepseek():
    jb = j_build(J_CFG)
    jparams = jax.jit(jb.init)(jax.random.PRNGKey(0))
    tparams = model_params_from_jax(jax.tree.map(np.asarray, jparams),
                                    device="cpu")
    tokens = np.asarray(j_batch(J_CFG, BATCH, PROMPT)["tokens"])
    return jb, jparams, tparams, tokens


def _reference_run(model, policy):
    if policy in _RUNS:
        return _RUNS[policy]
    jb, jparams, _, tokens = model
    spec = j_tier_spec(jb, 128, policy, hot_window=16, page_tokens=8,
                       group=16)
    routes = []
    with recorded_routes(j_moe, routes):
        cache, logits = jax.jit(lambda p, b: jb.prefill(p, b, spec))(
            jparams, {"tokens": jnp.asarray(tokens)})
        prefill_cache = jax.tree.map(np.asarray, cache)
        step = jax.jit(j_serve_step(jb, spec, policy))
        metrics = jmanager.zero_metrics()
        token = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
        inputs, step_logits = [], []
        for _ in range(STEPS):
            inputs.append(np.asarray(token))
            token, lg, cache, metrics = step(jparams, cache, token, metrics)
            step_logits.append(np.asarray(lg))
        jax.effects_barrier()
    run = {"prefill_logits": np.asarray(logits), "inputs": inputs,
           "routes": routes, "logits": step_logits,
           "prefill_cache": prefill_cache,
           "dense_len": int(cache["dense_len"]),
           "total_len": int(cache["total_len"]),
           "metrics": {k: np.float32(metrics[k]) for k in tmanager.METRICS}}
    _RUNS[policy] = run
    return run


def _assert_counters(ref, cache, metrics, label):
    assert cache["dense_len"] == ref["dense_len"], label
    assert cache["total_len"] == ref["total_len"], label
    for k in tmanager.METRICS:
        assert (np.float32(metrics[k]).view(np.uint32)
                == ref["metrics"][k].view(np.uint32)), (
            f"{label}: {k} {metrics[k]!r} != {ref['metrics'][k]!r}")


@pytest.mark.parametrize("policy", list(JPolicy), ids=lambda p: p.name)
def test_deepseek_served_teacher_forced(deepseek, policy):
    """Prefill (the dense first layer and the MoE layer, einsum dispatch)
    and 48 greedy steps (gather dispatch) teacher-forced on the
    reference's tokens and routes: logits within 2e-2 at the prefill and
    every step, the prefill's `mla` cache within the int4 tier's bytes
    (no byte differs by more than one step of a nibble), the watermarks
    and the five metrics exact."""
    _, _, tparams, tokens = deepseek
    ref = _reference_run(deepseek, policy)
    tpol = TPolicy(int(policy))
    tb = t_build(T_CFG, device="cpu")
    assert tb.cache_kind == "mla"
    spec = t_tier_spec(tb, 128, tpol, hot_window=16, page_tokens=8,
                       group=16)
    flips = []
    with replayed_routes(t_moe, ref["routes"], flips):
        cache, logits = tb.prefill(tparams, {"tokens": to_torch(tokens)},
                                   spec)
        np.testing.assert_allclose(logits.numpy(), ref["prefill_logits"],
                                   rtol=TOL, atol=TOL, err_msg="prefill")
        want = ref["prefill_cache"]
        assert cache["dense_len"] == int(want["dense_len"])
        for k in ("ch", "krope"):
            _close(cache["layers"][k], want["layers"][k], TOL, k)
        nib = cache["layers"]["c4"].numpy().astype(np.int16)
        wnib = want["layers"]["c4"].astype(np.int16)
        assert np.abs((nib & 15) - (wnib & 15)).max() <= 1
        assert np.abs((nib >> 4) - (wnib >> 4)).max() <= 1
        step = t_serve_step(tb, spec, tpol)
        metrics = tmanager.zero_metrics()
        for i, (tok, want) in enumerate(zip(ref["inputs"], ref["logits"])):
            _, lg, cache, metrics = step(tparams, cache, to_torch(tok),
                                         metrics)
            np.testing.assert_allclose(lg.numpy(), want, rtol=TOL, atol=TOL,
                                       err_msg=f"step {i}")
    _assert_counters(ref, cache, metrics, "teacher-forced")
    calls, sets, flipped = flips
    assert calls == (T_CFG.num_layers - 1) * (STEPS + 1)
    assert flipped <= ROUTE_FLIPS * sets, (
        f"{flipped} of {sets} top-k sets differ from the reference's")


@pytest.mark.parametrize("policy", list(JPolicy), ids=lambda p: p.name)
def test_deepseek_free_running_counters(deepseek, policy):
    _, _, tparams, _ = deepseek
    ref = _reference_run(deepseek, policy)
    tpol = TPolicy(int(policy))
    tb = t_build(T_CFG, device="cpu")
    spec = t_tier_spec(tb, 128, tpol, hot_window=16, page_tokens=8,
                       group=16)
    gen = torch.Generator().manual_seed(int(policy))
    cache, logits = tb.prefill(tparams, t_batch(T_CFG, BATCH, PROMPT, gen),
                               spec)
    first = torch.argmax(logits, -1).to(torch.int32)[:, None]
    toks, cache, metrics = t_decode_loop(tb, tparams, cache, first, STEPS,
                                         spec, tpol)
    assert toks.shape == (BATCH, STEPS) and toks.dtype == torch.int32
    _assert_counters(ref, cache, metrics, "free-running")


def test_deepseek_params_are_the_reference_tree():
    """`init_lm` draws the reference's tree for deepseek (first_dense
    beside layers; MLA attention; MoE with shared experts), leaf for
    leaf in shape and dtype."""
    jp = jax.eval_shape(j_build(J_CFG).init, jax.random.PRNGKey(0))
    tp = t_build(T_CFG, device="cpu").init(torch.Generator().manual_seed(0))

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


def test_launcher_serves_deepseek_on_the_cpu(capsys):
    t_launch.main(["--arch", NAME, "--reduced", "--device", "cpu",
                   "--prompt-len", "24", "--decode", "20", "--policy",
                   "ips"])
    out = capsys.readouterr().out
    assert "prefill 24 tokens x2" in out
    assert "policy=IPS:" in out and "stalls=1" in out
    assert "sample tokens:" in out


def test_moe_configs_with_other_capacity_factors_still_serve():
    """A deepseek reduced with capacity factor 1.0 (drops at decode)
    serves on the CPU through the engine: the drop path runs inside the
    model."""
    cfg = dataclasses.replace(T_CFG, moe=dataclasses.replace(
        T_CFG.moe, capacity_factor=1.0))
    tb = t_build(cfg, device="cpu")
    tpol = TPolicy.IPS
    spec = t_tier_spec(tb, 64, tpol, hot_window=16, page_tokens=8, group=16)
    gen = torch.Generator().manual_seed(0)
    params = tb.init(gen)
    cache, logits = tb.prefill(params, t_batch(cfg, 3, 20, gen), spec)
    first = torch.argmax(logits, -1).to(torch.int32)[:, None]
    toks, cache, metrics = t_decode_loop(tb, params, cache, first, 8, spec,
                                         tpol)
    assert toks.shape == (3, 8) and cache["total_len"] == 28
    assert bool(torch.isfinite(logits).all())
