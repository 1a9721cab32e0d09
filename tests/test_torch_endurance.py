"""Port vs reference: endurance — wear carried through the per-op core.

* `EnduranceSpec` is a verbatim copy: same fields, parse, tag and zero.
* `sim.run_trace` with wear (on the CPU: the `ssd_step` kernel's plain
  version) equals the live JAX `run_trace` on every latency, every
  SimState leaf and every `WearState` leaf, for `ips_raro`, `base_wl`,
  `ips` and `baseline` in both modes and for the dual and AGC wear
  fragments, at cache sizes small enough that the gate, the fallback,
  the end of life and the read penalty all fire.
* `EnduranceSpec.zero()` leaves every legacy leaf bit for bit.
* `WEAR_SITES`: where the reference's compiler (XLA on the CPU) fuses a
  multiply-add, sums a plane's buckets, or multiplies by a constant's
  reciprocal where its source divides, crafted one-op cells whose result
  depends on that choice go through the reference's compiled fleet (its
  per-cell knobs traced, as the sweep runs them) and through the port;
  each site's inputs are checked to tell the choices apart.
* The lifetime summary and the fleet path match too.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.ssd import fleet as jfleet
from repro.core.ssd import sim as jsim
from repro.core.ssd.endurance.spec import EnduranceSpec as JSpec
from repro.core.ssd.policies import get_spec as j_get_spec
from repro_torch import interop
from repro_torch.core.ssd import fleet as tfleet
from repro_torch.core.ssd import sim as tsim
from repro_torch.core.ssd.endurance.spec import EnduranceSpec as TSpec
from repro_torch.core.ssd.policies.state import fma32
from repro_torch.kernels.ssd_step import ops as ssd_step
from torch_port_util import (CFG_J, CFG_T, N_LOGICAL, assert_leaf_equal,
                             assert_state_equal, fixture_ops)

F32 = np.float32
# knobs that make every wear mechanism fire on a few hundred ops
KNOBS = dict(w_rp=4.0, w_erase=1.0, cycle_budget=3.0, rp_budget=0.75,
             read_penalty_ms=0.05, rp_hysteresis=0.25)
CAPS = {"cap_basic": 4, "cap_trad": 4}
N_OPS = 768


def _params(policy, spec, caps=CAPS):
    j = jsim.default_params(CFG_J, policy, 0.05, endurance=JSpec(**spec))
    t = tsim.default_params(CFG_T, policy, 0.05, endurance=TSpec(**spec),
                            device="cpu")
    j = j._replace(**{k: jnp.int32(v) for k, v in caps.items()})
    t = t._replace(**{k: torch.tensor(v, dtype=torch.int32)
                      for k, v in caps.items()})
    return j, t


def test_endurance_spec_is_the_reference_copy():
    assert [f.name for f in dataclasses.fields(TSpec)] == \
        [f.name for f in dataclasses.fields(JSpec)]
    for text in ("", "w_rp=4,rp_budget=2", "read_penalty_ms=0.05,"
                 "rp_hysteresis=0.5,cycle_budget=60"):
        j, t = JSpec.parse(text), TSpec.parse(text)
        assert dataclasses.astuple(t) == dataclasses.astuple(j)
        assert t.tag == j.tag
    assert dataclasses.astuple(TSpec.zero()) == \
        dataclasses.astuple(JSpec.zero())
    for bad in ("w_rp", "nope=1", "w_rp=x"):
        with pytest.raises(ValueError, match="endurance"):
            TSpec.parse(bad)


CASES = ([(p, m) for p in ("ips_raro", "base_wl", "ips", "baseline")
          for m in ("daily", "bursty")]
         + [("coop", "daily"), ("ips_agc", "daily")])


@pytest.fixture(scope="module")
def wear_ops():
    return {"hm_0": fixture_ops("hm_0", max_ops=N_OPS, n_pad=256),
            "proj_0": fixture_ops("proj_0", max_ops=N_OPS, n_pad=256)}


@pytest.mark.parametrize("policy,mode", CASES)
def test_run_trace_with_wear_matches_reference(wear_ops, policy, mode):
    ops = wear_ops["proj_0" if mode == "daily" else "hm_0"]
    closed = mode == "bursty"
    jp, tp = _params(policy, KNOBS)
    j_lat, j_st = jsim.run_trace(CFG_J, policy, ops, closed_loop=closed,
                                 n_logical=N_LOGICAL, params=jp)
    t_lat, t_st = tsim.run_trace(CFG_T, policy, ops, closed_loop=closed,
                                 n_logical=N_LOGICAL, params=tp,
                                 device="cpu")
    label = f"{policy}/{mode}"
    assert_leaf_equal(j_lat, t_lat, f"{label}: latency")
    assert_state_equal(j_st, t_st, label)
    assert t_st.wear is not None
    # the wear mechanisms really fired on this input
    assert float(t_st.wear.pe_slc.sum()) > 0
    if policy != "ips_raro" and mode == "daily":
        assert float(t_st.wear.eol_op) > 0, label
    j_sum = jsim.summarize(j_lat, ops, j_st, cell=jp, cfg=CFG_J)
    t_sum = tsim.summarize(t_lat, ops["is_write"], t_st, cell=tp, cfg=CFG_T)
    for key in ("eff_cycles_max", "tbw_proj_gb", "eol_op", "pe_slc_total",
                "pe_rp_total", "pe_tlc_total", "pe_trad_total",
                "erase_events", "wa_paper", "erases", "migrations"):
        assert_leaf_equal(j_sum[key], t_sum[key], f"{label}: {key}")
    # the mean over buckets sums in float64 (the reference in float32)
    for key in ("eff_cycles_mean", "cycle_skew", "mean_write_latency_ms"):
        np.testing.assert_allclose(float(t_sum[key]), float(j_sum[key]),
                                   rtol=1e-6, err_msg=f"{label}: {key}")


def test_gate_and_fallback_fire_for_ips_raro(wear_ops):
    """ips_raro's gate closes inside the trace (overflow writes go
    TLC-direct) and the fallback migrates; ips on the same input keeps
    reprogramming."""
    ops = wear_ops["proj_0"]
    _, tp = _params("ips_raro", KNOBS)
    _, gated = tsim.run_trace(CFG_T, "ips_raro", ops, closed_loop=False,
                              n_logical=N_LOGICAL, params=tp, device="cpu")
    _, tp = _params("ips", KNOBS)
    _, plain = tsim.run_trace(CFG_T, "ips", ops, closed_loop=False,
                              n_logical=N_LOGICAL, params=tp, device="cpu")
    c = {name: i for i, name in enumerate(
        ["host_w", "slc_w", "tlc_w", "rp_host", "rp_agc", "rp_trad",
         "mig_w", "erases", "agc_waste", "conflict_ms"])}
    assert gated.counters[c["tlc_w"]] > plain.counters[c["tlc_w"]]
    assert gated.counters[c["rp_host"]] < plain.counters[c["rp_host"]]


@pytest.mark.parametrize("policy", ("baseline", "ips", "ips_agc", "coop"))
def test_zero_wear_is_observation_only(wear_ops, policy):
    ops = wear_ops["proj_0"]
    _, tp = _params(policy, dataclasses.asdict(TSpec.zero()))
    lat0, st0 = tsim.run_trace(CFG_T, policy, ops, closed_loop=False,
                               n_logical=N_LOGICAL,
                               params=tp._replace(endurance=None),
                               device="cpu")
    lat1, st1 = tsim.run_trace(CFG_T, policy, ops, closed_loop=False,
                               n_logical=N_LOGICAL, params=tp, device="cpu")
    assert st0.wear is None and st1.wear is not None
    assert torch.equal(lat0, lat1)
    # the base leaves: every field before the trailing wear and timeline
    for field in st0._fields[:st0._fields.index("wear")]:
        assert torch.equal(getattr(st0, field), getattr(st1, field)), field


def test_fleet_with_wear_matches_reference(wear_ops):
    """An endurance fleet steps every padded op (no pad trim) and its
    per-cell summaries carry the lifetime metrics."""
    traces = [wear_ops["proj_0"], wear_ops["hm_0"]]
    jp, tp = _params("base_wl", KNOBS)
    j_lat, j_st = jfleet.run_fleet(
        CFG_J, "base_wl", jfleet.stack_ops(traces),
        jfleet.stack_params([jp, jp]), closed_loop=False,
        n_logical=N_LOGICAL, trim_pads=True)
    t_ops = tfleet.stack_ops(traces, device="cpu")
    t_lat, t_st = tfleet.run_fleet(
        CFG_T, "base_wl", t_ops, tfleet.stack_params([tp, tp]),
        closed_loop=False, n_logical=N_LOGICAL, trim_pads=True)
    assert_leaf_equal(j_lat, t_lat, "fleet latency")
    assert_state_equal(j_st, t_st, "fleet")
    summ = tfleet.summarize_fleet(t_lat, t_ops["is_write"], t_st,
                                  params=tfleet.stack_params([tp, tp]),
                                  cfg=CFG_T)
    assert summ["eol_op"].shape == (2,) and "tbw_proj_gb" in summ


# ---------------------------------------------------------------------------
# the reference compiler's float choices in the wear fragments
# ---------------------------------------------------------------------------

READ = {"arrival_ms": F32([0.0]), "lba": np.int32([0]),
        "is_write": np.int32([0])}
WRITE = dict(READ, is_write=np.int32([1]))
N_SITE = 256
_ROWS = ("pe_slc", "pe_rp", "pe_tlc", "erase", "pe_trad", "erase_trad")


def _rnd(rng, shape=()):
    return (rng.uniform(0.5, 1.5, shape)
            * 2.0 ** rng.integers(-6, 10, shape)).astype(F32)


def _run_cells(policy, closed, cells, knobs, caps, op, t=0.0):
    """One op through the reference's compiled fleet (knobs traced) and
    through the port, from crafted per-cell states: wear rows and plane
    fields of plane 0 (the op's plane). Returns both (latency, state)."""
    n = 256
    st = jfleet.init_fleet_state(CFG_J, n, len(cells), endurance=True)
    wear = st.wear
    for name in _ROWS:
        vals = np.stack([c.get(name, np.zeros_like(getattr(wear, name)[0, 0]))
                         for c in cells]).astype(F32)
        wear = wear._replace(**{name: getattr(wear, name).at[:, 0].set(vals)})
    st = st._replace(wear=wear)
    for name in ("slc_used", "rp_done", "trad_used", "valid_mig"):
        st = st._replace(**{name: getattr(st, name).at[:, 0].set(
            jnp.asarray([c.get(name, 0) for c in cells], jnp.int32))})
    if any("idle_cum" in c for c in cells):
        st = st._replace(idle_cum=jnp.asarray(
            [c.get("idle_cum", 0.0) for c in cells], jnp.float32))
    jps, tps = [], []
    for k, cap in zip(knobs, caps):
        jp, tp = _params(policy, k, cap)
        jps.append(jp)
        tps.append(tp)
    ops = {k: np.stack([v] * len(cells)) for k, v in op.items()}
    ops["arrival_ms"] = F32([[c.get("t", t)] for c in cells])
    j_ops = {k: jnp.asarray(v) for k, v in ops.items()}
    # the reference's fleet donates its initial state: copy it out first
    leaves = [np.asarray(x) for x in jax.tree.leaves(st)]
    j_lat, j_st = jfleet._run_fleet(CFG_J, j_get_spec(policy), st, j_ops,
                                    jfleet.stack_params(jps),
                                    closed_loop=closed)
    t_st0 = interop.state_from_jax(leaves, device="cpu")
    t_lat, t_st = ssd_step.run_stream(
        CFG_T, policy, {k: torch.from_numpy(v).reshape(len(cells), 1, 1)
                        for k, v in ops.items()},
        t_st0, closed_loop=closed, params=tfleet.stack_params(tps))
    return (np.asarray(j_lat)[:, 0], j_st), (t_lat.reshape(-1), t_st)


def _vfma(a, b, c):
    return fma32(torch.as_tensor(np.asarray(a, F32)),
                 torch.as_tensor(np.asarray(b, F32)),
                 torch.as_tensor(np.asarray(c, F32))).numpy()


def _seq(x):
    s = x[..., 0]
    for i in range(1, x.shape[-1]):
        s = (s + x[..., i]).astype(F32)
    return s


def _pair(x):
    h = x
    while h.shape[-1] > 1:
        h = (h[..., 0::2] + h[..., 1::2]).astype(F32)
    return h[..., 0]


def _site_plane_cycles(policy, closed):
    """Retention read latency: the plane's bucket sums (left to right),
    `w_slc*S_slc + w_rp*S_rp` (one FMA, its order set by the
    allocation), `/ cap + w_erase*erase` and `read + penalty*age`
    (fused)."""
    rng = np.random.default_rng(17)
    cells, knobs, caps = [], [], []
    for _ in range(N_SITE):
        cells.append({name: _rnd(rng, (8,) if name in ("pe_slc", "pe_rp")
                                 else ()) for name in _ROWS})
        knobs.append(dict(w_slc=float(_rnd(rng)), w_rp=float(_rnd(rng)),
                          w_erase=float(_rnd(rng)),
                          cycle_budget=float(_rnd(rng) * 1000),
                          read_penalty_ms=float(_rnd(rng)), rp_budget=1e9))
        caps.append({"cap_basic": int(rng.integers(1, 3000)),
                     "cap_trad": int(rng.integers(1, 3000))})
    # the unfused alternative: what a plain evaluation would give
    s1 = np.stack([_pair(c["pe_slc"]) for c in cells])
    s2 = np.stack([_pair(c["pe_rp"]) for c in cells])
    w = {k: F32([x[k] for x in knobs]) for k in knobs[0]}
    cap = F32([c["cap_basic"] for c in caps])
    pc = ((w["w_slc"] * s1 + w["w_rp"] * s2) / cap
          + w["w_erase"] * F32([c["erase"] for c in cells])).astype(F32)
    age = np.clip(pc / w["cycle_budget"], 0, 1).astype(F32)
    naive = (F32(0.066) + w["read_penalty_ms"] * age).astype(F32)
    return cells, knobs, caps, READ, 0.0, "latency", naive


def _site_bucket_cycles(policy, closed):
    """End of life: `fma(w_slc, pe_slc, w_rp*pe_rp) / (cap/8) +
    round(w_erase*erase)` over the buckets (this sum not fused), against
    a cycle budget set to one of the candidate roundings."""
    rng = np.random.default_rng(23)
    cells, knobs, caps, naive = [], [], [], []
    for _ in range(N_SITE):
        c = {"pe_slc": _rnd(rng, (8,)), "pe_rp": _rnd(rng, (8,)),
             "erase": _rnd(rng)}
        k = dict(w_slc=float(_rnd(rng)), w_rp=float(_rnd(rng)),
                 w_erase=float(_rnd(rng)), read_penalty_ms=0.0,
                 rp_budget=1e9)
        cb = int(rng.integers(8, 3000))
        ppb = max(F32(cb) / F32(8), F32(1))
        w_s, w_r, w_e = F32(k["w_slc"]), F32(k["w_rp"]), F32(k["w_erase"])
        fused = F32(np.max(_vfma(np.full(8, w_s), c["pe_slc"],
                                 (w_r * c["pe_rp"]).astype(F32))))
        plain = F32(np.max((w_s * c["pe_slc"]).astype(F32)
                           + (w_r * c["pe_rp"]).astype(F32)))
        erase_t = F32(w_e * c["erase"])
        cand = (F32(F32(fused / ppb) + erase_t),
                F32(F32(plain / ppb) + erase_t),
                _vfma(w_e, c["erase"], F32(fused / ppb))[()])
        k["cycle_budget"] = float(cand[int(rng.integers(3))])
        naive.append(cand[1] >= F32(k["cycle_budget"]))
        cells.append(c)
        knobs.append(k)
        caps.append({"cap_basic": cb, "cap_trad": 1})
    return cells, knobs, caps, READ, 0.0, "eol", np.array(naive)


def _site_trad_cycles(policy, closed):
    """The traditional region's cycles in the end-of-life check:
    `fma(w_erase, erase_trad, w_slc*pe_trad / cap_trad)` (fused)."""
    rng = np.random.default_rng(29)
    cells, knobs, caps, naive = [], [], [], []
    for _ in range(N_SITE):
        c = {"pe_trad": _rnd(rng), "erase_trad": _rnd(rng)}
        k = dict(w_slc=float(_rnd(rng)), w_rp=float(_rnd(rng)),
                 w_erase=float(_rnd(rng)), read_penalty_ms=0.0,
                 rp_budget=1e9)
        ct = int(rng.integers(1, 3000))
        w_s, w_e = F32(k["w_slc"]), F32(k["w_erase"])
        tq = F32(F32(w_s * c["pe_trad"]) / F32(ct))
        cand = (F32(tq + F32(w_e * c["erase_trad"])),
                _vfma(w_e, c["erase_trad"], tq)[()])
        k["cycle_budget"] = float(cand[int(rng.integers(2))])
        naive.append(cand[0] >= F32(k["cycle_budget"]))
        cells.append(c)
        knobs.append(k)
        caps.append({"cap_basic": 64, "cap_trad": ct})
    return cells, knobs, caps, READ, 0.0, "eol", np.array(naive)


def _site_gate_sum(policy, closed):
    """The reliability gate: `sum(pe_rp) / cap < rp_budget`, the sum left
    to right, against a budget set to one of the candidate sums."""
    rng = np.random.default_rng(31)
    cells, knobs, caps, naive = [], [], [], []
    for _ in range(N_SITE):
        cb = int(rng.integers(8, 3000))
        c = {"pe_rp": _rnd(rng, (8,)), "slc_used": cb}
        cand = (F32(_seq(c["pe_rp"]) / F32(cb)),
                F32(_pair(c["pe_rp"]) / F32(cb)))
        pick = cand[int(rng.integers(2))]
        knobs.append(dict(rp_budget=float(pick), read_penalty_ms=0.0))
        naive.append(cand[1] < pick)
        cells.append(c)
        caps.append({"cap_basic": cb, "cap_trad": 0})
    return cells, knobs, caps, WRITE, 0.0, "rp_host", np.array(naive)


def _site_coldest_bucket(policy, closed):
    """wear_min's placement: argmin of `fma(w_slc, pe_slc, w_rp*pe_rp)`,
    the first bucket on ties; two buckets a rounding apart."""
    from fractions import Fraction
    rng = np.random.default_rng(37)
    cells, knobs, caps, naive = [], [], [], []
    while len(cells) < N_SITE:
        ws, wr = _rnd(rng), _rnd(rng)
        a0, b0, b1 = (F32(rng.integers(0, 64) / 8) for _ in range(3))
        v0 = (Fraction(float(ws)) * Fraction(float(a0))
              + Fraction(float(wr)) * Fraction(float(b0)))
        a1 = F32(float((v0 - Fraction(float(wr)) * Fraction(float(b1)))
                       / Fraction(float(ws))))
        if a1 < 0:
            continue
        ps, pr = np.full(8, 1e6, F32), np.full(8, 1e6, F32)
        j = int(rng.integers(1, 8))
        ps[0], pr[0], ps[j], pr[j] = a0, b0, a1, b1
        fused = int(np.argmin(_vfma(np.full(8, ws), ps,
                                    (wr * pr).astype(F32))))
        plain = int(np.argmin((ws * ps).astype(F32)
                              + (wr * pr).astype(F32)))
        if fused == plain:
            continue
        cells.append({"pe_slc": ps, "pe_rp": pr})
        knobs.append(dict(w_slc=float(ws), w_rp=float(wr),
                          read_penalty_ms=0.0, rp_budget=1e9,
                          cycle_budget=1e9))
        caps.append({"cap_basic": 4096, "cap_trad": 0})
        naive.append(plain)
    return cells, knobs, caps, WRITE, 0.0, "bucket", np.array(naive)


def _site_quotient(policy, closed):
    """`budget / c` for a constant c is `budget * float32(1 / c)` in the
    reference's compiled core: idle budgets at multiples of c, where the
    IEEE quotient truncates one higher."""
    from repro_torch.core.ssd.policies.engine import core_constants
    k = core_constants(CFG_T)
    c_name = {"baseline": "c_mig", "ips_raro": "c_mig",
              "ips_agc": "c_agc", "coop": "c_trad_rp"}[policy]
    agc = policy == "ips_agc"
    c = F32(k[c_name])
    inv = F32(1) / c
    budgets = [F32(i * c) for i in range(2, 2000)]
    budgets = [b for b in budgets
               if np.trunc(b / c) != np.trunc(F32(b * inv))][:64]
    cells, knobs, caps, naive = [], [], [], []
    for b in budgets:
        cell = {"idle_cum": float(b), "valid_mig": 4000, "slc_used": 40}
        if policy == "ips_raro":      # the fallback is armed
            cell["pe_rp"] = np.full(8, 100.0, F32)
            cell["slc_used"] = 60
        if policy == "coop":
            cell.update(slc_used=2000, trad_used=900)
        if agc:                       # AGC spends the op's own gap
            cell = {"t": float(b), "slc_used": 4000}
        cells.append(cell)
        knobs.append(dict(read_penalty_ms=0.0, rp_budget=0.5,
                          cycle_budget=1e9))
        caps.append({"cap_basic": 64, "cap_trad": 974})
        naive.append(np.trunc(b / c))
    # migrate and dual reclaim spend the carried idle budget (the op at
    # t = 0 adds none); AGC spends the op's gap since the plane's busy end
    return cells, knobs, caps, READ, 0.0, "quotient", np.array(naive)


WEAR_SITES = {
    "plane_cycles_static": ("baseline", True, _site_plane_cycles),
    "plane_cycles_gated": ("ips_raro", False, _site_plane_cycles),
    "plane_cycles_dual": ("coop", True, _site_plane_cycles),
    "bucket_cycles": ("ips", True, _site_bucket_cycles),
    "bucket_cycles_dual": ("ips_lazy", False, _site_bucket_cycles),
    "trad_cycles": ("coop", True, _site_trad_cycles),
    "gate_sum": ("ips_raro", True, _site_gate_sum),
    "coldest_bucket": ("base_wl", True, _site_coldest_bucket),
    "coldest_bucket_daily": ("base_wl", False, _site_coldest_bucket),
    "quotient_migrate": ("baseline", False, _site_quotient),
    "quotient_gated": ("ips_raro", False, _site_quotient),
    "quotient_dual": ("coop", False, _site_quotient),
    "quotient_agc": ("ips_agc", False, _site_quotient),
}


@pytest.mark.parametrize("site", sorted(WEAR_SITES))
def test_wear_float_sites_match_the_compiled_reference(site):
    policy, closed, make = WEAR_SITES[site]
    cells, knobs, caps, op, t, observe, naive = make(policy, closed)
    (j_lat, j_st), (t_lat, t_st) = _run_cells(policy, closed, cells, knobs,
                                              caps, op, t)
    assert_leaf_equal(j_lat, t_lat, f"{site}: latency")
    assert_state_equal(j_st, t_st, site)
    # the inputs tell the candidate roundings apart: on some cells the
    # observable differs from a plain (unfused, pairwise) evaluation's
    if observe == "latency":
        got = t_lat.numpy()
    elif observe == "eol":
        got = t_st.wear.eol_op.numpy() >= 0
    elif observe == "rp_host":
        got = t_st.counters[:, 3].numpy() == 1
    elif observe == "bucket":
        before = np.stack([c["pe_slc"] for c in cells])
        got = np.argmax(t_st.wear.pe_slc[:, 0].numpy() != before, axis=1)
    else:
        got = t_st.counters[:, 6].numpy() + t_st.counters[:, 5].numpy() \
            + t_st.counters[:, 4].numpy()
    assert np.any(got != naive), f"{site}: the inputs do not discriminate"
