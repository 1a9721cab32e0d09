"""Port vs reference: the pure-Python and numpy layers, the numeric
traps of the per-op core, and the port's import hygiene.

The heavier equivalence runs live beside this file:
test_torch_sim.py (per-op path), test_torch_compressed.py (segment path,
kernel plain version, carried-over state), test_torch_fleet.py (fleet and
summaries), test_torch_sweep.py (sweep runner and CLI); the kernel
itself is held against its plain version on the card by
test_torch_cuda.py and chip_smoke.py.
"""
import dataclasses
import json
import os
import subprocess
import sys
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.workloads as jwl
from repro.core.ssd import sim as jsim
from repro.core.ssd.driver import _agc_waste_p as j_waste
from repro.core.ssd.policies import registry as jreg
from repro.core.ssd.policies import spec as jspec
from repro.core.ssd.policies.state import can_pack as j_can_pack
from repro.core.ssd.policies.state import init_state as j_init_state
from repro.sweep import grid as jgrid
from repro.sweep import report as jreport
from repro_torch import workloads as twl
from repro_torch.core.ssd import sim as tsim
from repro_torch.core.ssd.driver import _agc_waste_p as t_waste
from repro_torch.core.ssd.policies import registry as treg
from repro_torch.core.ssd.policies import spec as tspec
from repro_torch.core.ssd.policies.state import (CellParams, can_pack,
                                                 fma32, init_state,
                                                 map_state)
from repro_torch.kernels.ssd_step import ops as ssd_step
from repro_torch.sweep import grid as tgrid
from repro_torch.sweep import report as treport
from torch_port_util import (CFG_J, CFG_T, N_LOGICAL, assert_leaf_equal,
                             assert_state_equal, reference_registry)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORTED = ("baseline", "ips", "ips_agc", "coop", "dyn_slc", "ips_lazy")


def test_port_imports_neither_jax_nor_the_reference():
    """`import repro_torch` and every submodule — the serving launcher, the
    kernel packages, the Mamba2 and hybrid models, the telemetry package,
    the sweep store, the host tier, the search engine, the MoE and MLA
    models, the training path (optimizers, train step, data pipeline,
    checkpoints, the training launcher), the distribution and launch
    modules (process groups, sharding rules, constraints, meshes, specs,
    the dry run and its cost analysis, the workloads shim) among them —
    and chip_smoke.py, scripts/dist_phase.py, the examples'
    counterparts (`examples/*_torch.py`), scripts/smoke_models_torch.py,
    scripts/examples_phase.py, scripts/bench_latent_torch.py,
    scripts/bench_flash_bwd_torch.py and the
    recorder of the reference examples' tables (which runs them in
    subprocesses) pull in no `jax` and no
    `repro.` module."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import repro_torch.launch.serve, repro_torch.kernels.ips_repack.ops\n"
        "import repro_torch.kernels.tiered_attention.ops\n"
        "import repro_torch.kernels.flash_attention.ops\n"
        "import repro_torch.kernels.ssd_scan.ops, repro_torch.kernels.ssd_scan.ref\n"
        "import repro_torch.models.mamba2, repro_torch.models.hybrid\n"
        "import repro_torch.telemetry, repro_torch.sweep.store\n"
        "import repro_torch.telemetry.history, repro_torch.telemetry.probe\n"
        "import repro_torch.telemetry.profiling\n"
        "import repro_torch.hostcache.pipeline, repro_torch.kernels.host_tier.ops\n"
        "import repro_torch.search, repro_torch.search.tune\n"
        "import repro_torch.models.moe, repro_torch.models.mla\n"
        "import repro_torch.models.transformer, repro_torch.interop\n"
        "import repro_torch.optim, repro_torch.optim.compress\n"
        "import repro_torch.train.train_step, repro_torch.launch.train\n"
        "import repro_torch.data.pipeline, repro_torch.checkpoint.ckpt\n"
        "import repro_torch.distributed.group, repro_torch.distributed.sharding\n"
        "import repro_torch.distributed.constraints, repro_torch.launch.mesh\n"
        "import repro_torch.launch.specs, repro_torch.launch.dryrun\n"
        "import repro_torch.launch.cost_analysis, repro_torch.core.ssd.workloads\n"
        "import chip_smoke\n"
        "sys.path.insert(0, 'scripts')\n"
        "import dist_phase\n"
        "import glob, importlib.util\n"
        "new = sorted(glob.glob('examples/*_torch.py')) + [\n"
        "    'scripts/smoke_models_torch.py', 'scripts/examples_phase.py',\n"
        "    'scripts/bench_latent_torch.py',\n"
        "    'scripts/bench_flash_bwd_torch.py',\n"
        "    'scripts/record_torch_reference_examples.py']\n"
        "assert len(new) == 12, new\n"
        "for i, path in enumerate(new):\n"
        "    spec = importlib.util.spec_from_file_location(f'new_{i}', path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(len([m for m in sys.modules if m.startswith('repro_torch')]))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 40      # the whole package loaded


def test_config_matches_reference():
    assert dataclasses.asdict(CFG_T) == dataclasses.asdict(CFG_J)
    for attr in ("num_planes", "total_pages", "pages_per_slc_block",
                 "slc_cap_pages", "capacity_gb", "idle_threshold_ms"):
        assert getattr(CFG_T, attr) == getattr(CFG_J, attr), attr


def test_registry_matches_reference():
    with reference_registry():
        names = jreg.policy_names()
    assert treg.policy_names() == names
    assert treg.PAPER_POLICIES == jreg.PAPER_POLICIES
    for name in names:
        j, t = jreg.get_spec(name), treg.get_spec(name)
        assert dataclasses.astuple(t) == dataclasses.astuple(j), name
        assert t.composition == j.composition
        assert treg.baseline_of(name) == jreg.baseline_of(name)
        assert tspec.tracked_region(t) == jspec.tracked_region(j)
        assert tspec.requires_endurance(t) == jspec.requires_endurance(j)
    assert [dataclasses.astuple(s) for s in tspec.iter_valid_specs()] == \
        [dataclasses.astuple(s) for s in jspec.iter_valid_specs()]


@pytest.mark.parametrize("policy", PORTED)
def test_default_cell_matches_reference(policy):
    j = jsim.default_params(CFG_J, policy, 0.0728)
    t = tsim.default_params(CFG_T, policy, 0.0728, device="cpu")
    for field in CellParams._fields:
        assert_leaf_equal(getattr(j, field), getattr(t, field), field)
    assert can_pack(CFG_T, N_LOGICAL, t) == j_can_pack(CFG_J, N_LOGICAL, j)


@pytest.mark.parametrize("policy", ("ips_raro", "base_wl"))
def test_wear_compositions_are_refused(policy):
    """A composition that reads wear is refused without wear knobs, and
    a wear run has no compressed path (as in the reference); with the
    default knobs it runs."""
    ops = {"arrival_ms": np.float32([1.0]), "lba": np.int32([3]),
           "is_write": np.int32([1])}
    bare = tsim.default_params(CFG_T, policy, device="cpu")._replace(
        endurance=None)
    with pytest.raises(ValueError, match="endurance"):
        tsim.run_trace(CFG_T, policy, ops, closed_loop=False, n_logical=64,
                       params=bare, device="cpu")
    with pytest.raises(ValueError, match="endurance"):
        tsim.run_compressed(CFG_T, policy, twl.compress_ops(
            twl.ir.pad_ops(dict(ops, req_id=np.int32([0]), n_ops=1,
                                n_reqs=1))),
            closed_loop=False, n_logical=64, device="cpu")
    lat, st = tsim.run_trace(CFG_T, policy, ops, closed_loop=False,
                             n_logical=64, device="cpu")
    assert st.wear is not None and float(st.wear.ops_seen) == 1.0
    assert ssd_step.composition_code(treg.get_spec(policy)) >= 32


def test_can_pack_bounds_match_reference():
    j0 = jsim.default_params(CFG_J, "coop")
    for cap_basic, cap_trad, cap_boost, n in ((50, 974, 0, 1 << 16),
                                              (16384, 0, 0, 1 << 16),
                                              (16383, 0, 1, 1 << 16),
                                              (64, 40000, 0, 1 << 16),
                                              (64, 0, 0, 1 << 23)):
        j = j0._replace(cap_basic=jnp.int32(cap_basic),
                        cap_trad=jnp.int32(cap_trad),
                        cap_boost=jnp.int32(cap_boost))
        t = CellParams(*(torch.tensor(int(v) if i != 2 and i != 3
                                      else float(v))
                         for i, v in enumerate((cap_basic, cap_trad, 5.0,
                                                0.0, cap_boost))))
        assert can_pack(CFG_T, n, t) == j_can_pack(CFG_J, n, j)


@pytest.mark.parametrize("packed", (False, True))
def test_init_state_matches_reference(packed):
    assert_state_equal(j_init_state(CFG_J, N_LOGICAL, packed=packed),
                       init_state(CFG_T, N_LOGICAL, packed=packed,
                                  device="cpu"), f"packed={packed}")
    fleet = init_state(CFG_T, 64, packed=packed, n_cells=3, device="cpu")
    assert fleet.loc.shape == (3, 64) and fleet.prev_t.shape == (3,)


def test_workloads_match_reference():
    """The 11 MSR-like traces in both modes, plus the repeat and seed
    variants the sweeps use: identical arrays, dtypes and counts."""
    recipes = [(n, m, 0, 1) for n in jwl.TRACE_NAMES
               for m in ("daily", "bursty")]
    recipes += [("hm_0", "bursty", 0, r) for r in (2, 4, 7)]
    recipes += [("proj_0", "daily", 3, 1)]
    assert twl.TRACE_NAMES == jwl.TRACE_NAMES
    for name, mode, seed, repeat in recipes:
        kw = dict(mode=mode, seed=seed, capacity_pages=CFG_J.total_pages,
                  repeat=repeat)
        j = jwl.build_ops(name, N_LOGICAL, **kw)
        t = twl.build_ops(name, N_LOGICAL, **kw)
        assert set(t) == set(j)
        for key, v in j.items():
            if isinstance(v, np.ndarray):
                assert t[key].dtype == v.dtype and np.array_equal(t[key], v), \
                    f"{name}/{mode}/seed={seed}/rep={repeat}: {key}"
            else:
                assert t[key] == v, f"{name}/{mode}: {key}"
    j = jwl.truncate_trace(jwl.build_ops("hm_1", N_LOGICAL), 1000)
    t = twl.truncate_trace(twl.build_ops("hm_1", N_LOGICAL), 1000)
    assert t["n_ops"] == j["n_ops"] and np.array_equal(t["lba"], j["lba"])
    with pytest.raises(ValueError, match="MSR"):
        twl.build_ops("no_such_trace", N_LOGICAL)


def test_agc_waste_calibration_matches_reference():
    for name in jwl.TRACE_NAMES:
        assert t_waste(name) == j_waste(name), name


@pytest.mark.parametrize("grid", ("paper", "quick", "beyond", "matrix",
                                  "stress", "mixed", "endurance",
                                  "sensitivity"))
def test_grids_match_reference(grid):
    with reference_registry():
        j = jgrid.named_grid(grid)
    t = tgrid.named_grid(grid)
    assert [p.key for p in t] == [p.key for p in j]
    assert [p.baseline for p in t] == [p.baseline for p in j]
    assert [p.baseline_point().key for p in t] == \
        [p.baseline_point().key for p in j]


def test_report_matches_reference_on_the_committed_sweep():
    with open(os.path.join(ROOT, "BENCH_sweep_paper.json")) as f:
        bench = json.load(f)
    by_key = bench["results"]
    j_res = {p: by_key[p.key] for p in jgrid.paper_grid()}
    t_res = {p: by_key[p.key] for p in tgrid.paper_grid()}
    j_gm = jreport.policy_geomeans(j_res)
    t_gm = treport.policy_geomeans(t_res)
    assert t_gm == j_gm
    assert {f"{m}/{p}": v for (m, p), v in t_gm.items()} == \
        bench["geomeans"]


def _exact_fma32(a, b, c) -> np.float32:
    """float32(a * b + c) rounded once, from exact rationals."""
    x = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    lo = np.float32(float(x))            # within one ulp of x
    cands = [np.nextafter(lo, np.float32(-np.inf)), lo,
             np.nextafter(lo, np.float32(np.inf))]
    dist = [abs(Fraction(float(v)) - x) for v in cands]
    best = min(dist)
    ties = [v for v, d in zip(cands, dist) if d == best]
    if len(ties) == 1:
        return ties[0]
    return [v for v in ties if not (v.view(np.int32) & 1)][0]


def test_fma32_rounds_once():
    rng = np.random.default_rng(7)
    a = rng.integers(-200, 200, 400).astype(np.float32)
    b = rng.uniform(0, 5, 400).astype(np.float32)
    c = rng.uniform(-500, 500, 400).astype(np.float32)
    # products exactly halfway between two float32 values, nudged by an
    # addend below float64's resolution there: the float64 sum rounds to
    # the halfway point and only the error term decides the direction
    a = np.concatenate([a, np.float32([3, 3, 5, 7, 7, 2049, 4097])])
    b = np.concatenate([b, np.float32([1 + 2 ** -23, 1 + 2 ** -23,
                                       1 + 2 ** -22, 1 + 3 * 2 ** -23,
                                       1 + 3 * 2 ** -23, 1, 1])])
    c = np.concatenate([c, np.float32([2 ** -60, -2 ** -60, -2 ** -58,
                                       2 ** -40, 2 ** -57, 2 ** -13,
                                       -2 ** -13])])
    got = fma32(torch.from_numpy(a), torch.from_numpy(b),
                torch.from_numpy(c)).numpy()
    want = np.array([_exact_fma32(x, y, z) for x, y, z in zip(a, b, c)])
    assert np.array_equal(got, want)


# Inputs found by bisecting on the reference: each sits where rounding a
# product once or twice changes an observable result, so each pins down
# whether the reference's compiler fused that multiply-add.
FMA_SITES = {
    # migrate: `budget - mig * c_mig` decides the erase (fused)
    "migrate_budget": ("baseline", {"slc_used": 20, "valid_mig": 6},
                       "28.119999", 0, 0.0, ()),
    # migrate: `used_ms + erase` feeds the write's conflict (not fused)
    "migrate_conflict": ("baseline", {"slc_used": 60, "valid_mig": 19},
                         "61.38", 1, 0.0, ()),
    # dual reclaim: `budget - ops1 * c_trad_rp` sizes ops2 (fused)
    "dual_ops1": ("coop", {"slc_used": 10, "rp_done": 13, "valid_mig": 100,
                           "trad_used": 200}, "286.9", 0, 0.0, ()),
    # dual reclaim: `budget - ops2 * c_mig` decides the erase (fused)
    "dual_ops2": ("coop", {"slc_used": 10, "rp_done": 19, "valid_mig": 13,
                           "trad_used": 200}, "59.26", 0, 0.0, ()),
    # AGC: `agc_waste + ops * waste_p` (fused)
    "agc_waste": ("ips_agc", {"slc_used": 40}, "9.7", 0, 0.0728,
                  ((8, "23.004784"),)),
}


@pytest.mark.parametrize("site", sorted(FMA_SITES))
def test_multiply_add_rounding_matches_reference(site):
    policy, plane0, t, kind, waste, ctr = FMA_SITES[site]
    n = 1024
    j_st = j_init_state(CFG_J, n)
    t_st = init_state(CFG_T, n, n_cells=1, device="cpu")
    for field, v in plane0.items():
        j_st = j_st._replace(**{field: getattr(j_st, field).at[0].set(v)})
        getattr(t_st, field)[0, 0] = v
    for i, v in ctr:
        j_st = j_st._replace(counters=j_st.counters.at[i].set(
            np.float32(v)))
        t_st.counters[0, i] = float(np.float32(v))
    ops = {"arrival_ms": np.float32([t]), "lba": np.int32([0]),
           "is_write": np.int32([kind])}
    step = jsim.make_step(CFG_J, policy, closed_loop=False,
                          params=jsim.default_params(CFG_J, policy, waste))
    j_fin, j_lat = jax.jit(lambda s, o: jax.lax.scan(step, s, o))(
        j_st, jsim.as_ops(ops))
    p = tsim.default_params(CFG_T, policy, waste, device="cpu")
    t_lat, t_fin = ssd_step.run_stream(
        CFG_T, policy, {k: torch.from_numpy(v).reshape(1, 1, 1)
                        for k, v in ops.items()}, t_st,
        closed_loop=False, params=map_state(lambda x: x[None], p))
    assert_leaf_equal(j_lat, t_lat.reshape(-1), f"{site}: latency")
    assert_state_equal(j_fin, map_state(lambda x: x[0], t_fin), site)


def test_kernel_wrapper_tables():
    codes = {ssd_step.composition_code(s) for s in tspec.iter_valid_specs()
             if not tspec.requires_endurance(s)}
    # the eight specialisations csrc/ssd_step.cu instantiates
    assert codes == {0, 1, 4, 6, 12, 14, 16, 17}
    t_ = CFG_T.timing
    want = np.float32([t_.slc_read_ms + t_.tlc_write_ms,
                       t_.tlc_read_ms + t_.reprogram_ms,
                       t_.slc_read_ms + t_.reprogram_ms,
                       4 * (t_.slc_read_ms + t_.tlc_write_ms),
                       (t_.tlc_read_ms + t_.reprogram_ms) * 0.5,
                       t_.erase_ms, t_.slc_read_ms, t_.tlc_read_ms,
                       t_.slc_write_ms, t_.tlc_write_ms, t_.reprogram_ms])
    # what the reference's compiler divides by: float32 reciprocals of the
    # three reclaim costs (XLA's `x / c` -> `x * (1 / c)`), and 1 / 8
    one = np.float32(1.0)
    want = np.concatenate([want, one / want[:3],
                           [one / np.float32(CFG_T.wear_buckets)]])
    assert np.array_equal(ssd_step.kernel_constants(CFG_T), want)
    # a cell of the paper's deployment fits one block's shared memory
    assert ssd_step.smem_bytes(128, 1 << 16) == 200192 <= ssd_step.MAX_SMEM


def test_kernel_wrapper_launches_or_raises_off_the_cpu():
    """Only CPU tensors take the plain version; any other device must
    launch the kernel or raise (here: the meta device)."""
    st = init_state(CFG_T, 64, n_cells=1, device="meta")
    p = tsim.default_params(CFG_T, "ips", device="meta")
    segs = {k: torch.zeros((1, 4, 1), dtype=d, device="meta")
            for k, d in (("arrival_ms", torch.float32),
                         ("lba", torch.int32), ("is_write", torch.int32))}
    before = ssd_step.launches
    with pytest.raises(ValueError, match="no kernel for device"):
        ssd_step.run_stream(CFG_T, "ips", segs, st, closed_loop=True,
                            params=map_state(lambda x: x[None], p))
    assert ssd_step.launches == before
