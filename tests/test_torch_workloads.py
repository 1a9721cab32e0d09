"""Port vs reference: the workload engine (numpy copies of the reference's
`workloads` modules).

* Every scenario generator's arrays, seeds 0-2, both modes, bit for bit
  (value and dtype), and the multi-tenant mixer.
* Each trace-file format: the repo's MSR and blktrace samples, small fio
  (v2 and v3) and generic CSV files written to `tmp_path`; `sniff_format`.
* `fit_stats` (one phase and windowed) and `synthesize_like` equal.
* The Trace IR's transforms, `trace_from_ops` and `concat`.
* The port's trace cache: a hit equals a build, the key moves with the
  generator `VERSION` and the file digest, and nothing is written under
  the reference's cache directory.
"""
import dataclasses
import os

import numpy as np
import pytest

import repro.workloads as jwl
from repro.workloads import generators as jgen
from repro.workloads import parsers as jparse
from repro.workloads.cache import default_cache_dir as j_cache_dir
from repro_torch import workloads as twl
from repro_torch.workloads import cache as tcache
from repro_torch.workloads import generators as tgen
from repro_torch.workloads import parsers as tparse
from torch_port_util import CFG_J, N_LOGICAL

CAP = CFG_J.total_pages
DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
SAMPLES = (os.path.join(DATA, "sample_msr.csv"),
           os.path.join(DATA, "sample_blktrace.txt"))


def _assert_ops_equal(j, t, label):
    assert set(t) == set(j), label
    for key, v in j.items():
        if isinstance(v, np.ndarray):
            assert t[key].dtype == v.dtype, f"{label}: {key} dtype"
            assert np.array_equal(t[key], v), f"{label}: {key}"
        else:
            assert t[key] == v, f"{label}: {key}"


def _assert_trace_equal(j, t, label):
    for field in ("arrival_ms", "lba", "is_write", "req_id"):
        a, b = getattr(j, field), getattr(t, field)
        assert b.dtype == a.dtype and np.array_equal(a, b), f"{label}: {field}"
    assert (t.n_reqs, t.source, t.history) == (j.n_reqs, j.source, j.history)


def test_scenario_registry_matches_reference():
    assert twl.SCENARIO_NAMES == jwl.SCENARIO_NAMES
    assert tgen.VERSION == jgen.VERSION == 2
    assert twl.known_specs() == jwl.known_specs()
    for spec in ("hm_0", "gc_pressure", SAMPLES[0]):
        assert twl.spec_kind(spec) == jwl.spec_kind(spec)
    with pytest.raises(ValueError, match="unknown workload spec"):
        twl.spec_kind("no_such_trace")


@pytest.mark.parametrize("seed", (0, 1, 2))
@pytest.mark.parametrize("name", jwl.SCENARIO_NAMES)
def test_scenario_arrays_match_reference(name, seed):
    for mode in ("daily", "bursty"):
        j = jwl.build_ops(name, N_LOGICAL, mode=mode, seed=seed,
                          capacity_pages=CAP)
        t = twl.build_ops(name, N_LOGICAL, mode=mode, seed=seed,
                          capacity_pages=CAP)
        _assert_ops_equal(j, t, f"{name}/{mode}/seed={seed}")
    j = jgen.SCENARIOS[name](N_LOGICAL, CAP, seed)
    t = tgen.SCENARIOS[name](N_LOGICAL, CAP, seed)
    _assert_trace_equal(j, t, f"{name} trace")


def test_mixer_and_ir_transforms_match_reference():
    jt = [jgen.SCENARIOS[n](N_LOGICAL, CAP, 0)
          for n in ("zipf_hot", "read_burst")]
    tt = [tgen.SCENARIOS[n](N_LOGICAL, CAP, 0)
          for n in ("zipf_hot", "read_burst")]
    for partition in (True, False):
        _assert_trace_equal(
            jgen.mix_traces(jt, N_LOGICAL, partition=partition),
            tgen.mix_traces(tt, N_LOGICAL, partition=partition),
            f"mix partition={partition}")
    _assert_trace_equal(jwl.ir.concat(jt[0], jt[1], gap_ms=7.5),
                        twl.ir.concat(tt[0], tt[1], gap_ms=7.5), "concat")
    for jx, tx, label in (
            (jt[0].truncate(300), tt[0].truncate(300), "truncate"),
            (jt[0].scale_rate(2.0), tt[0].scale_rate(2.0), "scale_rate"),
            (jt[1].shift_write_ratio(0.6, seed=3),
             tt[1].shift_write_ratio(0.6, seed=3), "shift_write_ratio"),
            (jt[0].repeat(2), tt[0].repeat(2), "repeat"),
            (jt[0].to_bursty(N_LOGICAL), tt[0].to_bursty(N_LOGICAL),
             "to_bursty")):
        _assert_trace_equal(jx, tx, label)
        _assert_ops_equal(jx.compile(), tx.compile(), f"{label} compiled")
    ops = jwl.build_ops("hm_1", N_LOGICAL, capacity_pages=CAP)
    _assert_trace_equal(jwl.ir.trace_from_ops(ops, source="x"),
                        twl.ir.trace_from_ops(ops, source="x"), "from_ops")
    req = jwl.synthesize("stg_0", N_LOGICAL, 0, CAP)
    _assert_ops_equal(jwl.ir.requests_to_ops(req, "bursty", N_LOGICAL),
                      twl.ir.requests_to_ops(req, "bursty", N_LOGICAL),
                      "requests_to_ops")


def _write_samples(tmp_path):
    fio2 = tmp_path / "job.iolog"
    fio2.write_text("fio version 2 iolog\n/dev/sdb add\n/dev/sdb open\n"
                    + "".join(f"/dev/sdb {'write' if i % 3 else 'read'} "
                              f"{(i * 7919) % 4096 * 4096} {4096 * (1 + i % 4)}\n"
                              for i in range(40))
                    + "/dev/sdb close\n")
    fio3 = tmp_path / "job3.iolog"
    fio3.write_text("fio version 3 iolog\n"
                    + "".join(f"{i * 2} /dev/sdb {'write' if i % 2 else 'read'}"
                              f" {i * 8192} 8192\n" for i in range(30)))
    gen = tmp_path / "trace.csv"
    gen.write_text("time_ms,lba,pages,op\n"
                   + "".join(f"{i * 0.5},{(i * 31) % 900},{1 + i % 3},"
                             f"{'W' if i % 4 else 'R'}\n" for i in range(50)))
    bare = tmp_path / "bare.csv"
    bare.write_text("".join(f"{i * 1.25},{i * 8},2,{'W' if i % 2 else 'R'}\n"
                            for i in range(25)))
    return [str(p) for p in (fio2, fio3, gen, bare)]


def test_parsers_match_reference(tmp_path):
    paths = list(SAMPLES) + _write_samples(tmp_path)
    fmts = []
    for path in paths:
        j_req = jparse.parse_requests(path)
        t_req = tparse.parse_requests(path)
        for key, v in j_req.items():
            assert t_req[key].dtype == v.dtype and np.array_equal(
                t_req[key], v), f"{path}: {key}"
        for mode in ("daily", "bursty"):
            _assert_trace_equal(
                jparse.load_trace(path, mode, total_logical_pages=N_LOGICAL),
                tparse.load_trace(path, mode, total_logical_pages=N_LOGICAL),
                f"{path}/{mode}")
        _assert_trace_equal(jparse.load_trace(path, max_ops=17),
                            tparse.load_trace(path, max_ops=17),
                            f"{path} max_ops")
        _assert_ops_equal(jwl.build_ops(path, N_LOGICAL),
                          twl.build_ops(path, N_LOGICAL), f"{path} ops")
        with tparse.open_trace(path) as fh:
            lines = [line for line in fh if line.strip()]
        data = lines[len(lines) // 2]           # a data line of any format
        fmts.append(tparse.sniff_format(data))
        assert fmts[-1] == jparse.sniff_format(data)
    assert {"msr", "blktrace", "fio", "generic"} <= set(fmts)


@pytest.mark.parametrize("spec", ("hm_0", "gc_pressure", "tenant_mix",
                                  SAMPLES[0]))
def test_fit_stats_matches_reference(spec):
    ops = jwl.build_ops(spec, N_LOGICAL, capacity_pages=CAP)
    j_tr = jwl.ir.trace_from_ops(ops, source=spec)
    t_tr = twl.ir.trace_from_ops(ops, source=spec)
    j_st = jwl.fit_stats(j_tr, N_LOGICAL, CAP)
    t_st = twl.fit_stats(t_tr, N_LOGICAL, CAP)
    assert dataclasses.astuple(t_st) == dataclasses.astuple(j_st)
    j_w = jwl.fit_stats(j_tr, N_LOGICAL, CAP, windows=3)
    t_w = twl.fit_stats(t_tr, N_LOGICAL, CAP, windows=3)
    assert [dataclasses.astuple(s) for s in t_w] == \
        [dataclasses.astuple(s) for s in j_w]
    _assert_trace_equal(jwl.synthesize_like(j_tr, N_LOGICAL, CAP, seed=1),
                        twl.synthesize_like(t_tr, N_LOGICAL, CAP, seed=1),
                        f"{spec} synthesize_like")
    from repro.workloads.stats import request_view as j_view
    from repro_torch.workloads.stats import request_view as t_view
    for a, b in zip(j_view(j_tr), t_view(t_tr)):
        assert b.dtype == a.dtype and np.array_equal(a, b)


def test_trace_cache_round_trip(tmp_path, monkeypatch):
    root = tmp_path / "cache"
    monkeypatch.setenv("REPRO_TORCH_TRACE_CACHE_DIR", str(root))
    monkeypatch.delenv("REPRO_TRACE_CACHE_DIR", raising=False)
    # the port's default directory is its own, never the reference's
    assert tcache.default_cache_dir() == str(root)
    monkeypatch.delenv("REPRO_TORCH_TRACE_CACHE_DIR")
    assert tcache.default_cache_dir() != j_cache_dir()
    assert "repro_torch" in tcache.default_cache_dir()
    monkeypatch.setenv("REPRO_TORCH_TRACE_CACHE_DIR", str(root))

    cache = twl.TraceCache()
    kw = dict(mode="daily", seed=1, capacity_pages=CAP)
    built = twl.build_ops("zipf_hot", N_LOGICAL, **kw)
    first = twl.build_ops("zipf_hot", N_LOGICAL, cache=cache, **kw)
    again = twl.build_ops("zipf_hot", N_LOGICAL, cache=cache, **kw)
    assert (cache.misses, cache.hits) == (1, 1)
    _assert_ops_equal(built, first, "miss")
    _assert_ops_equal(built, again, "memory hit")
    disk = twl.TraceCache()                     # a fresh process's view
    from_disk = twl.build_ops("zipf_hot", N_LOGICAL, cache=disk, **kw)
    assert (disk.misses, disk.hits) == (0, 1)
    _assert_ops_equal(built, from_disk, "disk hit")
    assert [p.name for p in root.iterdir() if p.suffix == ".npz"]
    # the key carries the generator version and the file digest
    recipe = twl.trace_recipe("zipf_hot", N_LOGICAL, **kw)
    assert recipe["gen_version"] == tgen.VERSION
    bumped = dict(recipe, gen_version=tgen.VERSION + 1)
    assert cache.key(bumped) != cache.key(recipe)
    path = tmp_path / "t.csv"
    path.write_text("0,0,1,W\n1,8,1,R\n")
    k1 = cache.key(twl.trace_recipe(str(path), N_LOGICAL))
    path.write_text("0,0,1,W\n1,9,1,R\n")
    k2 = cache.key(twl.trace_recipe(str(path), N_LOGICAL))
    assert k1 != k2
    # the recipe and its key are the reference's own
    assert recipe == jwl.trace_recipe("zipf_hot", N_LOGICAL, **kw)
    assert cache.key(recipe) == jwl.TraceCache.key(recipe)
    # a disk failure falls back to building
    broken = twl.TraceCache(root=str(path))     # a file, not a directory
    _assert_ops_equal(built, twl.build_ops("zipf_hot", N_LOGICAL,
                                           cache=broken, **kw), "no disk")
    assert broken.misses == 1


def test_stack_traces_matches_reference():
    j_cells, j_tr = jwl.stack_traces(("hm_0", "gc_pressure"), N_LOGICAL,
                                     seeds=(0, 1), capacity_pages=CAP,
                                     max_ops=5000)
    t_cells, t_tr = twl.stack_traces(("hm_0", "gc_pressure"), N_LOGICAL,
                                     seeds=(0, 1), capacity_pages=CAP,
                                     max_ops=5000)
    assert t_cells == j_cells
    for j, t in zip(j_tr, t_tr):
        _assert_ops_equal(j, t, "stack")
