"""The port's examples and dev scripts against the reference's, on the
CPU: each `examples/<name>.py` runs live (JAX on the CPU, through
`runpy`) and its counterpart `examples/<name>_torch.py` with `--device
cpu` (the kernels' plain versions), at the same cut size, and their
printed tables must be equal text (`chip_smoke.example_table`: the
simulator's columns and the weight-independent serving columns).

A cut goes through the example's own flags where it has them
(`--max-ops`, `--workloads`, `--decode`, `--steps`); otherwise the same
monkeypatch is applied to both packages: `run_matrix` and `run_sweep`
cut to a few ops, the evaluation driver's `make_trace` truncated,
`ir.PAD_OPS` cut (the host tier steps every padded op). Then
`scripts/smoke_models_torch.py` over every arch, and with a fault
planted in one family.
"""
import contextlib
import functools
import importlib.util
import io
import json
import math
import os
import runpy
import subprocess
import sys

import jax  # noqa: F401 — the reference runs live beside the port
import pytest
import torch

import repro.core.ssd.driver as j_driver
import repro.sweep.runner as j_runner
import repro.workloads.ir as j_ir
from repro.core.ssd.workloads import truncate_trace as j_truncate
import repro_torch.core.ssd.driver as t_driver
import repro_torch.sweep.runner as t_runner
import repro_torch.workloads.ir as t_ir
from repro_torch.workloads import truncate_trace as t_truncate

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402  (jax-free; its table helper)

MAX_OPS = 64                    # the simulator's cut: its plain version
#                                 steps an op at a time on the CPU


@pytest.fixture(autouse=True)
def _trace_caches(tmp_path, monkeypatch):
    """Both packages' on-disk trace caches under the test's directory;
    the examples' artifacts written there too."""
    monkeypatch.setenv("REPRO_TRACE_CACHE_DIR", str(tmp_path / "j_tc"))
    monkeypatch.setenv("REPRO_TORCH_TRACE_CACHE_DIR", str(tmp_path / "t_tc"))
    monkeypatch.chdir(tmp_path)


def _reference(name: str, argv, monkeypatch) -> str:
    """`examples/<name>.py` run as a script; its stdout."""
    path = os.path.join(ROOT, "examples", f"{name}.py")
    monkeypatch.setattr(sys, "argv", [path] + list(argv))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        try:
            runpy.run_path(path, run_name="__main__")
        except SystemExit as e:
            assert not e.code, e.code
    return buf.getvalue()


def _load(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port(name: str, argv):
    """`examples/<name>_torch.py`'s `main` on the CPU, loaded afresh (so
    that it binds what the test patched); (stdout, its return value)."""
    mod = _load(os.path.join(ROOT, "examples", f"{name}_torch.py"),
                f"{name}_torch")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = mod.main(list(argv) + ["--device", "cpu"])
    return buf.getvalue(), out


def _same_table(name: str, ref: str, port: str) -> list:
    want = chip_smoke.example_table(name, ref)
    got = chip_smoke.example_table(name, port)
    assert got == want, "\n".join(
        f"{'=' if a == b else '!'} {a!r}\n  {b!r}"
        for a, b in zip(got, want)) + f"\n({len(got)} vs {len(want)})"
    assert want
    return want


def _cut_kw(monkeypatch, module, fn: str, **kw):
    """`module.fn` called with `kw` forced over the caller's."""
    real = getattr(module, fn)

    @functools.wraps(real)
    def cut(*a, **k):
        return real(*a, **{**k, **kw})
    monkeypatch.setattr(module, fn, cut)


def test_ssd_repro_table_equals_reference(monkeypatch):
    """hm_0 under the four policies and both modes (8 cells of the
    fleet), `run_matrix` cut to MAX_OPS in both packages: the normalized
    table and the means equal, letter for letter."""
    for mod in (j_runner, t_runner):
        _cut_kw(monkeypatch, mod, "run_matrix", max_ops=MAX_OPS)
    ref = _reference("ssd_repro", ["--workloads", "hm_0"], monkeypatch)
    port, results = _port("ssd_repro", ["--workloads", "hm_0"])
    lines = _same_table("ssd_repro", ref, port)
    assert len(results) == 8 and any("means" in ln for ln in lines)


def test_quickstart_lines_equal_reference(monkeypatch):
    """The four SSD cells (the driver's traces truncated to MAX_OPS in
    both packages) and the KV line equal; the train line's loss and
    gradient norm finite (the weights differ: `torch.Generator`s, not
    `jax.random`)."""
    real_j, real_t = j_driver.make_trace, t_driver.make_trace
    monkeypatch.setattr(j_driver, "make_trace", lambda *a, **k: j_truncate(
        real_j(*a, **k), MAX_OPS))
    monkeypatch.setattr(t_driver, "make_trace", lambda *a, **k: t_truncate(
        real_t(*a, **k), MAX_OPS))
    ref = _reference("quickstart", [], monkeypatch)
    port, out = _port("quickstart", [])
    lines = _same_table("quickstart", ref, port)
    assert len(lines) == 3 and lines[-1].startswith("[kv] decoded 16")
    assert out["kv"]["repack_tokens"] > 0 and out["tokens"].shape == (2, 16)
    assert math.isfinite(out["loss"]) and math.isfinite(out["grad_norm"])
    assert any(ln.startswith("[train] gemma-2b loss=")
               for ln in port.splitlines())


def test_serve_ips_table_equals_reference(monkeypatch):
    """yi-6b reduced (the default arch) under the four policies, 24
    decode steps: WA, stalls, repacked and HBM MiB equal."""
    ref = _reference("serve_ips", ["--decode", "24"], monkeypatch)
    port, out = _port("serve_ips", ["--decode", "24"])
    lines = _same_table("serve_ips", ref, port)
    assert lines[0].startswith("yi-6b: batch=4 prompt=32 decode=24")
    assert set(out) == {"BASELINE", "IPS", "IPS_AGC", "COOP"}
    assert out["IPS_AGC"]["stall_events"] == 0


def test_host_cache_sections_equal_reference(monkeypatch):
    """flush_burst cut to 200 ops and padded to 256 (`ir.PAD_OPS` in
    both packages: the host tier steps every padded op), windows of 32:
    the three sections equal, the cliff lines among them."""
    for ir in (j_ir, t_ir):
        monkeypatch.setattr(ir, "PAD_OPS", 256)
    argv = ["--max-ops", "200", "--window-ops", "32"]
    ref = _reference("host_cache", argv, monkeypatch)
    port, out = _port("host_cache", argv)
    lines = _same_table("host_cache", ref, port)
    assert any("device cliff" in ln for ln in lines)
    assert out["wb:watermark"]["hit"] > 0
    assert out["wb:watermark"]["dev_w"] < out["off"]["dev_w"]


def test_sweep_fleet_table_equals_reference(monkeypatch, tmp_path):
    """The 28-cell sweep at `--max-ops` MAX_OPS: the normalized table
    and geomeans equal; the port writes `BENCH_torch_example_sweep.json`
    (and never the reference's name) through its store."""
    ref = _reference("sweep_fleet", ["--devices", "1", "--max-ops",
                                     str(MAX_OPS)], monkeypatch)
    os.remove(tmp_path / "BENCH_example_sweep.json")
    port, results = _port("sweep_fleet", ["--max-ops", str(MAX_OPS)])
    lines = _same_table("sweep_fleet", ref, port)
    assert len(results) == 28 and "geomeans (unqualified cells):" in lines
    assert not (tmp_path / "BENCH_example_sweep.json").exists()
    with open(tmp_path / "BENCH_torch_example_sweep.json") as f:
        doc = json.load(f)
    assert len(doc["results"]) == 28 and doc["meta"]["device"] == "cpu"


@pytest.mark.parametrize("how", ["script", "loaded"])
def test_sweep_fleet_two_ranks_equal_one(how):
    """`--devices 2` (two gloo ranks, each its slice of the cells) gives
    the one-rank results: run as a script, its printed table; loaded by
    path as the other tests load it (not importable by name), `main`'s
    return value."""
    argv = ["--max-ops", str(MAX_OPS)]
    one_text, one = _port("sweep_fleet", argv)
    if how == "script":
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
        out = subprocess.run(
            [sys.executable, os.path.join(ROOT, "examples",
                                          "sweep_fleet_torch.py"),
             "--devices", "2", "--device", "cpu", *argv],
            env=env, capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr[-4000:]
        assert (chip_smoke.example_table("sweep_fleet", out.stdout)
                == chip_smoke.example_table("sweep_fleet", one_text))
    else:
        _, two = _port("sweep_fleet", ["--devices", "2"] + argv)
        assert two == one and len(two) == 28


def test_workload_zoo_table_equals_reference(monkeypatch):
    """The zoo (every MSR trace, every scenario, the fixture file and its
    twin, the IR transforms) and `--simulate`'s six cells, `run_sweep`
    cut to MAX_OPS in both packages (the port's example binds it at
    load)."""
    for mod in (j_runner, t_runner):
        _cut_kw(monkeypatch, mod, "run_sweep", max_ops=MAX_OPS)
    ref = _reference("workload_zoo", ["--simulate"], monkeypatch)
    port, rc = _port("workload_zoo", ["--simulate"])
    lines = _same_table("workload_zoo", ref, port)
    assert rc == 0 and lines[0] == "== synthetic MSR set (published stats) =="
    assert sum(" lat=" in ln for ln in lines) == 6
    assert any(ln.startswith("sample_msr.csv") for ln in lines)


def test_train_lm_matches_reference_and_resumes(monkeypatch, tmp_path):
    """Both launchers at a cut size (1 layer, d_model 64, 2 steps of 2 x
    32 tokens): the same model (the `arch=... params=` line); the port's
    losses finite, its checkpoint directory its own, and a second call
    resuming at the saved step."""
    cut = ["--d-model", "64", "--layers", "1", "--vocab", "256", "--batch",
           "2", "--seq", "32", "--log-every", "1", "--ckpt-every", "1"]
    ref = _reference("train_lm", cut + ["--steps", "2", "--ckpt-dir",
                                        str(tmp_path / "j_ckpt")],
                     monkeypatch)
    port, out = _port("train_lm", cut + ["--steps", "2", "--ckpt-dir",
                                         str(tmp_path / "t_ckpt")])
    _same_table("train_lm", ref, port)
    assert out["start_step"] == 0 and len(out["losses"]) == 2
    assert all(math.isfinite(v) for v in out["losses"])
    _, again = _port("train_lm", cut + ["--steps", "3", "--ckpt-dir",
                                        str(tmp_path / "t_ckpt")])
    assert again["start_step"] == 2 and len(again["losses"]) == 1
    mod = _load(os.path.join(ROOT, "examples", "train_lm_torch.py"), "tl")
    assert "/tmp/repro_torch_train_lm" in mod.DEFAULTS
    assert "/tmp/repro_train_lm" not in mod.DEFAULTS


def _smoke_models():
    return _load(os.path.join(ROOT, "scripts", "smoke_models_torch.py"),
                 "smoke_models_torch")


def test_smoke_models_passes_every_arch_on_the_cpu(capsys):
    from repro_torch.configs import ARCHS
    smoke = _smoke_models()
    assert smoke.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.rstrip().endswith("failures: none")
    for name in ARCHS:
        assert f"OK   {name} " in out, name


def test_smoke_models_fails_a_family_with_a_planted_fault(monkeypatch,
                                                         capsys):
    """`ssd_intra` returning NaN: mamba2 fails (exit 1, named), gemma-2b
    still passes."""
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    real = ssd_ops.ssd_intra

    def nan_intra(*a, **k):
        return tuple(torch.full_like(t, float("nan")) if t.is_floating_point()
                     else t for t in real(*a, **k))
    monkeypatch.setattr(ssd_ops, "ssd_intra", nan_intra)
    smoke = _smoke_models()
    assert smoke.main(["--device", "cpu", "gemma-2b", "mamba2-370m"]) == 1
    out = capsys.readouterr().out
    assert "OK   gemma-2b " in out and "FAIL mamba2-370m" in out
    assert "failures: ['mamba2-370m']" in out


def test_smoke_models_names_each_family_kernel():
    """What the card's run requires of each arch's launches."""
    from repro_torch.configs import ARCHS
    from repro_torch.models.model_zoo import build_model
    smoke = _smoke_models()
    need = {name: smoke.family_kernels(
        ARCHS[name], build_model(ARCHS[name].reduced(),
                                 device="cpu").cache_kind)
        for name in ARCHS}
    assert need["gemma-2b"] == need["yi-6b"] == need["whisper-tiny"] == (
        "flash_fwd", "tiered_decode")
    assert need["deepseek-v2-lite-16b"] == ("flash_fwd", "latent_decode")
    assert need["mamba2-370m"] == ("ssd_intra",)
    assert need["zamba2-1.2b"] == ("flash_fwd", "ssd_intra")
