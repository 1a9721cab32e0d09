#!/usr/bin/env bash
# CI smoke gate of the PyTorch / CUDA port: the counterpart of each gate
# of scripts/ci_check.sh, run on the card by default.
#
# Usage: bash scripts/ci_check_torch.sh             # the card (sizes below)
#        DEVICE=cpu bash scripts/ci_check_torch.sh  # the kernels' plain
#                                                   # versions, cut sizes
# Runs from the repo root regardless of invocation directory. Every gate
# runs; the script prints each failed gate's name and exits 1 if any
# failed.
#
# The reference's gates and theirs here:
#   tier-1 pytest, workload tests -> DEVICE=cpu: the port's CPU tests,
#       tests/test_torch_*.py, against live JAX (the workload engine's
#       among them); on the card: the card's tests (-m cuda
#       tests/test_torch_cuda.py; the card's machine has no JAX)
#   quick grid, trace-file fixture, dyn_slc,ips_lazy registry smoke,
#   endurance grid, hostcache grid + store.check_hostcache_sweep, the
#   search smoke, the telemetry probe with its overhead gate (<= 1.25),
#   the history ledger's injected-regression gate -> the port's CLI,
#       store and history module at the same sizes
#   step-throughput smoke (compressed >= 3x per-op) -> bench_step_torch.py
#       --min-speedup 3 (store.check_step_throughput on the JSON it wrote)
#   committed BENCH_step_throughput.json / BENCH_history.json -> the port
#       commits no artifact (BENCH_torch_*.json are git-ignored run
#       outputs): the step JSON written above is checked, and the history
#       file this run appended to passes `history --check`
#   golden-monolith bit identities (ZeroWearIdentity,
#   OffPathGoldenIdentity), the segment-window identity (SegmentWindows)
#       -> no golden monolith in the port: tests/test_torch_endurance.py,
#       test_torch_hostcache*.py and test_torch_telemetry.py hold the same
#       paths against live JAX (in the CPU tests gate)
#   kernel interpret=True equivalence (FusedKernel) -> no interpret mode
#       for a CUDA kernel: its plain version against the kernel on the
#       card (-m cuda tests/test_torch_cuda.py, and chip_smoke.py)
#   segment telemetry overhead <= 1.3x (bench_step.py
#   --timeline-overhead-check) -> none: bench_step_torch.py has no probe;
#       the CLI's probe overhead is the telemetry gate above
set -uo pipefail
cd "$(dirname "$0")/.."

export PYTHONPATH="src${PYTHONPATH:+:$PYTHONPATH}"
DEVICE="${DEVICE:-cuda}"
if [ "$DEVICE" = cpu ]; then
  # the cut sizes of .claude/skills/verify/SKILL.md
  Q_OPS=2048; SMALL_OPS=2048; HC_OPS=512; STEP_OPS=64; SEARCH_OPS=256
  TL_OPS=2048; TL_WIN=64
else
  Q_OPS=8192; SMALL_OPS=4096; HC_OPS=4096; STEP_OPS=32768
  SEARCH_OPS=2048; TL_OPS=8192; TL_WIN=512
fi
CLI=(python -m repro_torch.sweep.cli --device "$DEVICE")
tmp=$(mktemp -d)
trap 'rm -rf "$tmp"' EXIT
failed=()
start=$(date +%s)

gate() {            # gate NAME COMMAND...: run it, record a failure
  local name=$1; shift
  echo
  echo "== $name =="
  local t0; t0=$(date +%s)
  if "$@"; then
    echo "-- $name: ok ($(( $(date +%s) - t0 )) s)"
  else
    echo "-- $name: FAILED ($(( $(date +%s) - t0 )) s)"
    failed+=("$name")
  fi
}

if [ "$DEVICE" = cpu ]; then
  if python -c "import xdist" 2>/dev/null; then
    XDIST=(-n "${WORKERS:-6}" --dist loadfile)
  else
    XDIST=()
  fi
  gate "port tests (CPU, against live JAX)" env JAX_PLATFORMS=cpu \
    python -m pytest -q "${XDIST[@]}" tests/test_torch_*.py
else
  gate "port tests (the card's)" python -m pytest -q -m cuda \
    tests/test_torch_cuda.py
fi

gate "smoke: 2-trace fleet sweep (quick grid, truncated traces)" \
  "${CLI[@]}" --grid quick --max-ops "$Q_OPS" --no-save

gate "smoke: real-trace fixture through the fleet path" \
  "${CLI[@]}" --trace-file tests/data/sample_msr.csv \
  --policies baseline,ips --modes daily --max-ops "$SMALL_OPS" --no-save

gate "smoke: policy registry (beyond-paper compositions)" \
  "${CLI[@]}" --grid quick --policies dyn_slc,ips_lazy \
  --max-ops "$SMALL_OPS" --no-save

gate "smoke: endurance grid (wear/reliability/lifetime)" \
  "${CLI[@]}" --grid endurance --max-ops "$SMALL_OPS" --no-save

hostcache_gate() {
  "${CLI[@]}" --grid hostcache --max-ops "$HC_OPS" --out-dir "$tmp/hc" \
    --no-history || return 1
  python - "$tmp/hc" <<'EOF'
import os, sys
from repro_torch.sweep.store import check_hostcache_sweep, load_bench
doc = check_hostcache_sweep(load_bench(
    os.path.join(sys.argv[1], "BENCH_torch_sweep_hostcache.json")))
print(f"hostcache artifact OK: {len(doc['results'])} cell(s), "
      f"{len(doc['hostcache'])} summary row(s)")
EOF
}
gate "smoke: host-tier cache grid (stacked block cache)" hostcache_gate

search_gate() {
  "${CLI[@]}" --search smoke --max-ops "$SEARCH_OPS" \
    --out-dir "$tmp/search" || return 1
  python - "$tmp/search" <<'EOF'
import json, os, sys
doc = json.load(open(os.path.join(sys.argv[1], "BENCH_torch_search.json")))
assert doc["front"], "BENCH_torch_search: empty Pareto front"
assert len(doc["rounds"]) == 2, "BENCH_torch_search: expected 2 rounds"
for r in doc["rounds"]:
    assert {"survivors", "compiles", "cells", "wall_s"} <= set(r), r
print(f"search artifact OK: {len(doc['front'])} front point(s), "
      f"round compiles {[r['compiles'] for r in doc['rounds']]}")
EOF
}
gate "smoke: search engine (tiny budget, 2 rounds)" search_gate

timeline_gate() {
  "${CLI[@]}" --grid quick --max-ops "$TL_OPS" --timeline "$TL_WIN" \
    --timeline-overhead-check --out-dir "$tmp/tl" || return 1
  python - "$tmp/tl" "$TL_WIN" <<'EOF'
import json, os, sys
doc = json.load(open(os.path.join(sys.argv[1], "BENCH_torch_timeline.json")))
assert doc["n_cells"] > 0 and doc["window_ops"] == int(sys.argv[2]), \
    doc["n_cells"]
for key, cell in doc["cells"].items():
    assert cell["n_windows"] > 0, key
    for k in ("ops", "writes", "lat_mean_ms", "lat_p50_ms", "lat_p99_ms",
              "occ_frac", "free_frac", "waf", "idle_ms", "t_end_ms",
              "host_w", "mig_w", "erases"):
        assert len(cell[k]) == cell["n_windows"], (key, k)
    cliff = cell["cliff"]
    assert {"detected", "window", "ratio", "steady_lat_ms",
            "time_to_cliff_ops", "recovery_slope"} <= set(cliff), key
assert doc["spans"], "BENCH_torch_timeline: empty span list"
# the sha itself is absent where the checkout is not a git repository
assert "git_sha" in doc["meta"], "BENCH_torch_timeline: no git sha field"
ovh = doc["overhead"]
assert ovh["ratio"] <= 1.25, \
    f"telemetry overhead gate: ratio {ovh['ratio']} > 1.25x " \
    f"(off {ovh['off_warm_s']}s -> on {ovh['on_warm_s']}s)"
print(f"timeline artifact OK: {doc['n_cells']} cell(s), "
      f"{doc['n_cliffs']} cliff(s), overhead ratio {ovh['ratio']}")
EOF
}
gate "smoke: telemetry engine (timeline + overhead gate)" timeline_gate

history_gate() {
  mkdir -p "$tmp/hist"
  python - "$tmp/hist" <<'EOF'
import sys
from repro_torch.telemetry import history

d = sys.argv[1]
for ops in (1000.0, 1040.0, 980.0):
    history.append_record("sweep", "ci:smoke", directory=d, ops_per_s=ops,
                          geomeans={"hm_0/wa_paper": 1.5}, git_sha="ci")
assert history._main(["--path", d, "--check"]) == 0, \
    "history gate: steady series flagged as regression"
# injected 2x slowdown must be caught
history.append_record("sweep", "ci:smoke", directory=d, ops_per_s=500.0,
                      geomeans={"hm_0/wa_paper": 1.5}, git_sha="ci")
assert history._main(["--path", d, "--check"]) == 1, \
    "history gate: injected 2x slowdown NOT caught"
fails = history.check_regression(history.load_history(d)["records"])
assert fails and "throughput" in fails[0], fails
print(f"history gate OK: injected 2x slowdown caught ({fails[0]})")
EOF
}
gate "perf history: ledger smoke + injected-regression gate" history_gate

step_gate() {
  python scripts/bench_step_torch.py --device "$DEVICE" \
    --traces hm_0,proj_0 --max-ops "$STEP_OPS" --out-dir "$tmp/step" \
    --min-speedup 3 || return 1
  python -m repro_torch.telemetry.history --path "$tmp/step" --check
}
gate "step engine: throughput smoke (compressed >= 3x per-op)" step_gate

echo
echo "ci_check_torch ($DEVICE): $(( $(date +%s) - start )) s"
if [ ${#failed[@]} -ne 0 ]; then
  printf 'ci_check_torch: FAILED: %s\n' "${failed[@]}"
  exit 1
fi
echo "ci_check_torch: OK"
