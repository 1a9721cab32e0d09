"""Record the reference examples' printed output at the flags with which
`chip_smoke.py` (phase 14) runs their PyTorch counterparts on the card.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/record_torch_reference_examples.py \\
        [--out tests/data/torch_reference_examples.json]

Runs each `examples/<name>.py` of the reference package live on the CPU
(JAX), each in its own process from a scratch directory (the sweep
example writes its artifact into the working directory), and writes per
example its flags and its stdout. `chip_smoke.example_table` picks from
both sides the lines that must be equal: the simulator's tables and the
serving counters. Some 10 minutes on two cores.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the reference example's flags, as phase 14 gives the port's (the sweep
# example's `--devices` is its XLA host devices: 2 here, 1 rank there;
# its table does not depend on either)
EXAMPLES = {
    "ssd_repro": [],
    "quickstart": [],
    "serve_ips": [],
    "host_cache": [],
    "sweep_fleet": ["--devices", "2"],
    "workload_zoo": ["--simulate"],
}


def run(name: str, argv: list) -> str:
    """`examples/<name>.py argv` in a fresh process; its stdout."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src"))
    with tempfile.TemporaryDirectory(prefix="ref_example_") as tmp:
        env["REPRO_TRACE_CACHE_DIR"] = os.path.join(tmp, "traces")
        out = subprocess.run(
            [sys.executable, os.path.join(ROOT, "examples", f"{name}.py"),
             *argv], cwd=tmp, env=env, capture_output=True, text=True,
            timeout=3600)
    if out.returncode:
        raise SystemExit(f"examples/{name}.py failed ({out.returncode}):\n"
                         f"{out.stderr[-4000:]}")
    return out.stdout


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(
        ROOT, "tests", "data", "torch_reference_examples.json"))
    args = ap.parse_args(argv)
    doc = {"examples": {}}
    for name, flags in EXAMPLES.items():
        stdout = run(name, flags)
        doc["examples"][name] = {"argv": flags, "stdout": stdout}
        print(f"{name}: {len(stdout.splitlines())} lines", flush=True)
    doc["note"] = ("stdout of the reference examples (JAX on the CPU) at "
                   "the flags given; chip_smoke.py phase 14 holds the "
                   "port's examples to them")
    with open(args.out, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
