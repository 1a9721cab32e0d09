#!/usr/bin/env python
"""Dev smoke on the PyTorch / CUDA port (the counterpart of
`scripts/smoke_models.py`): the reduced config of every arch in
`repro_torch.configs.ARCHS` — loss, prefill, decode, and `serve_tick`
for the `gqa`, `mla` and `encdec_self` cache kinds.

On the card (the default) it also reads each kernel's launch count
around each arch and fails an arch whose family's kernels did not
launch: `flash_fwd` for every family with attention, `tiered_decode`
for the `gqa` and `encdec_self` kinds, its latent form
(`latent_decode`) for `mla`, `ssd_intra` for the Mamba2 layers (mamba2,
zamba2). `--device cpu` runs the kernels' plain versions and checks no
counts. Prints one line an arch; the exit code is 1 when any arch
failed, with the failing names.

    PYTHONPATH=src python scripts/smoke_models_torch.py [--device cpu] \\
        [arch ...]
"""
from __future__ import annotations

import argparse
import sys
import traceback

import torch

from repro_torch.configs import ARCHS
from repro_torch.core.tiercache.manager import serve_tick, zero_metrics
from repro_torch.core.tiercache.policy import Policy
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.ips_repack import ops as repack_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.tiered_attention import ops as tiered_ops
from repro_torch.models.model_zoo import (build_model, default_tier_spec,
                                          make_train_batch)

LAUNCHERS = {"flash_fwd": flash_ops.LAUNCHER,
             "tiered_decode": tiered_ops.LAUNCHER,
             "latent_decode": tiered_ops.LATENT_LAUNCHER,
             "ips_repack": repack_ops.LAUNCHER,
             "ssd_intra": ssd_ops.LAUNCHER}
TICKED = ("gqa", "mla", "encdec_self")


def family_kernels(cfg, kind: str) -> tuple:
    """The kernels an arch's smoke must launch on the card."""
    need = []
    if cfg.family != "ssm":
        need.append("flash_fwd")
    if kind in ("gqa", "encdec_self"):
        need.append("tiered_decode")
    if kind == "mla":
        need.append("latent_decode")
    if cfg.ssm is not None:
        need.append("ssd_intra")
    return tuple(need)


def smoke(name: str, dev: torch.device) -> dict:
    """One arch: returns its loss and the launches of each kernel it
    made; raises on a failed check."""
    cfg = ARCHS[name].reduced()
    before = {k: v.launches for k, v in LAUNCHERS.items()}
    bundle = build_model(cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = bundle.init(gen)
    batch = make_train_batch(cfg, 2, 64, gen)
    with torch.no_grad():
        loss, _ = bundle.loss(params, batch)
        if not torch.isfinite(loss):
            raise AssertionError(f"loss not finite: {float(loss)}")
        spec = default_tier_spec(64, hot_window=16, page_tokens=8, group=16)
        cache, logits = bundle.prefill(params, batch, spec)
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError("prefill logits not finite")
        token = torch.ones((2, 1), dtype=torch.int32, device=dev)
        logits2, kv_new = bundle.decode(params, token, cache, spec)
        if not bool(torch.isfinite(logits2).all()):
            raise AssertionError("decode logits not finite")
        if bundle.cache_kind in TICKED:
            cache2, _ = serve_tick(cache, bundle.cache_kind, spec,
                                   Policy.IPS_AGC, kv_new, zero_metrics())
            if int(cache2["total_len"]) != int(cache["total_len"]) + 1:
                raise AssertionError("serve_tick did not append the token")
    launches = {k: v.launches - before[k] for k, v in LAUNCHERS.items()}
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        missing = [k for k in family_kernels(cfg, bundle.cache_kind)
                   if launches[k] == 0]
        if missing:
            raise AssertionError(f"{', '.join(missing)} never launched "
                                 f"(launches {launches})")
    return {"loss": float(loss), "kind": bundle.cache_kind,
            "launches": launches}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("archs", nargs="*", help="default: every arch")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("--device cuda: no CUDA device (use --device cpu for the "
              "kernels' plain versions)", file=sys.stderr)
        return 2
    failures = []
    for name in args.archs or list(ARCHS):
        try:
            out = smoke(name, dev)
            counted = {k: n for k, n in out["launches"].items() if n}
            print(f"OK   {name:24s} loss={out['loss']:.3f}"
                  + (f" launches={counted}" if dev.type == "cuda" else ""),
                  flush=True)
        except Exception as e:  # noqa: BLE001 — one arch's failure is
            # reported and the others still run
            failures.append(name)
            print(f"FAIL {name}: {type(e).__name__}: {e}", flush=True)
            traceback.print_exc(limit=8)
    print("failures:", failures or "none", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
