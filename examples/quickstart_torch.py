"""Quickstart on the PyTorch / CUDA port: the three layers of this
framework (the counterpart of `examples/quickstart.py`).

1. The paper, faithfully: simulate a hybrid 3D SSD under the baseline
   Turbo-Write cache vs In-place Switch (IPS) (`ssd_step` on the card).
2. The paper's idea on the card: a decode over the IPS tiered KV cache
   (`flash_fwd` for the prefill, `tiered_decode` a step, `ips_repack`
   for the in-place switch).
3. The substrate: one training step of an assigned architecture
   (`flash_fwd` under its autograd Function).

The weights are drawn from seeded `torch.Generator`s on the device (the
reference's `jax.random.PRNGKey(0)` and `(1)` become seeds 0 and 1; the
two give other numbers, so the train line's loss differs from the
reference's, while the SSD numbers and the KV line do not depend on the
weights).

Run: PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse

import torch

from repro_torch.configs import get_arch
from repro_torch.configs.ssd_paper import PAPER_SSD
from repro_torch.core.ssd.driver import eval_cell
from repro_torch.core.tiercache.policy import Policy
from repro_torch.models.model_zoo import build_model, make_train_batch
from repro_torch.serve.engine import decode_loop, make_tier_spec
from repro_torch.train.train_step import make_train_state, make_train_step


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device (use --device cpu "
                         "for the kernels' plain versions)")

    # --- 1. faithful SSD simulation -------------------------------------
    ssd = PAPER_SSD.scaled(128)            # proportionally scaled drive
    base = eval_cell(ssd, "hm_0", "baseline", "bursty", device=dev)
    ips = eval_cell(ssd, "hm_0", "ips", "bursty", device=dev)
    print(f"[ssd] bursty hm_0: baseline {base['mean_write_latency_ms']:.2f} "
          f"ms -> IPS {ips['mean_write_latency_ms']:.2f} ms "
          f"({ips['mean_write_latency_ms']/base['mean_write_latency_ms']:.2f}"
          f"x, paper: 0.77x)")

    base_d = eval_cell(ssd, "hm_0", "baseline", "daily", device=dev)
    ips_d = eval_cell(ssd, "hm_0", "ips", "daily", device=dev)
    print(f"[ssd] daily hm_0 WA: baseline {base_d['wa_paper']:.2f} -> IPS "
          f"{ips_d['wa_paper']:.2f} "
          f"({ips_d['wa_paper']/base_d['wa_paper']:.2f}x, paper: 0.53x)")

    # --- 2. the idea on the card: tiered KV cache decode -----------------
    cfg = get_arch("gemma-2b").reduced()
    bundle = build_model(cfg, device=dev)
    params = bundle.init(torch.Generator(device=dev).manual_seed(0))
    spec = make_tier_spec(bundle, 128, Policy.IPS_AGC, hot_window=32,
                          page_tokens=8, group=16)
    gen = torch.Generator(device=dev).manual_seed(0)
    cache, logits = bundle.prefill(params, make_train_batch(cfg, 2, 48, gen),
                                   spec)
    first = torch.argmax(logits, -1).to(torch.int32)[:, None]
    tokens, cache, metrics = decode_loop(bundle, params, cache, first, 16,
                                         spec, Policy.IPS_AGC)
    print(f"[kv] decoded 16 tokens; background-repacked "
          f"{float(metrics['repack_tokens']):.0f} tokens in place, "
          f"stalls={float(metrics['stall_events']):.0f}")

    # --- 3. substrate: one training step -----------------------------------
    state = make_train_state(bundle,
                             torch.Generator(device=dev).manual_seed(1))
    step = make_train_step(bundle)
    state, m = step(state, make_train_batch(cfg, 2, 64, gen))
    print(f"[train] {cfg.name} loss={float(m['loss']):.3f} "
          f"gnorm={float(m['grad_norm']):.2f}")
    return {"ssd": {"bursty": (base, ips), "daily": (base_d, ips_d)},
            "kv": {k: float(metrics[k]) for k in ("repack_tokens",
                                                  "stall_events")},
            "tokens": tokens, "loss": float(m["loss"]),
            "grad_norm": float(m["grad_norm"])}


if __name__ == "__main__":
    main()
