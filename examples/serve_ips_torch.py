"""End-to-end serving driver on the PyTorch / CUDA port (the counterpart
of `examples/serve_ips.py`): batched requests decoded under all four
cache-reclamation policies, reporting the serving analogues of the
paper's metrics.

The hot window is deliberately small relative to the decode length so
the policies differentiate: BASELINE migrates in bursts (stalls + 2x
traffic), IPS switches in place on fill (stalls, 1x), IPS_AGC densifies
in the background (no stalls), COOP runs an enlarged window. On the card
the prefill runs `flash_fwd`, each step `tiered_decode`, each fill or
repack event `ips_repack`. WA, stalls, repacked tokens and HBM MiB do
not depend on the weights (drawn from a seeded `torch.Generator`).

Run: PYTHONPATH=src python examples/serve_ips_torch.py [--decode 96] \\
         [--device cpu]
"""
import argparse

import torch

from repro_torch.configs import get_arch
from repro_torch.core.tiercache.policy import Policy
from repro_torch.models.model_zoo import build_model, make_train_batch
from repro_torch.serve.engine import decode_loop, make_tier_spec


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--decode", type=int, default=72)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device (use --device cpu "
                         "for the kernels' plain versions)")

    cfg = get_arch(args.arch).reduced()
    bundle = build_model(cfg, device=dev)
    params = bundle.init(torch.Generator(device=dev).manual_seed(0))
    batch = make_train_batch(cfg, args.batch, args.prompt_len,
                             torch.Generator(device=dev).manual_seed(0))

    logical_per_tok = (cfg.num_layers * 2 * cfg.num_kv_heads * cfg.head_dim
                       * 2 * args.batch)
    print(f"{cfg.name}: batch={args.batch} prompt={args.prompt_len} "
          f"decode={args.decode}")
    print(f"{'policy':<10}{'WA':>7}{'stalls':>8}{'repacked':>10}"
          f"{'hbm MiB':>9}")
    out = {}
    for policy in (Policy.BASELINE, Policy.IPS, Policy.IPS_AGC, Policy.COOP):
        spec = make_tier_spec(bundle, args.prompt_len + args.decode, policy,
                              hot_window=16, page_tokens=8, group=16)
        cache, logits = bundle.prefill(params, batch, spec)
        first = torch.argmax(logits, -1).to(torch.int32)[:, None]
        tokens, cache, m = decode_loop(bundle, params, cache, first,
                                       args.decode, spec, policy)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wa = float(m["hbm_write_bytes"]) / max(
            float(m["appended_tokens"]) * logical_per_tok, 1.0)
        print(f"{policy.name:<10}{wa:>7.2f}"
              f"{float(m['stall_events']):>8.0f}"
              f"{float(m['repack_tokens']):>10.0f}"
              f"{float(m['hbm_write_bytes'])/2**20:>9.2f}")
        out[policy.name] = {"wa": wa, "tokens": tokens,
                            **{k: float(v) for k, v in m.items()}}
    return out


if __name__ == "__main__":
    main()
