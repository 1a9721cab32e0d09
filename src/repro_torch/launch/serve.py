"""Serving launcher: prefill a batch of prompts, then decode with the IPS
tiered KV cache under a chosen reclamation policy, reporting the paper's
metrics (WA analogue, stalls). The port of the reference's
`repro/launch/serve.py`, with the same flags plus `--device` and
`--seed`; weights and prompts are random, drawn from the seed.

Usage (`--arch` takes any config: dense, moe, vlm, ssm, hybrid or the
encoder-decoder; for an ssm model, which has no KV cache, the policy
changes nothing; a VLM's patches and an encoder-decoder's frames are
random embeddings, the stub frontends' outputs):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch deepseek-v2-lite-16b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch arctic-480b \\
      --reduced --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-370m
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b \\
      --reduced --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-tiny
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-tiny \\
      --reduced --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llava-next-34b \\
      --reduced --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \\
      --reduced --device cpu --prompt-len 64 --decode 64 --policy ips_agc
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_arch
from repro_torch.core.tiercache.policy import Policy
from repro_torch.models.model_zoo import build_model, make_train_batch
from repro_torch.serve.engine import decode_loop, make_tier_spec


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--decode", type=int, default=32)
    ap.add_argument("--policy", default="ips_agc",
                    choices=[p.name.lower() for p in Policy])
    ap.add_argument("--hot-window", type=int, default=32)
    ap.add_argument("--page-tokens", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the kernels on the card) or cpu "
                         "(their plain versions)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run the "
                         "plain versions on the CPU")
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    policy = Policy[args.policy.upper()]
    bundle = build_model(cfg, device=device)
    # a VLM's patch embeddings take cache positions before the prompt
    prefix = cfg.vlm.num_patches if cfg.vlm is not None else 0
    spec = make_tier_spec(bundle, prefix + args.prompt_len + args.decode,
                          policy,
                          hot_window=args.hot_window,
                          page_tokens=args.page_tokens,
                          group=min(64, cfg.head_dim))

    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    params = bundle.init(gen)
    batch = make_train_batch(cfg, args.batch, args.prompt_len, gen)

    _sync(device)
    t0 = time.perf_counter()
    cache, logits = bundle.prefill(params, batch, spec)
    _sync(device)
    print(f"prefill {args.prompt_len} tokens x{args.batch}: "
          f"{time.perf_counter() - t0:.2f}s")

    first = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    t0 = time.perf_counter()
    tokens, cache, metrics = decode_loop(bundle, params, cache, first,
                                         args.decode, spec, policy)
    _sync(device)
    dt = time.perf_counter() - t0
    print(f"decoded {args.decode} tokens in {dt:.2f}s "
          f"({args.decode * args.batch / dt:.1f} tok/s)")
    print(f"policy={policy.name}: "
          f"hbm_write={float(metrics['hbm_write_bytes']) / 2**20:.2f}MiB "
          f"repacked={float(metrics['repack_tokens']):.0f} tok "
          f"stalls={float(metrics['stall_events']):.0f}")
    print("sample tokens:", tokens[0][:16].tolist())


if __name__ == "__main__":
    main()
