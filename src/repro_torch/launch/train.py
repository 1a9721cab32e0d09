"""Training launcher: an end-to-end driver with checkpoint and restart
(the port of the reference's `repro/launch/train.py`, with the same flags
plus `--device` and `--seed`).

It trains from random weights drawn from `--seed` on the synthetic token
stream (`data.pipeline`, seeded by `--seed` too); a VLM's patches and an
encoder-decoder's frames, the stub frontends' outputs, are random
embeddings drawn per step from the same seed. Checkpoints every
`--ckpt-every` steps (written on a worker thread, stored: `CKPT_LEVEL`)
and resumes from the latest checkpoint in `--ckpt-dir` by itself: the
data pipeline is a pure function of the step, so a resumed run replays
the batches it would have seen.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \\
      --reduced --device cpu --steps 4
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \\
      --steps 10 --batch 2 --seq 2048
  PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b --reduced \\
      --steps 100 --batch 8 --seq 256 --ckpt-dir /tmp/ckpt --device cpu
"""
from __future__ import annotations

import argparse
import functools
import os
import time

import torch

from repro_torch.checkpoint import ckpt as ckpt_lib
from repro_torch.configs import get_arch
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.models.model_zoo import build_model, make_train_batch
from repro_torch.optim.schedules import cosine_with_warmup
from repro_torch.train.train_step import make_train_state, make_train_step

__all__ = ["main", "parser"]

# the checkpoints' zlib level: 0, stored. The reference writes zstd at
# level 3, some 400 MB/s; zlib, the port's stand-in (no zstandard on the
# card's machine), deflates a float state at some 20 MB/s to 93% of its
# size: a minute a save for a ~150M-parameter AdamW state
CKPT_LEVEL = 0


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="Train a model of the zoo on the synthetic stream.")
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--reduced", action="store_true",
                    help="use the reduced (smoke) config — CPU friendly")
    ap.add_argument("--d-model", type=int, default=None,
                    help="override reduced d_model (e.g. for ~100M runs)")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--vocab", type=int, default=None)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--moe-dispatch", default="gather")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds the weights and the data stream")
    return ap


def _config(args):
    cfg = get_arch(args.arch)
    if args.reduced:
        overrides = {}
        if args.d_model:
            overrides.update(d_model=args.d_model, d_ff=4 * args.d_model,
                             num_heads=max(args.d_model // 64, 1),
                             num_kv_heads=max(args.d_model // 128, 1),
                             head_dim=64)
        if args.layers:
            overrides["num_layers"] = args.layers
        if args.vocab:
            overrides["vocab_size"] = args.vocab
        cfg = cfg.reduced(**overrides)
    return cfg


def _batch(cfg, data_cfg, step: int, seed: int, device):
    """The pipeline's tokens for `step`, plus the stub frontends'
    embeddings drawn from (seed, step) when the model takes them."""
    batch = make_batch(data_cfg, step, device=device)
    if cfg.vlm is not None or cfg.encdec is not None:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed * 1_000_003 + step)
        extra = make_train_batch(cfg, data_cfg.global_batch,
                                 data_cfg.seq_len, gen)
        batch.update({k: v for k, v in extra.items() if k != "tokens"})
    return batch


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    """Run the launcher; returns {"losses": per step run, "step_ms":
    host ms of each step run (synchronised), "start_step", "params"}."""
    args = parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device (use --device cpu "
                         "to run the kernels' plain versions)")
    cfg = _config(args)
    print(f"arch={cfg.name} params={cfg.param_count()/1e6:.1f}M "
          f"(active {cfg.active_param_count()/1e6:.1f}M)")

    bundle = build_model(cfg, moe_dispatch=args.moe_dispatch, device=device)
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                          global_batch=args.batch, seed=args.seed)
    schedule = functools.partial(cosine_with_warmup, peak_lr=args.lr,
                                 warmup_steps=max(args.steps // 10, 5),
                                 total_steps=args.steps)
    train_step = make_train_step(bundle, schedule=schedule,
                                 grad_accum=args.grad_accum)

    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    state = make_train_state(bundle, gen)
    start_step = 0
    if args.ckpt_dir and os.path.exists(
            os.path.join(args.ckpt_dir, "manifest.json")):
        state, start_step = ckpt_lib.restore(args.ckpt_dir, state)
        print(f"resumed from step {start_step}")

    pending, saved_step = None, None
    losses, step_ms = [], []
    metrics = None
    t0 = time.time()
    for step in range(start_step, args.steps):
        batch = _batch(cfg, data_cfg, step, args.seed, device)
        _sync(device)
        t_step = time.perf_counter()
        state, metrics = train_step(state, batch)
        loss = float(metrics["loss"])
        step_ms.append((time.perf_counter() - t_step) * 1e3)
        losses.append(loss)
        if (step + 1) % args.log_every == 0 or step == start_step:
            gn = float(metrics["grad_norm"])
            rate = (step + 1 - start_step) / (time.time() - t0)
            print(f"step {step+1:5d} loss={loss:.4f} gnorm={gn:.2f} "
                  f"lr={float(metrics['lr']):.2e} {rate:.2f} it/s",
                  flush=True)
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            if pending is not None:
                pending.result()
            pending = ckpt_lib.save_async(args.ckpt_dir, state,
                                          step=step + 1, level=CKPT_LEVEL)
            saved_step = step + 1
    if pending is not None:
        pending.result()
    if args.ckpt_dir:
        # the reference saves the final state again even when the last
        # step's checkpoint just wrote it; the port writes it once
        if saved_step != args.steps:
            ckpt_lib.save(args.ckpt_dir, state, step=args.steps,
                          level=CKPT_LEVEL)
        print(f"checkpoint at {args.ckpt_dir}")
    if metrics is not None:
        print(f"final loss {float(metrics['loss']):.4f}")
    return {"losses": losses, "step_ms": step_ms, "start_step": start_step,
            "params": cfg.param_count()}


if __name__ == "__main__":
    main()
