"""End-to-end training example on the PyTorch / CUDA port (the
counterpart of `examples/train_lm.py`): train an LM for a few hundred
steps with checkpoint/restart.

The defaults below are the reference example's (a ~10M model, 200
steps); the checkpoints go to /tmp/repro_torch_train_lm, never the
reference's directory. The ~100M run on the card (yi-6b's layout at
d_model 768, 12 layers, a 32,000 vocab; batch 32 x 512 tokens):

  PYTHONPATH=src python examples/train_lm_torch.py --d-model 768 \\
      --layers 12 --vocab 32000 --steps 300 --batch 32 --seq 512

This is the same driver as `repro_torch.launch.train` — the kernels on
the card (`flash_fwd` under its autograd Function), checkpoints written
on a worker thread, the stateless-resumable data pipeline; `--device
cpu` runs the kernels' plain versions.
"""
import sys

from repro_torch.launch.train import main as train_main

DEFAULTS = ["--arch", "yi-6b", "--reduced", "--d-model", "256",
            "--layers", "4", "--vocab", "2048", "--steps", "200",
            "--batch", "8", "--seq", "256", "--log-every", "20",
            "--ckpt-dir", "/tmp/repro_torch_train_lm", "--ckpt-every", "100"]


def main(argv=None) -> dict:
    """The launcher on DEFAULTS, then the caller's flags (later flags
    override); returns the launcher's summary."""
    return train_main(DEFAULTS + list(sys.argv[1:] if argv is None
                                      else argv))


if __name__ == "__main__":
    main()
