"""The `ssd_step` kernel: a fleet's op streams and pad tails in one launch.

  csrc/ssd_step.cu — the CUDA kernel for sm_90a
  ops.py           — wrapper: build, load, checks, launch, launch count
  ref.py           — plain version: the engine's executors in a loop
"""
