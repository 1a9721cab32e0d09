"""The `host_tier` kernel: the host-tier block cache in front of the
simulator, every host cell of a grid in one launch.

  csrc/host_tier.cu — the CUDA kernel for sm_90a
  ops.py            — wrapper: build, load, checks, launch, launch count
  ref.py            — plain version: the reference's tier decisions,
                      one trace op at a time
"""
