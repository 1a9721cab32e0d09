"""The `ips_repack` kernel: the in-place switch, bf16 -> int4 + scales.

  csrc/ips_repack.cu — the CUDA kernel for sm_90a (tier and arena forms)
  ops.py             — wrapper: build, checks, launch, launch count
  ref.py             — plain version
"""
