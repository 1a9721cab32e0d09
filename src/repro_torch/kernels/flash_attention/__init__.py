"""The `flash_fwd` kernel: causal GQA flash-attention forward (prefill).

  csrc/flash_fwd.cu — the CUDA kernel for sm_90a
  ops.py            — wrapper: build, checks, launch, launch count
  ref.py            — plain version (the chunked online softmax)
"""
