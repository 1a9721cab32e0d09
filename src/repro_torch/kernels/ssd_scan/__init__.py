"""The `ssd_intra` kernel: the Mamba2 SSD intra-chunk contraction.

  csrc/ssd_intra.cu — the CUDA kernel for sm_90a
  ops.py            — wrapper (build, checks, launch, launch count) and
                      the chunked scan around it (`ssd_chunked_kernel`)
  ref.py            — plain version (`intra_chunk_ref`)
"""
