"""The `tiered_decode` kernel: one decode query against the int4 dense
tier, dequantization fused, online-softmax partials out.

  csrc/tiered_decode.cu — the CUDA kernel for sm_90a
  ops.py                — wrapper (build, checks, launch, launch count)
                          and the merge with the hot tail and the token
  ref.py                — plain version and the merge of partials
"""
