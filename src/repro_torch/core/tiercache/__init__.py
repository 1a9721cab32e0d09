"""The tiered KV cache of the serving path: int4 dense tier (the TLC
analogue) + bf16 hot window (the SLC analogue), the in-place switch
between them, and the paper's four reclamation policies."""
from repro_torch.core.tiercache.quant import (DENSITY_RATIO, dequantize_int4,
                                              quantize_int4)

__all__ = ["DENSITY_RATIO", "dequantize_int4", "quantize_int4"]
