"""Model code of the serving path: the dense decoder family (gemma-2b and
its kin) over the tiered KV cache."""
