"""Serving engine: prefill + greedy decode over the tiered KV cache."""
