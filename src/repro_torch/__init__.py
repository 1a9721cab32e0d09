"""PyTorch / CUDA port of the hybrid-SSD simulator (`repro`).

The package mirrors the reference package's layout and names, imports
`torch` and numpy only, and keeps its own copies of the reference's
pure-Python pieces. Entry points take a `device` argument and default to
the CUDA device; the CPU runs the kernels' plain versions.
"""
