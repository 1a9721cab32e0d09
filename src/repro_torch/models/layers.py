"""Shared model layers: norms, RoPE, MLPs, embeddings (the port of the
reference's `repro/models/layers.py`; the chunked cross-entropy waits for
training).

Params are nested dicts of tensors; every layer is a plain function.
Compute dtype is the config dtype (bf16) with float32 for normalization
statistics and RoPE, as in the reference. Weights are drawn from a
`torch.Generator`, whose device is the parameters' device.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["init_dense", "rms_norm", "rope_frequencies", "apply_rope",
           "init_mlp", "apply_mlp", "init_embedding", "embed"]


def _normal(gen, shape, scale, dtype):
    return (scale * torch.randn(shape, generator=gen, dtype=torch.float32,
                                device=gen.device)).to(dtype)


def init_dense(gen, d_in: int, d_out, scale: float = 0.02,
               dtype=torch.bfloat16, n_stack=None):
    """Dense weight (d_in, *d_out), or (n_stack, d_in, *d_out) drawn one
    slice at a time."""
    shape = (d_in,) + (d_out if isinstance(d_out, tuple) else (d_out,))
    if n_stack is None:
        return _normal(gen, shape, scale, dtype)
    out = torch.empty((n_stack,) + shape, dtype=dtype, device=gen.device)
    for i in range(n_stack):
        out[i] = _normal(gen, shape, scale, dtype)
    return out


def rms_norm(x, weight, eps: float = 1e-5):
    xf = x.to(torch.float32)
    var = xf.square().mean(dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * (1.0 + weight.to(torch.float32))).to(x.dtype)


def rope_frequencies(head_dim: int, theta: float, device=None):
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x, positions, theta: float = 10_000.0):
    """x: (..., S, H, D) rotary over D (the two halves rotate, not
    interleaved pairs); positions: broadcastable to (..., S)."""
    d = x.shape[-1]
    inv_freq = rope_frequencies(d, theta, x.device)          # (d/2,)
    angles = positions[..., None].to(torch.float32) * inv_freq
    cos = torch.cos(angles)[..., None, :]                    # (..., S, 1, d/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def init_mlp(gen, d_model: int, d_ff: int, act: str, dtype=torch.bfloat16,
             n_stack=None):
    params = {"w_down": init_dense(gen, d_ff, d_model, dtype=dtype,
                                   n_stack=n_stack)}
    params["w_up"] = init_dense(gen, d_model, d_ff, dtype=dtype,
                                n_stack=n_stack)
    if act in ("silu", "geglu"):
        params["w_gate"] = init_dense(gen, d_model, d_ff, dtype=dtype,
                                      n_stack=n_stack)
    return params


def apply_mlp(params, x, act: str):
    if act == "silu":
        h = F.silu(x @ params["w_gate"]) * (x @ params["w_up"])
    elif act == "geglu":
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(x @ params["w_gate"], approximate="tanh") * (
            x @ params["w_up"])
    elif act == "relu2":
        h = torch.square(F.relu(x @ params["w_up"]))
    elif act == "gelu":
        h = F.gelu(x @ params["w_up"], approximate="tanh")
    else:
        raise ValueError(f"unknown act {act!r}")
    return h @ params["w_down"]


def init_embedding(gen, vocab: int, d_model: int, dtype=torch.bfloat16):
    return _normal(gen, (vocab, d_model), 0.02, dtype)


def embed(table, tokens):
    return table[tokens]
