"""Shared model layers: norms, RoPE, MLPs, embeddings, the chunked
cross-entropy (the port of the reference's `repro/models/layers.py`), and
`checkpointed`, the port's form of `jax.checkpoint`.

Params are nested dicts of tensors; every layer is a plain function.
Compute dtype is the config dtype (bf16) with float32 for normalization
statistics, RoPE and the loss, as in the reference. Weights are drawn
from a `torch.Generator`, whose device is the parameters' device.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

__all__ = ["init_dense", "rms_norm", "rope_frequencies", "apply_rope",
           "init_mlp", "apply_mlp", "init_embedding", "embed",
           "checkpointed", "chunked_softmax_xent"]


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
    if out.is_meta:             # shapes alone (launch.specs): no draws
        return out
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


def checkpointed(fn):
    """fn under activation checkpointing, the port of `jax.checkpoint`:
    while autograd records, only fn's inputs are kept and its inside is
    recomputed in the backward (`torch.utils.checkpoint`, non-reentrant,
    so fn may take and return nested structures); otherwise fn itself."""
    def call(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return torch.utils.checkpoint.checkpoint(fn, *args,
                                                 use_reentrant=False)
    return call


def _xent_piece(h_c, unembed, y_c, m_c):
    logits = (h_c @ unembed).to(torch.float32)               # (B, c, V)
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, y_c[..., None].long())[..., 0]
    nll = (logz - gold) * m_c
    return nll.sum(), m_c.sum()


def chunked_softmax_xent(hidden, unembed, labels, mask=None,
                         chunk: int = 512):
    """Cross-entropy without materializing (B, S, V) logits.

    hidden: (B, S, D); unembed: (D, V); labels: (B, S) int; mask: (B, S)
    float or None. The sequence goes in chunks of `chunk` positions (all
    rows at once), then the remainder piece, summed in that order; each
    piece is checkpointed, so the backward holds one piece's (B, chunk,
    V) float32 logits at a time. Returns the mean over the mask."""
    b, s, _ = hidden.shape
    chunk = min(chunk, s)
    n = s // chunk
    if mask is None:
        mask = torch.ones((b, s), dtype=torch.float32, device=hidden.device)
    piece = checkpointed(_xent_piece)
    loss = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    bounds = [(i * chunk, (i + 1) * chunk) for i in range(n)]
    if s > n * chunk:
        bounds.append((n * chunk, s))
    for lo, hi in bounds:
        l_c, c_c = piece(hidden[:, lo:hi], unembed, labels[:, lo:hi],
                         mask[:, lo:hi])
        loss = loss + l_c
        cnt = cnt + c_c
    return loss / torch.clamp(cnt, min=1.0)
