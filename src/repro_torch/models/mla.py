"""DeepSeek Multi-head Latent Attention (the port of the reference's
`repro/models/mla.py`).

The KV cache holds only the compressed latent c_kv (rank r) plus a
shared RoPE key; the tiered cache quantizes the latent to int4 (the
`mla` cache kind), the RoPE key stays bf16.

The prefill materialises per-head K and V from the latent and runs the
causal attention through the `flash_fwd` kernel (q and k 192 wide, v
128 at deepseek's widths). Decode uses the absorbed form: W_uk is folded
into the query, so scores are taken against the latent without full
keys; the int4 tier's share goes through the latent form of the
`tiered_decode` kernel, the bf16 hot tail's and the current token's stay
plain PyTorch, merged as online-softmax partials.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.tiered_attention.ops import latent_decode_attention
from repro_torch.models.attention import (_project, attend_chunked,
                                          out_project)
from repro_torch.models.layers import apply_rope, init_dense, rms_norm

__all__ = ["init_mla", "latent_project", "apply_mla", "apply_mla_decode"]


def init_mla(gen, cfg, dtype=torch.bfloat16, n_stack=None):
    m = cfg.mla
    d, h = cfg.d_model, cfg.num_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    lead = () if n_stack is None else (n_stack,)
    wq = init_dense(gen, d, (h, qk), dtype=dtype, n_stack=n_stack)
    w_dkv = init_dense(gen, d, m.kv_lora_rank + m.qk_rope_head_dim,
                       dtype=dtype, n_stack=n_stack)
    w_uk = init_dense(gen, m.kv_lora_rank, (h, m.qk_nope_head_dim),
                      dtype=dtype, n_stack=n_stack)
    w_uv = init_dense(gen, m.kv_lora_rank, (h, m.v_head_dim), dtype=dtype,
                      n_stack=n_stack)
    wo = init_dense(gen, h * m.v_head_dim, d, dtype=dtype, n_stack=n_stack)
    return {"wq": wq, "w_dkv": w_dkv, "w_uk": w_uk, "w_uv": w_uv,
            "wo": wo.reshape(lead + (h, m.v_head_dim, d)),
            "kv_norm": torch.zeros(lead + (m.kv_lora_rank,), dtype=dtype,
                                   device=gen.device)}


def latent_project(params, cfg, x, positions):
    """x -> (c_kv (B, S, r), k_rope (B, S, rope_dim)); rope applied to
    k_rope."""
    m = cfg.mla
    dkv = x @ params["w_dkv"]
    c_kv, k_rope = dkv[..., :m.kv_lora_rank], dkv[..., m.kv_lora_rank:]
    c_kv = rms_norm(c_kv, params["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope(k_rope[:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0, :]
    return c_kv, k_rope


def _queries(params, cfg, x, positions):
    m = cfg.mla
    q = _project(x, params["wq"])
    q_nope, q_rope = q[..., :m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def apply_mla(params, cfg, x, positions, *, chunk=512):
    """Prefill: per-head K, V materialised from the latent, causal
    attention over positions 0..S-1 (the `flash_fwd` kernel on a card).
    Returns (y, (c_kv, k_rope)): the latent pair is the cache."""
    m = cfg.mla
    c_kv, k_rope = latent_project(params, cfg, x, positions)
    q_nope, q_rope = _queries(params, cfg, x, positions)
    k_nope = _project(c_kv, params["w_uk"])
    v = _project(c_kv, params["w_uv"])
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        *k_nope.shape[:3], m.qk_rope_head_dim)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    out = attend_chunked(q, k, v, q_positions=positions,
                         kv_positions=positions, causal=True, chunk=chunk,
                         iota=True)
    return out_project(params, out), (c_kv, k_rope)


def apply_mla_decode(params, cfg, x, positions, lc, dense_len: int,
                     total_len: int, group: int = 64):
    """Absorbed decode against one layer's tiered latent cache.

    x: (B, 1, D), already layer-normed; lc: {c4, c4_sc, ch, krope}, the
    `mla` tier slot (`core.tiercache.layout.mla_layer_zeros`). The scores
    are (q_lat . c + q_rope . k_rope) / sqrt(qk_nope + qk_rope) with q_lat
    = q_nope . W_uk rounded to the activations' dtype, as the reference's
    einsum leaves it; the int4 tier is dequantized to bf16 inside the
    kernel. The current token attends to itself. Returns (y (B, 1, D),
    (c_new (B, 1, r), k_rope_new (B, 1, rope_dim)))."""
    m = cfg.mla
    scale = 1.0 / ((m.qk_nope_head_dim + m.qk_rope_head_dim) ** 0.5)
    c_new, kr_new = latent_project(params, cfg, x, positions)
    q_nope, q_rope = _queries(params, cfg, x, positions)
    q_lat = torch.einsum("bshn,rhn->bshr", q_nope, params["w_uk"])
    ctx = latent_decode_attention(
        q_lat[:, 0].to(torch.float32).contiguous(),
        q_rope[:, 0].to(torch.float32).contiguous(), lc, dense_len,
        total_len, c_new, kr_new, group=group, scale=scale)
    out = torch.einsum("bhr,rhv->bhv", ctx.to(x.dtype), params["w_uv"])
    return out_project(params, out[:, None]), (c_new, kr_new)
