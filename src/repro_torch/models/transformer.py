"""Decoder-only LM assembly, dense family (the port of the reference's
`repro/models/transformer.py`; MLA and MoE layers wait for their slices).

Per-layer params are stacked along a leading layer axis, as the
reference's `lax.scan` keeps them; the port walks the layers in a Python
loop. Decode consumes the tiered KV cache (dense int4 tier + hot bf16
tail) through the `tiered_decode` kernel, with the dequantized tier
rounded to bf16 as the reference's serving path rounds it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.tiered_attention.ops import tiered_decode_attention
from repro_torch.models import attention as attn_lib
from repro_torch.models.layers import (apply_mlp, embed, init_embedding,
                                       init_mlp, rms_norm)

__all__ = ["init_lm", "unembed_matrix", "embed_tokens", "lm_hidden",
           "gqa_decode_tiered", "lm_decode_step", "layer_params"]


def _check_family(cfg) -> None:
    if cfg.mla is not None:
        raise NotImplementedError(
            f"{cfg.name}: MLA attention waits for the MLA slice "
            "(deepseek-v2-lite)")
    if cfg.moe is not None:
        raise NotImplementedError(f"{cfg.name}: MoE layers wait for the "
                                  "MoE slice")


def init_lm(gen, cfg, dtype=torch.bfloat16):
    """Random parameters drawn from `gen` on its device, in the
    reference's tree: embed, final_norm, layers {attn {wq, wk, wv, wo},
    ln1, ln2, mlp {w_gate, w_up, w_down}} stacked over layers, and
    unembed when the embeddings are not tied."""
    _check_family(cfg)
    n, d = cfg.num_layers, cfg.d_model
    dev = gen.device
    params = {"embed": init_embedding(gen, cfg.vocab_size, d, dtype),
              "final_norm": torch.zeros((d,), dtype=dtype, device=dev)}
    params["layers"] = {
        "attn": attn_lib.init_attention(gen, cfg, dtype=dtype, n_stack=n),
        "ln1": torch.zeros((n, d), dtype=dtype, device=dev),
        "ln2": torch.zeros((n, d), dtype=dtype, device=dev),
        "mlp": init_mlp(gen, d, cfg.d_ff, cfg.act, dtype, n_stack=n)}
    if not cfg.tie_embeddings:
        params["unembed"] = (0.02 * torch.randn(
            (d, cfg.vocab_size), generator=gen, dtype=torch.float32,
            device=dev)).to(dtype)
    return params


def layer_params(stacked, i: int):
    """Layer i's params out of the stacked tree (views, no copies)."""
    if isinstance(stacked, dict):
        return {k: layer_params(v, i) for k, v in stacked.items()}
    return stacked[i]


def unembed_matrix(params):
    return params["unembed"] if "unembed" in params else params["embed"].T


def embed_tokens(params, cfg, tokens):
    x = embed(params["embed"], tokens)
    if getattr(cfg, "embed_scale_sqrt_d", False) or (
            cfg.tie_embeddings and cfg.family in ("dense",)):
        # sqrt(d_model) rounded to the activations' dtype first
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype,
                             device=x.device)
    return x


def apply_layer(params, cfg, x, positions, *, attn_chunk=512):
    """Full-sequence layer (prefill). Returns (x, (k, v))."""
    h = rms_norm(x, params["ln1"], cfg.norm_eps)
    a, kv = attn_lib.apply_attention(params["attn"], cfg, h, positions,
                                     chunk=attn_chunk)
    x = x + a
    h = rms_norm(x, params["ln2"], cfg.norm_eps)
    return x + apply_mlp(params["mlp"], h, cfg.act), kv


def lm_hidden(params, cfg, tokens, *, attn_chunk=512, collect_kv=False):
    """tokens (B, S) -> final hidden states.

    Returns (hidden (B, S, D), aux_loss 0.0, kvs): kvs is (k, v), each
    (L, B, S, Hkv, hd) after RoPE, when `collect_kv`, else None."""
    _check_family(cfg)
    x = embed_tokens(params, cfg, tokens)
    s = x.shape[1]
    positions = torch.arange(s, dtype=torch.int32, device=x.device)
    ks, vs = [], []
    for i in range(params["layers"]["ln1"].shape[0]):
        x, (k, v) = apply_layer(layer_params(params["layers"], i), cfg, x,
                                positions, attn_chunk=attn_chunk)
        if collect_kv:
            ks.append(k)
            vs.append(v)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    kvs = (torch.stack(ks), torch.stack(vs)) if collect_kv else None
    return x, 0.0, kvs


def gqa_decode_tiered(attn_params, cfg, x, positions, lc, dense_len: int,
                      total_len: int, group=64):
    """Decode attention against one layer's tiered cache slot.

    x: (B, 1, D) (already layer-normed). lc: {k4, k4_sc, v4, v4_sc, kh,
    vh}. The dense tier is dequantized to bf16, as the reference's
    `_materialize_gqa` does, inside the kernel. Returns (attn_out
    (B, 1, D), (k_new, v_new))."""
    q, k_new, v_new = attn_lib.qkv_project(attn_params, cfg, x, positions)
    out = tiered_decode_attention(q, lc, dense_len, total_len, k_new, v_new,
                                  group=group, deq_dtype=torch.bfloat16)
    return attn_lib.out_project(attn_params, out.to(x.dtype)), (k_new, v_new)


def lm_decode_step(params, cfg, token, cache, *, quant_group=64):
    """One decode token against the tiered cache.

    token: (B, 1) int. cache: {"layers": tier dict with a leading layer
    axis, "dense_len": int, "total_len": int}. Returns (logits (B, V)
    float32, (k_new, v_new) stacked over layers, each (L, B, 1, Hkv,
    hd)); appending and repacking are the tiercache manager's job."""
    _check_family(cfg)
    total_len, dense_len = int(cache["total_len"]), int(cache["dense_len"])
    x = embed_tokens(params, cfg, token)
    positions = torch.full((1,), total_len, dtype=torch.int32,
                           device=x.device)
    k_news, v_news = [], []
    for i in range(params["layers"]["ln1"].shape[0]):
        lp = layer_params(params["layers"], i)
        lc = layer_params(cache["layers"], i)
        hn = rms_norm(x, lp["ln1"], cfg.norm_eps)
        a, (k_new, v_new) = gqa_decode_tiered(
            lp["attn"], cfg, hn, positions, lc, dense_len, total_len,
            quant_group)
        x = x + a
        hn = rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + apply_mlp(lp["mlp"], hn, cfg.act)
        k_news.append(k_new)
        v_news.append(v_new)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = (x[:, 0] @ unembed_matrix(params)).to(torch.float32)
    return logits, (torch.stack(k_news), torch.stack(v_news))
