"""Decoder-only LM assembly: the dense, MoE and VLM families, GQA or MLA
attention (the port of the reference's `repro/models/transformer.py`).
A VLM's patch embeddings are prepended to the tokens' at the prefill.

Per-layer params are stacked along a leading layer axis, as the
reference's `lax.scan` keeps them; the port walks the layers in a Python
loop. A MoE config with `first_k_dense` keeps those leading layers apart
(`first_dense`: the same attention, a dense FFN of `d_ff_first_dense`).
Decode consumes the tiered KV cache (dense int4 tier + hot bf16 tail):
GQA through the `tiered_decode` kernel, MLA's latent through its latent
form, the dequantized tier rounded to bf16 as the reference's serving
path rounds it; MoE layers dispatch by `gather` at decode. `lm_loss`
is the next-token loss of training, with the reference's remat choices
(`lm_hidden(remat=)`).
"""
from __future__ import annotations

import torch

from repro_torch.distributed.constraints import constrain_bsd
from repro_torch.kernels.tiered_attention.ops import tiered_decode_attention
from repro_torch.models import attention as attn_lib
from repro_torch.models import mla as mla_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models.layers import (apply_mlp, checkpointed,
                                       chunked_softmax_xent, embed,
                                       init_embedding, init_mlp, rms_norm)

__all__ = ["init_lm", "unembed_matrix", "embed_tokens", "apply_layer",
           "lm_hidden", "lm_loss", "gqa_decode_tiered", "lm_decode_step",
           "layer_params"]


def _init_layers(gen, cfg, n: int, dense_ffn=None, dtype=torch.bfloat16):
    """n stacked decoder layers: attention (MLA or GQA), ln1, ln2, and a
    dense FFN of `dense_ffn` (deepseek's first layers), the MoE FFN, or
    the config's dense FFN."""
    d, dev = cfg.d_model, gen.device
    attn = (mla_lib.init_mla(gen, cfg, dtype=dtype, n_stack=n)
            if cfg.mla is not None else
            attn_lib.init_attention(gen, cfg, dtype=dtype, n_stack=n))
    params = {"attn": attn,
              "ln1": torch.zeros((n, d), dtype=dtype, device=dev),
              "ln2": torch.zeros((n, d), dtype=dtype, device=dev)}
    if dense_ffn is not None:
        params["mlp"] = init_mlp(gen, d, dense_ffn, cfg.act, dtype,
                                 n_stack=n)
    elif cfg.moe is not None:
        params["moe"] = moe_lib.init_moe_layer(gen, cfg, dtype=dtype,
                                               n_stack=n)
    else:
        params["mlp"] = init_mlp(gen, d, cfg.d_ff, cfg.act, dtype, n_stack=n)
    return params


def init_lm(gen, cfg, dtype=torch.bfloat16):
    """Random parameters drawn from `gen` on its device, in the
    reference's tree: embed, final_norm, first_dense (MoE configs with
    first_k_dense), layers {attn, ln1, ln2, mlp or moe} stacked over
    layers, and unembed when the embeddings are not tied."""
    m = cfg.moe
    first_k = m.first_k_dense if m else 0
    d = cfg.d_model
    params = {"embed": init_embedding(gen, cfg.vocab_size, d, dtype),
              "final_norm": torch.zeros((d,), dtype=dtype,
                                        device=gen.device)}
    if first_k:
        params["first_dense"] = _init_layers(
            gen, cfg, first_k, dense_ffn=m.d_ff_first_dense, dtype=dtype)
    params["layers"] = _init_layers(gen, cfg, cfg.num_layers - first_k,
                                    dtype=dtype)
    if not cfg.tie_embeddings:
        params["unembed"] = (0.02 * torch.randn(
            (d, cfg.vocab_size), generator=gen, dtype=torch.float32,
            device=gen.device)).to(dtype)
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


def _attn_block(params, cfg, x, positions, attn_chunk):
    h = rms_norm(x, params["ln1"], cfg.norm_eps)
    if cfg.mla is not None:
        return mla_lib.apply_mla(params["attn"], cfg, h, positions,
                                 chunk=attn_chunk)
    return attn_lib.apply_attention(params["attn"], cfg, h, positions,
                                    chunk=attn_chunk)


def _ffn_block(params, cfg, x, moe_dispatch):
    h = rms_norm(x, params["ln2"], cfg.norm_eps)
    if "moe" in params:
        return moe_lib.apply_moe(params["moe"], cfg, h,
                                 dispatch=moe_dispatch)
    f = apply_mlp(params["mlp"], h, cfg.act)
    return f, torch.zeros((), dtype=torch.float32, device=x.device)


def apply_layer(params, cfg, x, positions, *, moe_dispatch="einsum",
                attn_chunk=512):
    """Full-sequence layer (train / prefill). Returns (x, aux, kv): kv is
    (k, v) for GQA, (c_kv, k_rope) for MLA; aux the MoE layer's
    load-balance loss, float32 0 for a dense FFN."""
    a, kv = _attn_block(params, cfg, x, positions, attn_chunk)
    x = x + a
    f, aux = _ffn_block(params, cfg, x, moe_dispatch)
    return x + f, aux, kv


def _layer_seq(params, cfg, x, positions, moe_dispatch, attn_chunk):
    """`apply_layer`, its arguments positional (the form `checkpointed`
    takes)."""
    return apply_layer(params, cfg, x, positions, moe_dispatch=moe_dispatch,
                       attn_chunk=attn_chunk)


def _layer_blocks(params, cfg, x, positions, moe_dispatch, attn_chunk):
    """`apply_layer` with the reference's "blocks" remat: the attention
    block and the FFN block are each checkpointed, so what the backward
    keeps of the layer is the residual stream at the two block
    boundaries and each block is recomputed from it."""
    a, kv = checkpointed(_attn_block)(params, cfg, x, positions, attn_chunk)
    x = x + a
    f, aux = checkpointed(_ffn_block)(params, cfg, x, moe_dispatch)
    return x + f, aux, kv


def _layer_fn(remat, first: bool):
    """The layer as `_remat_wrap` wraps the reference's scan body: False
    as it is; True checkpointed whole; "blocks" block by block. The
    first_dense layers are checkpointed whole under any remat, as the
    reference's `first_body` is."""
    if not remat:
        return _layer_seq
    if remat == "blocks" and not first:
        return _layer_blocks
    return checkpointed(_layer_seq)


def _stacks(params):
    """(name, stacked layer params, count) in the order the layers run:
    first_dense, then layers."""
    return [(k, params[k], params[k]["ln1"].shape[0])
            for k in ("first_dense", "layers") if k in params]


def lm_hidden(params, cfg, tokens, *, prefix_embeds=None,
              moe_dispatch="einsum", attn_chunk=512, remat=False,
              collect_kv=False):
    """tokens (B, S_txt) [+ prefix embeddings (B, P, D), a VLM's patches,
    concatenated before the tokens' embeddings] -> final hidden states
    over S = P + S_txt positions. `remat` (False, True or "blocks") is
    the reference's; the serving prefill runs without it.

    Returns (hidden (B, S, D), aux_loss (float32: the first layers' sum
    plus the rest's, each summed in layer order, as the reference's two
    scans sum them), kvs): kvs is the per-layer cache pair stacked over
    every layer, first layers first ((k, v) each (L, B, S, Hkv, hd) after
    RoPE; MLA's (c_kv (L, B, S, r), k_rope (L, B, S, rope_dim))), when
    `collect_kv`, else None."""
    x = embed_tokens(params, cfg, tokens)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    x = constrain_bsd(x)
    s = x.shape[1]
    positions = torch.arange(s, dtype=torch.int32, device=x.device)
    kv0, kv1 = [], []
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for name, stacked, n in _stacks(params):
        layer = _layer_fn(remat, name == "first_dense")
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(n):
            x, a, kv = layer(layer_params(stacked, i), cfg,
                             constrain_bsd(x), positions, moe_dispatch,
                             attn_chunk)
            x = constrain_bsd(x)
            aux = aux + a
            if collect_kv:
                kv0.append(kv[0])
                kv1.append(kv[1])
        aux_total = aux_total + aux
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    kvs = (torch.stack(kv0), torch.stack(kv1)) if collect_kv else None
    return x, aux_total, kvs


def lm_loss(params, cfg, tokens, *, prefix_embeds=None,
            moe_dispatch="einsum", attn_chunk=512, remat=True,
            aux_coef=None):
    """Next-token loss: token t+1 predicted from the hidden state at
    P + t (a VLM's P patch positions predict nothing). Returns (total,
    {"loss", "aux_loss"}): total adds the MoE aux loss weighted by
    `aux_coef` (default the config's `router_aux_loss_coef`, 0 for a
    dense model)."""
    hidden, aux, _ = lm_hidden(params, cfg, tokens,
                               prefix_embeds=prefix_embeds,
                               moe_dispatch=moe_dispatch,
                               attn_chunk=attn_chunk, remat=remat)
    p = 0 if prefix_embeds is None else prefix_embeds.shape[1]
    h = hidden[:, p: p + tokens.shape[1] - 1]
    loss = chunked_softmax_xent(h, unembed_matrix(params), tokens[:, 1:])
    if aux_coef is None:
        aux_coef = cfg.moe.router_aux_loss_coef if cfg.moe else 0.0
    return loss + aux_coef * aux, {"loss": loss, "aux_loss": aux}


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
    axis, "dense_len": int, "total_len": int}; the first_dense layers use
    its leading slots. Returns (logits (B, V) float32, the new cache
    pair stacked over layers: (k_new, v_new) each (L, B, 1, Hkv, hd), or
    MLA's (c_new (L, B, 1, r), k_rope_new (L, B, 1, rope_dim))); appending
    and repacking are the tiercache manager's job."""
    total_len, dense_len = int(cache["total_len"]), int(cache["dense_len"])
    x = embed_tokens(params, cfg, token)
    positions = torch.full((1,), total_len, dtype=torch.int32,
                           device=x.device)
    new0, new1 = [], []
    slot = 0
    for _, stacked, n in _stacks(params):
        for i in range(n):
            lp = layer_params(stacked, i)
            lc = layer_params(cache["layers"], slot)
            slot += 1
            hn = rms_norm(x, lp["ln1"], cfg.norm_eps)
            if cfg.mla is not None:
                a, kv_new = mla_lib.apply_mla_decode(
                    lp["attn"], cfg, hn, positions, lc, dense_len,
                    total_len, quant_group)
            else:
                a, kv_new = gqa_decode_tiered(
                    lp["attn"], cfg, hn, positions, lc, dense_len,
                    total_len, quant_group)
            x = x + a
            hn = rms_norm(x, lp["ln2"], cfg.norm_eps)
            if "moe" in lp:
                f, _ = moe_lib.apply_moe(lp["moe"], cfg, hn,
                                         dispatch="gather")
            else:
                f = apply_mlp(lp["mlp"], hn, cfg.act)
            x = x + f
            new0.append(kv_new[0])
            new1.append(kv_new[1])
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = (x[:, 0] @ unembed_matrix(params)).to(torch.float32)
    return logits, (torch.stack(new0), torch.stack(new1))
