"""Whisper-style encoder-decoder transformer backbone (the port of the
reference's `repro/models/encdec.py`, the loss of training, `encdec_loss`,
among it).

The audio frontend (mel + conv) is a stub, as in the reference: the model
consumes precomputed frame embeddings (B, F, d_model). The encoder adds
fixed sinusoidal positions and uses no RoPE; its self-attention is
non-causal over every frame and runs the plain chunked forward of
`attend_chunked`, as the reference's runs in jnp (the flash kernel is
causal only). The
decoder uses RoPE; its prefill self-attention is causal over positions
0..S-1 and so runs the `flash_fwd` kernel.

Decode: the self-attention decodes over its tiered cache through the
`tiered_decode` kernel (`transformer.gqa_decode_tiered`); the
cross-attention reads the static int4 cross tier built once at the
prefill — all of it dense, never appended to. The reference dequantizes
that tier to bf16 and attends in float32; the port runs the same
function as the `tiered_decode` kernel's dense-tier partial over the
whole tier (`dense_len` = F, the dequantization to bf16 fused),
normalized by its own softmax sum.
"""
from __future__ import annotations

import math

import torch

from repro_torch.distributed.constraints import constrain_bsd
from repro_torch.kernels.tiered_attention import ops as tiered_ops
from repro_torch.models import attention as attn_lib
from repro_torch.models.layers import (apply_mlp, checkpointed,
                                       chunked_softmax_xent, embed,
                                       init_embedding, init_mlp, rms_norm)
from repro_torch.models.transformer import gqa_decode_tiered, layer_params

__all__ = ["sinusoidal_positions", "init_encdec", "encode",
           "decoder_hidden", "encdec_loss", "cross_decode_attention",
           "encdec_decode_step"]


def sinusoidal_positions(length: int, dim: int, dtype=torch.bfloat16,
                         device=None):
    """(length, dim): sin over the first half, cos over the second, in
    float32, then `dtype`."""
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    inv = torch.exp(-torch.arange(0, dim, 2, dtype=torch.float32,
                                  device=device)
                    * (math.log(10_000.0) / max(dim - 2, 1)))
    ang = pos * inv[None]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def init_encdec(gen, cfg, dtype=torch.bfloat16):
    """Random parameters drawn from `gen` on its device, in the
    reference's tree: embed, enc_layers {attn, mlp, ln1, ln2} stacked
    over the encoder's layers, enc_norm, dec_layers {self_attn,
    cross_attn, mlp, ln1, lnx, ln2} stacked over the decoder's,
    final_norm, unembed."""
    d, dev = cfg.d_model, gen.device
    n_enc, n_dec = cfg.encdec.num_encoder_layers, cfg.num_layers

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    params = {"embed": init_embedding(gen, cfg.vocab_size, d, dtype)}
    params["enc_layers"] = {
        "attn": attn_lib.init_attention(gen, cfg, dtype=dtype, n_stack=n_enc),
        "mlp": init_mlp(gen, d, cfg.d_ff, cfg.act, dtype, n_stack=n_enc),
        "ln1": zeros(n_enc, d), "ln2": zeros(n_enc, d)}
    params["enc_norm"] = zeros(d)
    params["dec_layers"] = {
        "self_attn": attn_lib.init_attention(gen, cfg, dtype=dtype,
                                             n_stack=n_dec),
        "cross_attn": attn_lib.init_attention(gen, cfg, dtype=dtype,
                                              n_stack=n_dec),
        "mlp": init_mlp(gen, d, cfg.d_ff, cfg.act, dtype, n_stack=n_dec),
        "ln1": zeros(n_dec, d), "lnx": zeros(n_dec, d),
        "ln2": zeros(n_dec, d)}
    params["final_norm"] = zeros(d)
    params["unembed"] = (0.02 * torch.randn(
        (d, cfg.vocab_size), generator=gen, dtype=torch.float32,
        device=dev)).to(dtype)
    return params


def _n(stacked) -> int:
    return stacked["ln1"].shape[0]


def _enc_layer(lp, cfg, x, positions, attn_chunk):
    hn = rms_norm(x, lp["ln1"], cfg.norm_eps)
    a, _ = attn_lib.apply_attention(lp["attn"], cfg, hn, positions,
                                    causal=False, chunk=attn_chunk,
                                    rope=False)
    x = x + a
    hn = rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + apply_mlp(lp["mlp"], hn, cfg.act)


def encode(params, cfg, frames, *, remat=False, attn_chunk=512):
    """frames: (B, F, D) precomputed embeddings -> (B, F, D). `remat`
    checkpoints each layer, as the reference's scan body is."""
    b, f, d = frames.shape
    x = constrain_bsd(frames + sinusoidal_positions(f, d, frames.dtype,
                                                    frames.device)[None])
    positions = torch.arange(f, dtype=torch.int32, device=x.device)
    layers = params["enc_layers"]
    layer = checkpointed(_enc_layer) if remat else _enc_layer
    for i in range(_n(layers)):
        x = layer(layer_params(layers, i), cfg, constrain_bsd(x), positions,
                  attn_chunk)
    return rms_norm(x, params["enc_norm"], cfg.norm_eps)


def _dec_layer(lp, cfg, x, enc_out, positions, attn_chunk):
    """One decoder layer. Returns (x, ((k, v), (ck, cv)))."""
    hn = rms_norm(x, lp["ln1"], cfg.norm_eps)
    a, kv = attn_lib.apply_attention(lp["self_attn"], cfg, hn, positions,
                                     causal=True, chunk=attn_chunk)
    x = x + a
    hn = rms_norm(x, lp["lnx"], cfg.norm_eps)
    ck = attn_lib._project(enc_out, lp["cross_attn"]["wk"])
    cv = attn_lib._project(enc_out, lp["cross_attn"]["wv"])
    x = x + attn_lib.apply_cross_attention(lp["cross_attn"], cfg, hn, ck, cv,
                                           chunk=attn_chunk)
    hn = rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + apply_mlp(lp["mlp"], hn, cfg.act), (kv, (ck, cv))


def decoder_hidden(params, cfg, tokens, enc_out, *, remat=False,
                   attn_chunk=512, collect_kv=False):
    """Teacher-forced decoder pass. Returns (hidden, kvs): kvs is
    ((k, v), (ck, cv)) stacked over the decoder's layers — the
    self-attention's K/V after RoPE (L, B, S, Hkv, hd) and the
    cross-attention's projections of the encoder output (L, B, F, Hkv,
    hd) — when `collect_kv`, else None. `remat` checkpoints each
    layer."""
    x = constrain_bsd(embed(params["embed"], tokens))
    s = tokens.shape[1]
    positions = torch.arange(s, dtype=torch.int32, device=x.device)
    layers = params["dec_layers"]
    layer = checkpointed(_dec_layer) if remat else _dec_layer
    ks, vs, cks, cvs = [], [], [], []
    for i in range(_n(layers)):
        x, ((k, v), (ck, cv)) = layer(layer_params(layers, i), cfg,
                                      constrain_bsd(x), enc_out, positions,
                                      attn_chunk)
        if collect_kv:
            ks.append(k)
            vs.append(v)
            cks.append(ck)
            cvs.append(cv)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    kvs = (((torch.stack(ks), torch.stack(vs)),
            (torch.stack(cks), torch.stack(cvs))) if collect_kv else None)
    return x, kvs


def encdec_loss(params, cfg, frames, tokens, *, remat=True, attn_chunk=512):
    """Next-token loss of the decoder over the encoded frames. Returns
    (loss, {"loss", "aux_loss" (0)})."""
    enc_out = encode(params, cfg, frames, remat=remat, attn_chunk=attn_chunk)
    hidden, _ = decoder_hidden(params, cfg, tokens, enc_out, remat=remat,
                               attn_chunk=attn_chunk)
    loss = chunked_softmax_xent(hidden[:, :-1], params["unembed"],
                                tokens[:, 1:])
    return loss, {"loss": loss, "aux_loss": torch.zeros(
        (), dtype=torch.float32, device=hidden.device)}


def cross_decode_attention(attn_params, cfg, x, lc, group=64):
    """Decode cross-attention over one layer's static int4 cross tier.

    x: (B, 1, D) (already layer-normed); lc holds ck4, ck4_sc, cv4,
    cv4_sc ((B, F, Hkv, ...)). The whole tier is the dense partial's
    `dense_len`; its output is acc / l. Returns (B, 1, D)."""
    q = attn_lib._project(x, attn_params["wq"])                # (B,1,H,hd)
    b, _, h, hd = q.shape
    ck4 = lc["ck4"]
    hkv, frames = ck4.shape[2], ck4.shape[1]
    qg = q[:, 0].reshape(b, hkv, h // hkv, hd).to(torch.float32)
    _, l, acc = tiered_ops.dense_tier_partial(
        qg.contiguous(), ck4, lc["ck4_sc"], lc["cv4"], lc["cv4_sc"], frames,
        group=group, deq_dtype=torch.bfloat16)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return attn_lib.out_project(attn_params,
                                out.reshape(b, 1, h, hd).to(x.dtype))


def encdec_decode_step(params, cfg, token, cache, *, quant_group=64):
    """cache: {"layers": {self tiers..., ck4, ck4_sc, cv4, cv4_sc} with a
    leading layer axis, "dense_len", "total_len" (ints)}. Returns
    (logits (B, V) float32, (k_new, v_new) each (L, B, 1, Hkv, hd)):
    appending and repacking are the tiercache manager's job; the cross
    tier is static."""
    total_len, dense_len = int(cache["total_len"]), int(cache["dense_len"])
    x = embed(params["embed"], token)
    positions = torch.full((1,), total_len, dtype=torch.int32,
                           device=x.device)
    layers = params["dec_layers"]
    new_k, new_v = [], []
    for i in range(_n(layers)):
        lp = layer_params(layers, i)
        lc = layer_params(cache["layers"], i)
        hn = rms_norm(x, lp["ln1"], cfg.norm_eps)
        a, (k_new, v_new) = gqa_decode_tiered(
            lp["self_attn"], cfg, hn, positions, lc, dense_len, total_len,
            quant_group)
        x = x + a
        hn = rms_norm(x, lp["lnx"], cfg.norm_eps)
        x = x + cross_decode_attention(lp["cross_attn"], cfg, hn, lc,
                                       quant_group)
        hn = rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + apply_mlp(lp["mlp"], hn, cfg.act)
        new_k.append(k_new)
        new_v.append(v_new)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = (x[:, 0] @ params["unembed"]).to(torch.float32)
    return logits, (torch.stack(new_k), torch.stack(new_v))
