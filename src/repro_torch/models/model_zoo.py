"""Model API of the serving path (the port of the reference's
`repro/models/model_zoo.py`: every family).

ModelBundle exposes init / loss / prefill / decode / decode-cache
builders and the tiered-cache kind, so the serve engine and the train
step are model-agnostic. The port runs the `dense` family
(gemma-2b and the other dense configs), `moe` (deepseek-v2-lite-16b with
MLA attention and the `mla` cache kind, arctic-480b with GQA), `vlm`
(llava-next-34b: the decoder with its patch embeddings prepended), `ssm`
(mamba2-370m), `hybrid` (zamba2-1.2b) and `audio` (whisper-tiny: the
encoder-decoder and the `encdec_self` cache kind). Modality frontends
are stubs, as in the reference: batches carry precomputed frame or
patch embeddings.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.tiercache.layout import (QUANT_CHANNELS, TierSpec,
                                               cross_static_zeros,
                                               fill_quant_channels,
                                               fill_raw_channel,
                                               gqa_layer_zeros,
                                               mla_layer_zeros,
                                               split_for_prefill)
from repro_torch.kernels.ips_repack import ops as repack_ops
from repro_torch.models import encdec as encdec_lib
from repro_torch.models import hybrid as hybrid_lib
from repro_torch.models import transformer as tx

__all__ = ["ModelBundle", "default_tier_spec", "build_model",
           "make_train_batch"]


@dataclasses.dataclass
class ModelBundle:
    cfg: ArchConfig
    cache_kind: str                     # gqa | mla | encdec_self | ssm | hybrid
    init: Callable                      # generator -> params
    loss: Callable                      # (params, batch) -> (loss, metrics)
    prefill: Callable                   # (params, batch, spec) -> (cache, logits)
    decode: Callable                    # (params, token, cache, spec) -> (logits, kv_new)
    make_decode_cache: Callable         # (batch, seq_len, spec) -> cache zeros


def default_tier_spec(seq_len: int, hot_window: int = 1024,
                      page_tokens: int = 256, group: int = 64) -> TierSpec:
    return TierSpec(s_max=seq_len, hot_window=hot_window,
                    page_tokens=page_tokens, group=group)


def _tx_bundle(cfg: ArchConfig, moe_dispatch: str, attn_chunk: int,
               device, remat) -> ModelBundle:
    is_mla = cfg.mla is not None
    kind = "mla" if is_mla else "gqa"
    prefix_key = "patch_embeds" if cfg.vlm is not None else None

    def loss(params, batch):
        return tx.lm_loss(params, cfg, batch["tokens"],
                          prefix_embeds=batch.get(prefix_key)
                          if prefix_key else None,
                          moe_dispatch=moe_dispatch, attn_chunk=attn_chunk,
                          remat=remat)

    def make_decode_cache(b, seq_len, spec: TierSpec, device=device):
        if is_mla:
            layers = mla_layer_zeros(cfg.num_layers, b, spec,
                                     cfg.mla.kv_lora_rank,
                                     cfg.mla.qk_rope_head_dim, device=device)
        else:
            layers = gqa_layer_zeros(cfg.num_layers, b, spec,
                                     cfg.num_kv_heads, cfg.head_dim,
                                     device=device)
        w0, _ = split_for_prefill(seq_len, spec)
        return {"layers": layers, "total_len": seq_len, "dense_len": w0}

    def prefill(params, batch, spec: TierSpec):
        hidden, _, kvs = tx.lm_hidden(
            params, cfg, batch["tokens"],
            prefix_embeds=batch.get(prefix_key) if prefix_key else None,
            moe_dispatch=moe_dispatch, attn_chunk=attn_chunk,
            collect_kv=True)
        b, s = hidden.shape[:2]
        layers = make_decode_cache(b, 0, spec, hidden.device)["layers"]
        if is_mla:
            c_kv, k_rope = kvs
            layers, w0 = fill_quant_channels(layers, QUANT_CHANNELS["mla"],
                                             (c_kv,), spec)
            layers, _ = fill_raw_channel(layers, "krope", k_rope, spec)
        else:
            layers, w0 = fill_quant_channels(layers, QUANT_CHANNELS["gqa"],
                                             kvs, spec)
        cache = {"layers": layers, "total_len": s, "dense_len": w0}
        return cache, _last_logits(params, hidden)

    def decode(params, token, cache, spec=None):
        g = spec.group if spec is not None else 64
        return tx.lm_decode_step(params, cfg, token, cache, quant_group=g)

    return ModelBundle(cfg=cfg, cache_kind=kind,
                       init=lambda gen: tx.init_lm(gen, cfg), loss=loss,
                       prefill=prefill, decode=decode,
                       make_decode_cache=make_decode_cache)


def _last_logits(params, hidden):
    return (hidden[:, -1] @ tx.unembed_matrix(params)).to(torch.float32)


# ---------------------------------------------------------------------------
# SSM family (mamba2): O(1) decode state, no KV cache
# ---------------------------------------------------------------------------


def _ssm_bundle(cfg: ArchConfig, device, remat) -> ModelBundle:
    def loss(params, batch):
        return hybrid_lib.ssm_lm_loss(params, cfg, batch["tokens"],
                                      remat=remat)

    def make_decode_cache(b, seq_len, spec=None, device=device):
        conv, ssm = hybrid_lib.ssm_state_shapes(cfg, b, device)
        return {"conv": conv, "ssm": ssm, "total_len": seq_len,
                "dense_len": seq_len}

    def prefill(params, batch, spec=None):
        tokens = batch["tokens"]
        hidden, (conv, ssm) = hybrid_lib.ssm_lm_hidden(
            params, cfg, tokens, collect_state=True)
        s = tokens.shape[1]
        cache = {"conv": conv, "ssm": ssm, "total_len": s, "dense_len": s}
        return cache, _last_logits(params, hidden)

    def decode(params, token, cache, spec=None):
        return hybrid_lib.ssm_lm_decode_step(
            params, cfg, token, (cache["conv"], cache["ssm"]))

    return ModelBundle(cfg=cfg, cache_kind="ssm",
                       init=lambda gen: hybrid_lib.init_ssm_lm(gen, cfg),
                       loss=loss, prefill=prefill, decode=decode,
                       make_decode_cache=make_decode_cache)


# ---------------------------------------------------------------------------
# hybrid family (zamba2): Mamba2 states plus the shared block's tiered cache
# ---------------------------------------------------------------------------


def _hybrid_bundle(cfg: ArchConfig, attn_chunk: int, device,
                   remat) -> ModelBundle:
    def loss(params, batch):
        return hybrid_lib.hybrid_lm_loss(params, cfg, batch["tokens"],
                                         remat=remat, attn_chunk=attn_chunk)

    def make_decode_cache(b, seq_len, spec: TierSpec, device=device):
        n_macro, tail = hybrid_lib.hybrid_structure(cfg)
        ae = cfg.hybrid.attn_every
        s = cfg.ssm
        d_xc = s.d_inner(cfg.d_model) + 2 * s.d_state
        nh = s.num_heads(cfg.d_model)
        w0, _ = split_for_prefill(seq_len, spec)
        cache = {
            "attn": gqa_layer_zeros(n_macro, b, spec, cfg.num_kv_heads,
                                    cfg.head_dim, device=device),
            "macro_conv": torch.zeros((n_macro, ae, b, s.d_conv - 1, d_xc),
                                      dtype=torch.bfloat16, device=device),
            "macro_ssm": torch.zeros((n_macro, ae, b, nh, s.head_dim,
                                      s.d_state), dtype=torch.float32,
                                     device=device),
            "total_len": seq_len, "dense_len": w0,
        }
        if tail:
            cache["tail_conv"] = torch.zeros((tail, b, s.d_conv - 1, d_xc),
                                             dtype=torch.bfloat16,
                                             device=device)
            cache["tail_ssm"] = torch.zeros((tail, b, nh, s.head_dim,
                                             s.d_state), dtype=torch.float32,
                                            device=device)
        return cache

    def prefill(params, batch, spec: TierSpec):
        tokens = batch["tokens"]
        hidden, ((k, v), macro_states, tail_states) = (
            hybrid_lib.hybrid_lm_hidden(params, cfg, tokens,
                                        attn_chunk=attn_chunk,
                                        collect_kv=True, collect_state=True))
        b, s = tokens.shape
        cache = make_decode_cache(b, 0, spec, hidden.device)
        cache["attn"], w0 = fill_quant_channels(
            cache["attn"], QUANT_CHANNELS["gqa"], (k, v), spec)
        cache["macro_conv"], cache["macro_ssm"] = macro_states
        if tail_states is not None:
            cache["tail_conv"], cache["tail_ssm"] = tail_states
        cache.update(total_len=s, dense_len=w0)
        return cache, _last_logits(params, hidden)

    def decode(params, token, cache, spec=None):
        g = spec.group if spec is not None else 64
        return hybrid_lib.hybrid_decode_step(params, cfg, token, cache,
                                             quant_group=g)

    return ModelBundle(cfg=cfg, cache_kind="hybrid",
                       init=lambda gen: hybrid_lib.init_hybrid_lm(gen, cfg),
                       loss=loss, prefill=prefill, decode=decode,
                       make_decode_cache=make_decode_cache)


# ---------------------------------------------------------------------------
# encoder-decoder family (whisper): the decoder's tiered self-attention
# cache beside a static int4 cross tier
# ---------------------------------------------------------------------------


def _encdec_bundle(cfg: ArchConfig, attn_chunk: int, device,
                   remat) -> ModelBundle:
    def loss(params, batch):
        return encdec_lib.encdec_loss(params, cfg, batch["frames"],
                                      batch["tokens"], remat=remat,
                                      attn_chunk=attn_chunk)

    def make_decode_cache(b, seq_len, spec: TierSpec, device=device):
        layers = gqa_layer_zeros(cfg.num_layers, b, spec, cfg.num_kv_heads,
                                 cfg.head_dim, device=device)
        layers.update(cross_static_zeros(
            cfg.num_layers, b, cfg.encdec.encoder_seq_len, cfg.num_kv_heads,
            cfg.head_dim, spec.group, device=device))
        w0, _ = split_for_prefill(seq_len, spec)
        return {"layers": layers, "total_len": seq_len, "dense_len": w0}

    def prefill(params, batch, spec: TierSpec):
        enc_out = encdec_lib.encode(params, cfg, batch["frames"],
                                    attn_chunk=attn_chunk)
        hidden, (kv, (ck, cv)) = encdec_lib.decoder_hidden(
            params, cfg, batch["tokens"], enc_out, attn_chunk=attn_chunk,
            collect_kv=True)
        b, s = batch["tokens"].shape
        layers = make_decode_cache(b, 0, spec, hidden.device)["layers"]
        layers, w0 = fill_quant_channels(
            layers, QUANT_CHANNELS["encdec_self"], kv, spec)
        # the cross tier, quantized once: K and V of every layer in one
        # `ips_repack` launch, the scales in bf16 as the reference casts
        # them
        repack_ops.quantize_into([(ck, layers["ck4"], layers["ck4_sc"]),
                                  (cv, layers["cv4"], layers["cv4_sc"])],
                                 0, spec.group)
        cache = {"layers": layers, "total_len": s, "dense_len": w0}
        return cache, _last_logits(params, hidden)

    def decode(params, token, cache, spec=None):
        g = spec.group if spec is not None else 64
        return encdec_lib.encdec_decode_step(params, cfg, token, cache,
                                             quant_group=g)

    return ModelBundle(cfg=cfg, cache_kind="encdec_self",
                       init=lambda gen: encdec_lib.init_encdec(gen, cfg),
                       loss=loss, prefill=prefill, decode=decode,
                       make_decode_cache=make_decode_cache)


def build_model(cfg: ArchConfig, *, moe_dispatch: str = "einsum",
                attn_chunk: int = 512, device="cuda",
                remat=None) -> ModelBundle:
    """The bundle of `cfg`; `make_decode_cache` allocates on `device`
    unless told otherwise, and `prefill` and `loss` run beside their
    inputs. A MoE prefill and loss dispatch by `moe_dispatch` (decode
    always by `gather`). `remat` (False, True or "blocks"; None: the
    config's) is the loss's activation checkpointing; the prefill runs
    without it. The reference takes it for the transformer families and
    uses the config's elsewhere; the port takes it for every family
    ("blocks" checkpoints the layer whole where a family has no
    blocks)."""
    dev = torch.device(device)
    remat = cfg.remat if remat is None else remat
    if cfg.family in ("dense", "moe", "vlm"):
        return _tx_bundle(cfg, moe_dispatch, attn_chunk, dev, remat)
    if cfg.family == "ssm":
        return _ssm_bundle(cfg, dev, remat)
    if cfg.family == "hybrid":
        return _hybrid_bundle(cfg, attn_chunk, dev, remat)
    if cfg.family == "audio":
        return _encdec_bundle(cfg, attn_chunk, dev, remat)
    raise ValueError(f"unknown family {cfg.family!r}")


def make_train_batch(cfg: ArchConfig, batch: int, seq_len: int,
                     generator: torch.Generator) -> Dict[str, Any]:
    """Synthetic batch drawn from `generator`, on its device: token ids,
    and the modality inputs the stub frontends stand for — a VLM's patch
    embeddings (B, num_patches, d_model), an encoder-decoder's frame
    embeddings (B, encoder_seq_len, d_model), both bf16."""
    dev = generator.device
    out: Dict[str, Any] = {
        "tokens": torch.randint(0, cfg.vocab_size, (batch, seq_len),
                                generator=generator, dtype=torch.int32,
                                device=dev)}

    def normal(rows):
        return torch.randn((batch, rows, cfg.d_model), generator=generator,
                           dtype=torch.float32, device=dev).to(
                               torch.bfloat16)

    if cfg.vlm is not None:
        out["patch_embeds"] = normal(cfg.vlm.num_patches)
    if cfg.encdec is not None:
        out["frames"] = normal(cfg.encdec.encoder_seq_len)
    return out
