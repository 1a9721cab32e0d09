"""SSM and hybrid LMs: mamba2-370m (pure SSM) and zamba2 (Mamba2 backbone
plus a weight-shared attention block every `attn_every` layers); the
port of the reference's `repro/models/hybrid.py`, the losses of training
(`ssm_lm_loss`, `hybrid_lm_loss`) among it.

Zamba2 structure: `n_macro = L // attn_every` macro blocks, each
attn_every Mamba2 layers followed by ONE application of the shared
attention block (its KV cache gets one tiered slot per macro); the
remaining layers form a tail of plain Mamba2 layers. The shared block's
cache is the only place the paper's technique applies to this family.
Per-layer params are stacked along leading axes, as the reference's
`lax.scan` keeps them ((n_macro, attn_every, ...) for the macro layers);
the port walks them in Python loops.
"""
from __future__ import annotations

import torch

from repro_torch.distributed.constraints import constrain_bsd
from repro_torch.models import attention as attn_lib
from repro_torch.models import mamba2 as m2
from repro_torch.models.layers import (apply_mlp, checkpointed,
                                       chunked_softmax_xent, embed,
                                       init_embedding, init_mlp, rms_norm)
from repro_torch.models.transformer import (gqa_decode_tiered, layer_params,
                                            unembed_matrix)

__all__ = ["init_ssm_lm", "ssm_lm_hidden", "ssm_lm_loss",
           "ssm_lm_decode_step", "ssm_state_shapes", "hybrid_structure",
           "init_hybrid_lm", "hybrid_lm_hidden", "hybrid_lm_loss",
           "hybrid_decode_step"]


# ---------------------------------------------------------------------------
# Mamba layer wrapper (pre-norm + residual)
# ---------------------------------------------------------------------------


def _init_mamba_layers(gen, cfg, dtype, n):
    return {"ln": torch.zeros((n, cfg.d_model), dtype=dtype,
                              device=gen.device),
            "mamba": m2.init_mamba2(gen, cfg, dtype=dtype, n_stack=n)}


def _apply_mamba_layer(lp, cfg, x, *, states=None, collect_state=False):
    h = rms_norm(x, lp["ln"], cfg.norm_eps)
    if states is None:
        y, st = m2.apply_mamba2(lp["mamba"], cfg, h,
                                return_state=collect_state)
    else:
        y, st = m2.apply_mamba2_decode(lp["mamba"], cfg, h, *states)
    return x + y, st


def _mamba_layer_seq(lp, cfg, x, collect_state):
    """A full-sequence Mamba layer, its arguments positional (the form
    `checkpointed` takes)."""
    return _apply_mamba_layer(lp, cfg, x, collect_state=collect_state)


def _mamba_stack(layers, cfg, x, *, states=None, collect_state=False,
                 remat=False):
    """Walk a stack of Mamba layers (leading axis). `states` is (conv,
    ssm) stacked the same way for decode. With `remat`, each layer is
    checkpointed, as the reference's scan body is. Returns (x, (conv,
    ssm) stacked, or None)."""
    convs, ssms = [], []
    seq = checkpointed(_mamba_layer_seq) if remat else _mamba_layer_seq
    for i in range(layers["ln"].shape[0]):
        lp = layer_params(layers, i)
        if states is None:
            x, st = seq(lp, cfg, constrain_bsd(x), collect_state)
        else:
            x, st = _apply_mamba_layer(lp, cfg, x,
                                       states=(states[0][i], states[1][i]))
        if st is not None:
            convs.append(st[0])
            ssms.append(st[1])
    if not convs:
        return x, None
    return x, (torch.stack(convs), torch.stack(ssms))


def _logits(params, x):
    return (x[:, 0] @ unembed_matrix(params)).to(torch.float32)


# ---------------------------------------------------------------------------
# Pure SSM LM (mamba2-370m)
# ---------------------------------------------------------------------------


def init_ssm_lm(gen, cfg, dtype=torch.bfloat16):
    """Random parameters drawn from `gen` on its device, in the
    reference's tree: embed, layers {ln, mamba {...}} stacked over
    layers, final_norm, and unembed when the embeddings are not tied."""
    dev = gen.device
    params = {
        "embed": init_embedding(gen, cfg.vocab_size, cfg.d_model, dtype),
        "layers": _init_mamba_layers(gen, cfg, dtype, cfg.num_layers),
        "final_norm": torch.zeros((cfg.d_model,), dtype=dtype, device=dev),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = (0.02 * torch.randn(
            (cfg.d_model, cfg.vocab_size), generator=gen,
            dtype=torch.float32, device=dev)).to(dtype)
    return params


def ssm_lm_hidden(params, cfg, tokens, *, remat=False,
                  collect_state=False):
    """tokens (B, S) -> (hidden (B, S, D), states): states is (conv (L, B,
    d_conv-1, d_xc), ssm (L, B, nh, hd, N) f32) with `collect_state`,
    else None. `remat` checkpoints each layer."""
    x = constrain_bsd(embed(params["embed"], tokens))
    x, states = _mamba_stack(params["layers"], cfg, x,
                             collect_state=collect_state, remat=remat)
    return rms_norm(x, params["final_norm"], cfg.norm_eps), states


def _next_token_loss(params, hidden, tokens):
    loss = chunked_softmax_xent(hidden[:, :-1], unembed_matrix(params),
                                tokens[:, 1:])
    return loss, {"loss": loss, "aux_loss": torch.zeros(
        (), dtype=torch.float32, device=hidden.device)}


def ssm_lm_loss(params, cfg, tokens, *, remat=True):
    """Next-token loss of the pure SSM LM. Returns (loss, {"loss",
    "aux_loss" (0)})."""
    hidden, _ = ssm_lm_hidden(params, cfg, tokens, remat=remat)
    return _next_token_loss(params, hidden, tokens)


def ssm_lm_decode_step(params, cfg, token, states):
    """states: (conv (L, B, dc-1, dxc), ssm (L, B, nh, hd, N) f32).
    Returns (logits (B, V) f32, new states)."""
    x = embed(params["embed"], token)
    x, new_states = _mamba_stack(params["layers"], cfg, x, states=states)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _logits(params, x), new_states


def ssm_state_shapes(cfg, batch, device):
    """Zero decode states: (conv (L, B, dc-1, dxc) bf16, ssm (L, B, nh,
    hd, N) f32)."""
    s = cfg.ssm
    d_xc = s.d_inner(cfg.d_model) + 2 * s.d_state
    nh = s.num_heads(cfg.d_model)
    L = cfg.num_layers
    return (
        torch.zeros((L, batch, s.d_conv - 1, d_xc), dtype=torch.bfloat16,
                    device=device),
        torch.zeros((L, batch, nh, s.head_dim, s.d_state),
                    dtype=torch.float32, device=device),
    )


# ---------------------------------------------------------------------------
# Zamba2 hybrid LM
# ---------------------------------------------------------------------------


def hybrid_structure(cfg):
    n_macro = cfg.num_layers // cfg.hybrid.attn_every
    tail = cfg.num_layers - n_macro * cfg.hybrid.attn_every
    return n_macro, tail


def init_hybrid_lm(gen, cfg, dtype=torch.bfloat16):
    """Random parameters drawn from `gen` on its device, in the
    reference's tree: embed, macro (n_macro, attn_every, ...), shared
    {attn, mlp, ln1, ln2}, tail (when L is not a multiple of
    attn_every), final_norm, unembed when not tied."""
    n_macro, tail = hybrid_structure(cfg)
    ae = cfg.hybrid.attn_every
    dev = gen.device
    macro = _init_mamba_layers(gen, cfg, dtype, n_macro * ae)

    def regroup(t):
        if isinstance(t, dict):
            return {k: regroup(v) for k, v in t.items()}
        return t.reshape(n_macro, ae, *t.shape[1:])

    shared = {
        "attn": attn_lib.init_attention(gen, cfg, dtype=dtype),
        "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.act, dtype),
        "ln1": torch.zeros((cfg.d_model,), dtype=dtype, device=dev),
        "ln2": torch.zeros((cfg.d_model,), dtype=dtype, device=dev),
    }
    params = {
        "embed": init_embedding(gen, cfg.vocab_size, cfg.d_model, dtype),
        "macro": regroup(macro),
        "shared": shared,
        "final_norm": torch.zeros((cfg.d_model,), dtype=dtype, device=dev),
    }
    if tail:
        params["tail"] = _init_mamba_layers(gen, cfg, dtype, tail)
    if not cfg.tie_embeddings:
        params["unembed"] = (0.02 * torch.randn(
            (cfg.d_model, cfg.vocab_size), generator=gen,
            dtype=torch.float32, device=dev)).to(dtype)
    return params


def _apply_shared_block(shared, cfg, x, positions, *, attn_chunk=512):
    h = rms_norm(x, shared["ln1"], cfg.norm_eps)
    a, kv = attn_lib.apply_attention(shared["attn"], cfg, h, positions,
                                     chunk=attn_chunk)
    x = x + a
    h = rms_norm(x, shared["ln2"], cfg.norm_eps)
    return x + apply_mlp(shared["mlp"], h, cfg.act), kv


def _macro_block(macro_p, shared, cfg, x, positions, attn_chunk,
                 collect_state):
    """attn_every Mamba layers, then the shared attention block."""
    x, st = _mamba_stack(macro_p, cfg, x, collect_state=collect_state)
    x, kv = _apply_shared_block(shared, cfg, constrain_bsd(x), positions,
                                attn_chunk=attn_chunk)
    return x, kv, st


def hybrid_lm_hidden(params, cfg, tokens, *, remat=False, attn_chunk=512,
                     collect_kv=False, collect_state=False):
    """tokens (B, S) -> hidden (B, S, D) and, as the reference returns
    them: with `collect_state`, (hidden, (kvs, macro_states,
    tail_states)); else (hidden, kvs). kvs is (k, v), each (n_macro, B,
    S, Hkv, hd) after RoPE, when `collect_kv`; macro_states (conv, ssm)
    stacked (n_macro, attn_every, ...); tail_states (tail, ...) or
    None. `remat` checkpoints each macro block and each tail layer, as
    the reference's scans do."""
    x = constrain_bsd(embed(params["embed"], tokens))
    s = tokens.shape[1]
    positions = torch.arange(s, dtype=torch.int32, device=x.device)
    n_macro = params["macro"]["ln"].shape[0]
    ks, vs, convs, ssms = [], [], [], []
    macro = checkpointed(_macro_block) if remat else _macro_block
    for m in range(n_macro):
        x, (k, v), st = macro(layer_params(params["macro"], m),
                              params["shared"], cfg, x, positions,
                              attn_chunk, collect_state)
        if collect_kv:
            ks.append(k)
            vs.append(v)
        if collect_state:
            convs.append(st[0])
            ssms.append(st[1])
    tail_states = None
    if "tail" in params:
        x, tail_states = _mamba_stack(params["tail"], cfg, x,
                                      collect_state=collect_state,
                                      remat=remat)
    hidden = rms_norm(x, params["final_norm"], cfg.norm_eps)
    kvs = (torch.stack(ks), torch.stack(vs)) if collect_kv else None
    if collect_state:
        return hidden, (kvs, (torch.stack(convs), torch.stack(ssms)),
                        tail_states)
    return hidden, kvs


def hybrid_lm_loss(params, cfg, tokens, *, remat=True, attn_chunk=512):
    """Next-token loss of the zamba2 hybrid LM. Returns (loss, {"loss",
    "aux_loss" (0)})."""
    hidden, _ = hybrid_lm_hidden(params, cfg, tokens, remat=remat,
                                 attn_chunk=attn_chunk)
    return _next_token_loss(params, hidden, tokens)


def hybrid_decode_step(params, cfg, token, cache, *, quant_group=64):
    """cache: {"macro_conv", "macro_ssm" (n_macro, ae, B, ...), "attn"
    tiered slots (n_macro leading), "tail_conv", "tail_ssm", "dense_len",
    "total_len"}. Returns (logits (B, V) f32, {"macro_states": (conv,
    ssm), "attn_kv": (k_new, v_new) each (n_macro, B, 1, Hkv, hd),
    "tail_states": (conv, ssm) or None}); appending and repacking are
    the tiercache manager's job."""
    total_len, dense_len = int(cache["total_len"]), int(cache["dense_len"])
    x = embed(params["embed"], token)
    positions = torch.full((1,), total_len, dtype=torch.int32,
                           device=x.device)
    shared = params["shared"]
    n_macro = params["macro"]["ln"].shape[0]
    convs, ssms, k_news, v_news = [], [], [], []
    for m in range(n_macro):
        x, (conv, ssm) = _mamba_stack(
            layer_params(params["macro"], m), cfg, x,
            states=(cache["macro_conv"][m], cache["macro_ssm"][m]))
        hn = rms_norm(x, shared["ln1"], cfg.norm_eps)
        a, (k_new, v_new) = gqa_decode_tiered(
            shared["attn"], cfg, hn, positions,
            layer_params(cache["attn"], m), dense_len, total_len,
            quant_group)
        x = x + a
        hn = rms_norm(x, shared["ln2"], cfg.norm_eps)
        x = x + apply_mlp(shared["mlp"], hn, cfg.act)
        convs.append(conv)
        ssms.append(ssm)
        k_news.append(k_new)
        v_news.append(v_new)
    tail_states = None
    if "tail" in params:
        x, tail_states = _mamba_stack(
            params["tail"], cfg, x,
            states=(cache["tail_conv"], cache["tail_ssm"]))
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _logits(params, x), {
        "macro_states": (torch.stack(convs), torch.stack(ssms)),
        "attn_kv": (torch.stack(k_news), torch.stack(v_news)),
        "tail_states": tail_states}
