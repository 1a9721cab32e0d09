"""Config dataclasses for architectures, shapes, and run settings.

Everything is a frozen dataclass so configs hash, compare, and print
cleanly, and can be used as static args to jit'd builders.

Copy of the reference's `repro/configs/base.py`: the port imports
nothing of the reference package.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


# ---------------------------------------------------------------------------
# Sub-configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts FFN."""

    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared_experts: int = 0          # deepseek-style always-on experts
    d_ff_shared: int = 0                 # hidden dim of shared expert(s)
    dense_residual_d_ff: int = 0         # arctic-style parallel dense FFN
    capacity_factor: float = 1.25        # dispatch capacity multiplier
    router_aux_loss_coef: float = 0.001
    first_k_dense: int = 0               # leading dense layers (deepseek)
    d_ff_first_dense: int = 0            # d_ff of those layers


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek Multi-head Latent Attention."""

    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD — state space duality) block."""

    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk_size: int = 256

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def num_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class HybridConfig:
    """Zamba2-style hybrid: SSM backbone + shared attention block."""

    attn_every: int = 6                  # apply shared attn block every N layers
    shared_attn_blocks: int = 1          # number of distinct shared blocks (round-robin)


@dataclass(frozen=True)
class EncDecConfig:
    """Whisper-style encoder-decoder backbone."""

    num_encoder_layers: int = 4
    encoder_seq_len: int = 1500          # precomputed frame embeddings (stub frontend)


@dataclass(frozen=True)
class VLMConfig:
    """LLaVA-style VLM backbone: decoder + precomputed patch embeddings."""

    num_patches: int = 576               # anyres base tile (24x24 patches)


# ---------------------------------------------------------------------------
# Architecture config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                          # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int                       # 0 for attention-free archs
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    act: str = "silu"                    # silu | geglu | relu2
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    source: str = ""                     # provenance note

    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    encdec: Optional[EncDecConfig] = None
    vlm: Optional[VLMConfig] = None

    # distribution hints
    optimizer: str = "adamw"             # adamw | adafactor (480B-class)
    remat: bool = True

    # ---------------------------------------------------------------
    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """True if the arch supports O(1)-state decode (long_500k eligible)."""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs decode (whisper is enc-dec)

    def reduced(self, **overrides) -> "ArchConfig":
        """A tiny same-family config for CPU smoke tests."""
        changes: dict = dict(
            num_layers=min(self.num_layers, 2),
            d_model=128,
            num_heads=min(self.num_heads, 4) if self.num_heads else 0,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads else 0,
            head_dim=32,
            d_ff=256,
            vocab_size=512,
        )
        if self.family == "moe" and self.moe is not None:
            changes["moe"] = dataclasses.replace(
                self.moe,
                num_experts=4,
                top_k=min(self.moe.top_k, 2),
                d_ff_expert=64,
                d_ff_shared=64 if self.moe.num_shared_experts else 0,
                dense_residual_d_ff=64 if self.moe.dense_residual_d_ff else 0,
                first_k_dense=min(self.moe.first_k_dense, 1),
                d_ff_first_dense=128 if self.moe.first_k_dense else 0,
            )
        if self.mla is not None:
            changes["mla"] = MLAConfig(
                kv_lora_rank=32, qk_nope_head_dim=32, qk_rope_head_dim=16,
                v_head_dim=32)
            changes["head_dim"] = 32
        if self.ssm is not None:
            changes["ssm"] = dataclasses.replace(
                self.ssm, d_state=16, head_dim=32, chunk_size=32)
        if self.hybrid is not None:
            changes["hybrid"] = dataclasses.replace(self.hybrid, attn_every=2)
            changes["num_layers"] = 4
        if self.encdec is not None:
            changes["encdec"] = EncDecConfig(num_encoder_layers=2, encoder_seq_len=64)
        if self.vlm is not None:
            changes["vlm"] = VLMConfig(num_patches=16)
        changes.update(overrides)
        return dataclasses.replace(self, **changes)

    # ---------------------------------------------------------------
    # Parameter counting (used by roofline MODEL_FLOPS and memory planning)
    # ---------------------------------------------------------------
    def param_count(self) -> int:
        return _param_count(self)

    def active_param_count(self) -> int:
        return _param_count(self, active_only=True)


def _attn_params(cfg: ArchConfig) -> int:
    d = cfg.d_model
    if cfg.mla is not None:
        m = cfg.mla
        qk_dim = m.qk_nope_head_dim + m.qk_rope_head_dim
        # q proj, kv down-proj, kv up-proj (k_nope + v), k_rope shared
        q = d * cfg.num_heads * qk_dim
        kv_down = d * (m.kv_lora_rank + m.qk_rope_head_dim)
        kv_up = m.kv_lora_rank * cfg.num_heads * (m.qk_nope_head_dim + m.v_head_dim)
        o = cfg.num_heads * m.v_head_dim * d
        return q + kv_down + kv_up + o
    hd = cfg.head_dim
    q = d * cfg.num_heads * hd
    k = d * cfg.num_kv_heads * hd
    v = d * cfg.num_kv_heads * hd
    o = cfg.num_heads * hd * d
    return q + k + v + o


def _ffn_params(d_model: int, d_ff: int, act: str) -> int:
    n_in = 2 if act in ("silu", "geglu") else 1  # gated acts have two in-projs
    return (n_in + 1) * d_model * d_ff


def _ssm_params(cfg: ArchConfig) -> int:
    s = cfg.ssm
    d = cfg.d_model
    d_in = s.d_inner(d)
    nh = s.num_heads(d)
    in_proj = d * (2 * d_in + 2 * s.d_state + nh)  # x, z, B, C, dt
    conv = s.d_conv * (d_in + 2 * s.d_state)
    out = d_in * d
    extra = 2 * nh + d_in  # A_log, dt_bias, norm
    return in_proj + conv + out + extra


def _layer_params(cfg: ArchConfig, layer_idx: int) -> int:
    d = cfg.d_model
    norms = 2 * d
    if cfg.family == "ssm":
        return _ssm_params(cfg) + d  # one norm
    if cfg.family == "hybrid":
        return _ssm_params(cfg) + d  # shared attn counted separately
    if cfg.moe is not None:
        m = cfg.moe
        attn = _attn_params(cfg)
        if layer_idx < m.first_k_dense:
            return attn + _ffn_params(d, m.d_ff_first_dense, cfg.act) + norms
        total = m.num_experts * _ffn_params(d, m.d_ff_expert, cfg.act)
        total += m.num_shared_experts * _ffn_params(d, m.d_ff_shared, cfg.act)
        if m.dense_residual_d_ff:
            total += _ffn_params(d, m.dense_residual_d_ff, cfg.act)
        total += d * m.num_experts  # router
        return attn + total + norms
    return _attn_params(cfg) + _ffn_params(d, cfg.d_ff, cfg.act) + norms


def _active_layer_params(cfg: ArchConfig, layer_idx: int) -> int:
    if cfg.moe is None or layer_idx < (cfg.moe.first_k_dense if cfg.moe else 0):
        return _layer_params(cfg, layer_idx)
    m = cfg.moe
    d = cfg.d_model
    attn = _attn_params(cfg)
    act = m.top_k * _ffn_params(d, m.d_ff_expert, cfg.act)
    act += m.num_shared_experts * _ffn_params(d, m.d_ff_shared, cfg.act)
    if m.dense_residual_d_ff:
        act += _ffn_params(d, m.dense_residual_d_ff, cfg.act)
    act += d * m.num_experts
    return attn + act + 2 * d


def _param_count(cfg: ArchConfig, active_only: bool = False) -> int:
    per_layer = _active_layer_params if active_only else _layer_params
    total = sum(per_layer(cfg, i) for i in range(cfg.num_layers))
    # shared attention block (hybrid)
    if cfg.hybrid is not None:
        shared = _attn_params(cfg) + _ffn_params(cfg.d_model, cfg.d_ff, cfg.act)
        total += cfg.hybrid.shared_attn_blocks * (shared + 2 * cfg.d_model)
    # embeddings + head + final norm
    emb = cfg.vocab_size * cfg.d_model
    total += emb if cfg.tie_embeddings else 2 * emb
    total += cfg.d_model
    # encoder stack (whisper)
    if cfg.encdec is not None:
        enc_layer = _attn_params(cfg) + _ffn_params(cfg.d_model, cfg.d_ff, cfg.act) + 2 * cfg.d_model
        # decoder cross-attention adds one attn block per decoder layer
        total += cfg.encdec.num_encoder_layers * enc_layer
        total += cfg.num_layers * (_attn_params(cfg) + cfg.d_model)
        total += cfg.d_model  # encoder final norm
    return int(total)


# ---------------------------------------------------------------------------
# Input shapes
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                            # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4_096, 256, "train"),
    ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    ShapeConfig("decode_32k", 32_768, 128, "decode"),
    ShapeConfig("long_500k", 524_288, 1, "decode"),
)

SHAPES_BY_NAME = {s.name: s for s in SHAPES}


def shape_applicable(arch: ArchConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether (arch, shape) is a runnable dry-run cell.

    Returns (ok, reason-if-skipped). long_500k needs sub-quadratic decode —
    skipped for pure full-attention archs per the assignment, recorded in
    DESIGN.md / EXPERIMENTS.md.
    """
    if shape.name == "long_500k" and not arch.sub_quadratic:
        return False, "long_500k skipped: full-attention arch (quadratic)"
    return True, ""
