"""Mixture-of-experts FFN with top-k routing (the port of the reference's
`repro/models/moe.py`).

Two dispatches with one capacity and one drop rule: a (token, choice)
pair's place in its expert's queue is counted over the flattened S*k
pairs in that order, and a pair at place >= capacity is dropped.

* ``einsum`` — the reference's GLaM/Switch one-hot dispatch and combine
  einsums. The port computes the same function by indexing, without the
  (B, S*k, E, C) one-hots (some 3 GB in float32 a layer at deepseek's
  prefill): each slot holds at most one pair, so the dispatch einsum is
  a gather, and the combine sums each token's kept pairs, their gates
  rounded to the activations' dtype as `combine_tok.astype(x.dtype)`
  rounds them, in float32 (the dot's accumulation), rounded once.
* ``gather`` — the reference's slot-indexed gather: the gate is rounded
  to the activations' dtype and multiplied in that dtype, then the
  choices are summed.

The expert products are matrix products over the expert axis (the
reference leaves them to XLA outside any Pallas kernel). Supports
deepseek-style shared experts and arctic-style parallel dense residual
FFN. Parameters may carry a leading layer axis (`n_stack`), as the
transformer stacks them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import apply_mlp, init_dense, init_mlp

__all__ = ["init_moe_layer", "apply_moe"]


def init_moe_layer(gen, cfg, dtype=torch.bfloat16, n_stack=None):
    """Router (D, E) float32, stacked expert weights (E, D, F) / (E, F,
    D), and the `shared` and `dense_residual` MLPs where the config has
    them; each with a leading (n_stack,) axis when given."""
    m = cfg.moe
    d = cfg.d_model
    params = {"router": init_dense(gen, d, m.num_experts,
                                   dtype=torch.float32, n_stack=n_stack)}
    if cfg.act in ("silu", "geglu"):
        params["w_gate"] = _expert_weights(gen, n_stack, m.num_experts, d,
                                           m.d_ff_expert, dtype)
    params["w_up"] = _expert_weights(gen, n_stack, m.num_experts, d,
                                     m.d_ff_expert, dtype)
    params["w_down"] = _expert_weights(gen, n_stack, m.num_experts,
                                       m.d_ff_expert, d, dtype)
    if m.num_shared_experts:
        params["shared"] = init_mlp(gen, d, m.num_shared_experts
                                    * m.d_ff_shared, cfg.act, dtype,
                                    n_stack=n_stack)
    if m.dense_residual_d_ff:
        params["dense_residual"] = init_mlp(gen, d, m.dense_residual_d_ff,
                                            cfg.act, dtype, n_stack=n_stack)
    return params


def _expert_weights(gen, n_stack, e, d_in, d_out, dtype):
    """0.02 * N(0, 1) drawn in float32 one (layer, expert) slice at a
    time, so that the float32 transient is one expert's (arctic's full
    (128, 7168, 4864) would be 17.8 GB)."""
    lead = (e,) if n_stack is None else (n_stack, e)
    out = torch.empty(lead + (d_in, d_out), dtype=dtype, device=gen.device)
    if out.is_meta:             # shapes alone (launch.specs): no draws
        return out
    flat = out.view(-1, d_in, d_out)
    for i in range(flat.shape[0]):
        flat[i] = (0.02 * torch.randn((d_in, d_out), generator=gen,
                                      dtype=torch.float32,
                                      device=gen.device)).to(dtype)
    return out


def _routing(router_w, x, m):
    """Float32 logits, softmax, top-k, renormalised gates. Returns
    (weights (B, S, k) float32, experts (B, S, k) int64, the Switch
    load-balance aux loss E * sum_e f_e * p_e, float32)."""
    logits = x.to(torch.float32) @ router_w
    probs = torch.softmax(logits, dim=-1)
    weights, experts = torch.topk(probs, m.top_k, dim=-1)
    weights = weights / torch.clamp(weights.sum(dim=-1, keepdim=True),
                                    min=1e-9)
    e = m.num_experts
    sel = F.one_hot(experts, e).to(torch.float32)            # (B, S, k, E)
    frac = sel.sum(dim=2).mean(dim=(0, 1))                    # per expert
    mean_p = probs.mean(dim=(0, 1))
    aux = e * (frac * mean_p).sum()
    return weights, experts, aux


def _capacity(s: int, m) -> int:
    """Slots per expert for a group of s tokens (the reference's
    `_capacity`, Python float arithmetic as it is)."""
    return max(int(s * m.top_k * m.capacity_factor / m.num_experts),
               m.top_k)


def _expert_ffn(params, x_disp, act):
    """x_disp: (B, E, C, D) -> (B, E, C, D); each expert's weights over
    its B*C slots, one batched product over the expert axis (a product
    broadcast over B would copy the weights B times)."""
    b, e, c, d = x_disp.shape
    x = x_disp.transpose(0, 1).reshape(e, b * c, d)
    up = torch.bmm(x, params["w_up"])
    if "w_gate" in params:
        g = torch.bmm(x, params["w_gate"])
        h = (F.silu(g) if act == "silu"
             else F.gelu(g, approximate="tanh")) * up
    else:
        h = torch.square(F.relu(up)) if act == "relu2" else F.gelu(
            up, approximate="tanh")
    y = torch.bmm(h, params["w_down"])
    return y.reshape(e, b, c, -1).transpose(0, 1)


def _slots(experts, c: int, e: int):
    """Each flattened (token, choice) pair's slot e*C + place, and whether
    it is kept: place = the pairs before it (in S*k order) routed to the
    same expert. Returns (slot with dropped pairs at the overflow slot
    E*C, keep), each (B, S*k)."""
    b = experts.shape[0]
    flat_e = experts.reshape(b, -1)
    onehot = F.one_hot(flat_e, e).to(torch.int32)
    pos = (torch.cumsum(onehot, dim=1, dtype=torch.int32) - onehot)
    pos = pos.gather(-1, flat_e[..., None])[..., 0]
    keep = pos < c
    slot = torch.where(keep, flat_e * c + pos, e * c)
    return slot, keep


def _moe_routed(params, cfg, x, dispatch: str):
    m = cfg.moe
    b, s, d = x.shape
    c = _capacity(s, m)
    e, k = m.num_experts, m.top_k
    weights, experts, aux = _routing(params["router"], x, m)
    slot, keep = _slots(experts, c, e)

    # each slot's source token (s: the zero row); the overflow slot takes
    # every dropped pair and is cut off
    tok = (torch.arange(s * k, device=x.device) // k).expand(b, s * k)
    src = torch.full((b, e * c + 1), s, dtype=torch.int64, device=x.device)
    src.scatter_(1, slot, tok)
    src = src[:, :e * c]
    x_pad = torch.cat([x, x.new_zeros((b, 1, d))], dim=1)
    x_disp = torch.gather(x_pad, 1, src[..., None].expand(b, e * c, d))
    y_disp = _expert_ffn(params, x_disp.reshape(b, e, c, d),
                         cfg.act).reshape(b, e * c, d)
    y_disp = torch.cat([y_disp, y_disp.new_zeros((b, 1, d))], dim=1)
    y_pairs = torch.gather(y_disp, 1, slot[..., None].expand(b, s * k, d))
    gate = (weights.reshape(b, s * k) * keep).to(x.dtype)
    if dispatch == "einsum":
        y = (y_pairs.to(torch.float32) * gate.to(torch.float32)[..., None])
        y = y.reshape(b, s, k, d).sum(dim=2).to(x.dtype)
    else:
        y = (y_pairs * gate[..., None]).reshape(b, s, k, d).sum(dim=2)
    return y, aux


def apply_moe(params, cfg, x, dispatch: str = "einsum"):
    """MoE FFN. Returns (y, aux_loss). dispatch in {einsum, gather}.

    Decode (S == 1, B > 1) flattens the batch into ONE dispatch group, as
    the reference does: per-row capacity would give every token
    E*top_k slots."""
    b, s, d = x.shape
    if s == 1 and b > 1:
        y, aux = apply_moe(params, cfg, x.reshape(1, b, d),
                           dispatch=dispatch)
        return y[0][:, None, :], aux
    if dispatch not in ("einsum", "gather"):
        raise ValueError(f"unknown dispatch {dispatch!r}")
    y, aux = _moe_routed(params, cfg, x, dispatch)
    m = cfg.moe
    if m.num_shared_experts:
        y = y + apply_mlp(params["shared"], x, cfg.act)
    if m.dense_residual_d_ff:
        y = y + apply_mlp(params["dense_residual"], x, cfg.act)
    return y, aux
