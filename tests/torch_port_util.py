"""Shared fixtures of the port's equivalence tests (tests/test_torch_*.py).

Arrays cross between the two packages as numpy: `to_torch` and
`to_numpy` carry bf16 by its bits (numpy holds it as ml_dtypes'
`bfloat16`).

Both implementations get the same inputs: op arrays made with numpy by
the reference's `workloads.build_ops` (`hm_0`, `proj_0` at the paper's
128-plane scale, truncated to MAX_OPS ops, plus an `ir.pad_ops`-contract
pad tail of TRIM_QUANTUM ops). JAX stays on the CPU; results are compared
as numpy arrays, value and dtype.
"""
from __future__ import annotations

import contextlib

import ml_dtypes
import numpy as np
import torch

import repro.workloads as jwl
from repro.configs.ssd_paper import PAPER_SSD as J_PAPER_SSD
from repro.workloads.compress import TRIM_QUANTUM
from repro_torch.configs.ssd_paper import PAPER_SSD as T_PAPER_SSD

CFG_J = J_PAPER_SSD.scaled(128)
CFG_T = T_PAPER_SSD.scaled(128)
N_LOGICAL = min(CFG_J.total_pages, 1 << 16)
MAX_OPS = 2048
PAPER_POLICIES = ("baseline", "ips", "ips_agc", "coop")
MODES = ("daily", "bursty")


def with_pad_tail(ops: dict, n_pad: int) -> dict:
    """Append `n_pad` identical tail pads (last arrival, lba 0,
    is_write -1), as `ir.pad_ops` does."""
    out = dict(ops)
    out["arrival_ms"] = np.concatenate(
        [ops["arrival_ms"],
         np.full(n_pad, ops["arrival_ms"][-1], np.float32)])
    out["lba"] = np.concatenate([ops["lba"], np.zeros(n_pad, np.int32)])
    out["is_write"] = np.concatenate(
        [ops["is_write"], np.full(n_pad, -1, ops["is_write"].dtype)])
    return out


def fixture_ops(name: str, max_ops: int = MAX_OPS,
                n_pad: int = TRIM_QUANTUM) -> dict:
    ops = jwl.build_ops(name, N_LOGICAL, capacity_pages=CFG_J.total_pages)
    return with_pad_tail(jwl.truncate_trace(ops, max_ops), n_pad)


def assert_leaf_equal(ref, got, label: str) -> None:
    """`got` (a torch tensor) equals `ref` (a JAX or numpy array) in value
    and dtype, bf16 by its bits; on a mismatch name the first differing
    flat index. An absent optional field (None) must be absent on both
    sides; a nested carry (the wear state) is compared leaf by leaf."""
    if ref is None or got is None:
        assert ref is None and got is None, \
            f"{label}: reference {type(ref)} vs port {type(got)}"
        return
    if isinstance(got, tuple):
        assert_state_equal(ref, got, label)
        return
    ref = np.asarray(ref)
    got = to_numpy(got)
    assert got.dtype == ref.dtype, f"{label}: dtype {got.dtype} != {ref.dtype}"
    assert got.shape == ref.shape, f"{label}: shape {got.shape} != {ref.shape}"
    if ref.dtype == ml_dtypes.bfloat16:
        ref, got = ref.view(np.uint16), got.view(np.uint16)
    if not np.array_equal(got, ref):
        bad = np.flatnonzero(got.reshape(-1) != ref.reshape(-1))
        i = int(bad[0])
        raise AssertionError(
            f"{label}: {bad.size} element(s) differ, first at flat index "
            f"{i}: port {got.reshape(-1)[i]!r} vs reference "
            f"{ref.reshape(-1)[i]!r}")


def assert_state_equal(ref_state, got_state, label: str) -> None:
    """Every leaf of the port's SimState (or Reduced) equals the
    reference's field of the same name."""
    for field in got_state._fields:
        assert_leaf_equal(getattr(ref_state, field),
                          getattr(got_state, field), f"{label}: {field}")


def to_torch(x, device="cpu") -> torch.Tensor:
    """A numpy (or JAX) array as a tensor of the same dtype."""
    arr = np.ascontiguousarray(np.asarray(x))
    if arr.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(arr.view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr.copy()).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array of the same dtype (bf16 included)."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


@contextlib.contextmanager
def reference_registry():
    """The reference's policy registry as a fresh process imports it.
    Another test file in the same worker may register more policies
    (`repro.search.space.register_space` adds the unnamed compositions,
    each documented "search: auto-registered ..."), and what is built
    from the registry (`sensitivity_grid`, the name list) would then
    grow. Inside the block those entries are set aside."""
    from repro.core.ssd.policies import registry as jreg
    saved = dict(jreg._REGISTRY)
    jreg._REGISTRY.clear()
    jreg._REGISTRY.update({
        n: e for n, e in saved.items()
        if not e.doc.startswith("search: auto-registered")})
    try:
        yield
    finally:
        jreg._REGISTRY.clear()
        jreg._REGISTRY.update(saved)


def host_trace(name: str, mode: str, max_ops: int, n_pad: int = 64) -> dict:
    """A trace as the reference's host-tier tests build it
    (tests/test_hostcache.py): `flush_burst` from its generator (bursty:
    the sequential-rewrite transform) or an MSR name, truncated to
    `max_ops` ops, then `n_pad` tail pads (`with_pad_tail`); numpy op
    arrays."""
    from repro.core.ssd.workloads import make_trace, truncate_trace
    from repro.workloads.generators import flush_burst
    if name == "flush_burst":
        tr = flush_burst(N_LOGICAL, capacity_pages=CFG_J.total_pages)
        if mode == "bursty":
            tr = tr.to_bursty(N_LOGICAL)
        ops = tr.truncate(max_ops).compile()
    else:
        ops = truncate_trace(make_trace(name, N_LOGICAL, mode=mode,
                                        capacity_pages=CFG_J.total_pages),
                             max_ops)
    ops = {k: np.asarray(ops[k])[:max_ops]
           for k in ("arrival_ms", "lba", "is_write")}
    return with_pad_tail(ops, n_pad)


# every host-tier mode x promote x flush, on small geometries whose
# evictions, watermark bursts, idle-gap flushes (a 0.5 ms gap) and `nth`
# promotions all fire within a thousand flush_burst ops; flush_per_op 1,
# 2 and 4 (K = 3, 4, 6); the four paper policies in turn, so a dual (coop)
# and an AGC (ips_agc, coop) composition take every mode
HOST_CASES = tuple(
    (dict(mode=mode, promote=promote, flush=flush,
          sets=(8, 16)[i % 2], ways=(2, 4)[i % 2], flush_per_op=(1, 2, 4)[i % 3],
          flush_gap_ms=0.5), PAPER_POLICIES[i % 4])
    for i, (mode, promote, flush) in enumerate(
        (m, p, f) for m in ("wb", "wt", "wa") for p in ("always", "nth")
        for f in ("watermark", "idle")))
HOST_OPS = {"daily": 1024, "bursty": 512}
HOST_WINDOW = 256


def host_case_id(case) -> str:
    kw, policy = case
    return (f"{kw['mode']}-{kw['promote']}-{kw['flush']}-"
            f"{kw['sets']}x{kw['ways']}-f{kw['flush_per_op']}-{policy}")


# ---------------------------------------------------------------------------
# MoE routes, teacher-forced as tokens are
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def recorded_routes(j_moe, log: list):
    """Within the context, the reference's `_routing` appends each call's
    (weights, experts) to `log` as numpy, in call order (an ordered debug
    callback, so jitted and scanned calls record too). Functions jitted
    within the context keep the recording."""
    import jax

    orig = j_moe._routing

    def record(router_w, x, m):
        weights, experts, aux = orig(router_w, x, m)
        jax.debug.callback(lambda w, e: log.append((np.asarray(w),
                                                    np.asarray(e))),
                           weights, experts, ordered=True)
        return weights, experts, aux

    j_moe._routing = record
    try:
        yield
    finally:
        j_moe._routing = orig


@contextlib.contextmanager
def replayed_routes(t_moe, log: list, flips: list):
    """Within the context, each call of the port's `_routing` returns the
    next recorded (weights, experts) of the reference, with its own aux
    loss: routing is discontinuous, and a near-tie between the k-th and
    the (k+1)-th expert that rounds the other way in one package would
    move the logits for no fault of either. `flips` gets [calls, (token)
    top-k sets, sets that the port's own routing would have chosen
    otherwise]."""
    orig = t_moe._routing
    it = iter(log)
    flips[:] = [0, 0, 0]

    def replay(router_w, x, m):
        weights, experts, aux = orig(router_w, x, m)
        jw, je = next(it)
        if je.shape != tuple(experts.shape):
            raise AssertionError(f"route {flips[0]}: recorded {je.shape}, "
                                 f"the port routes {tuple(experts.shape)}")
        own = np.sort(experts.cpu().numpy(), axis=-1)
        differ = (own != np.sort(je, axis=-1)).any(axis=-1)
        flips[0] += 1
        flips[1] += differ.size
        flips[2] += int(differ.sum())
        return (torch.from_numpy(np.array(jw, np.float32)).to(weights.device),
                torch.from_numpy(np.array(je, np.int64)).to(experts.device),
                aux)

    t_moe._routing = replay
    try:
        yield
    finally:
        t_moe._routing = orig
    if next(it, None) is not None:
        raise AssertionError("the port routed fewer times than the "
                             "reference recorded")


@contextlib.contextmanager
def replayed_routes_differentiable(t_moe, log: list, flips: list):
    """`replayed_routes` for the gradient: each call of the port's
    `_routing` routes to the next recorded experts of the reference, but
    its gate weights are the port's own router probabilities at those
    experts, renormalised, and its aux loss counts those experts, so the
    router's gradient flows as in the reference. `flips` as in
    `replayed_routes`."""
    import torch.nn.functional as F

    orig = t_moe._routing
    it = iter(log)
    flips[:] = [0, 0, 0]

    def replay(router_w, x, m):
        _, experts, _ = orig(router_w, x, m)
        _, je = next(it)
        je = torch.from_numpy(np.array(je, np.int64)).to(experts.device)
        if je.shape != experts.shape:
            raise AssertionError(f"route {flips[0]}: recorded "
                                 f"{tuple(je.shape)}, the port routes "
                                 f"{tuple(experts.shape)}")
        differ = (torch.sort(experts, dim=-1).values
                  != torch.sort(je, dim=-1).values).any(dim=-1)
        flips[0] += 1
        flips[1] += differ.numel()
        flips[2] += int(differ.sum())
        probs = torch.softmax(x.to(torch.float32) @ router_w, dim=-1)
        weights = probs.gather(-1, je)
        weights = weights / torch.clamp(weights.sum(dim=-1, keepdim=True),
                                        min=1e-9)
        sel = F.one_hot(je, m.num_experts).to(torch.float32)
        frac = sel.sum(dim=2).mean(dim=(0, 1))
        aux = m.num_experts * (frac * probs.mean(dim=(0, 1))).sum()
        return weights, je, aux

    t_moe._routing = replay
    try:
        yield
    finally:
        t_moe._routing = orig
    if next(it, None) is not None:
        raise AssertionError("the port routed fewer times than the "
                             "reference recorded")
