"""Port vs reference: the SSD intra-chunk backward's wrapper,
`ssd_intra_bwd`, and its place in `SsdIntraFn`.

On the CPU the wrapper runs its plain version (`ref.intra_chunk_bwd_ref`:
autograd through the port's `ref.intra_chunk_ref`); it is held to
`jax.vjp` of the reference's `repro.kernels.ssd_scan.ref.intra_chunk_ref`
with random cotangents on all three outputs, made with numpy from seeds,
at the float32 tolerance of tests/test_torch_train.py: 1e-5 of each
gradient's largest magnitude. A float32 model of the kernel's own
decomposition (`csrc/ssd_intra_bwd.cu`: dS formed once a head, dcb and
the state term of dB as partials over groups of heads added in group
order, the row sums of P a column tile, the reverse cumsum in double) is
held to the plain version at the same tolerance, so a wrong derivation
fails here before the card sees it.
The kernel itself is held to the plain version on the card:
`-m cuda tests/test_torch_cuda.py -k SsdIntraBwd`.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.ref import intra_chunk_ref as j_intra
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan import ref as ssd_ref
from torch_port_util import to_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402  (jax-free; its planted faults)

F32_TOL = 1e-5          # of each gradient's largest magnitude
NAMES = ("dx", "ddt", "dA", "dB", "dC")
TILE = 64               # the kernel's tile rows
GROUP, GROUP_WG = 4, 8  # heads a block of its head pass: mma.sync, wgmma
WG_WIDTHS = ((64, 64), (64, 128))   # (hd, N) of the wgmma form


def group_heads(hd, n):
    """Heads a group of the kernel's head pass at these widths."""
    return GROUP_WG if (hd, n) in WG_WIDTHS else GROUP


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    """One torch thread a process while this module runs: its tensors are
    small, and several test processes share the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _inputs(bt, nc, q, nh, hd, n, seed):
    """x, dt, A, B, C as the path gives them (dt positive, A negative)
    and the cotangents dy, dstates, dcum, float32 numpy."""
    rng = np.random.default_rng(seed)
    f = np.float32
    return [rng.standard_normal((bt, nc, q, nh, hd)).astype(f),
            (0.5 * rng.random((bt, nc, q, nh)) + 0.05).astype(f),
            -(rng.random(nh) + 0.5).astype(f),
            rng.standard_normal((bt, nc, q, n)).astype(f),
            rng.standard_normal((bt, nc, q, n)).astype(f),
            rng.standard_normal((bt, nc, q, nh, hd)).astype(f),
            rng.standard_normal((bt, nc, nh, hd, n)).astype(f),
            rng.standard_normal((bt, nc, q, nh)).astype(f)]


def _close(got, want, label):
    want = np.asarray(want, np.float32)
    got = got.detach().numpy()
    assert got.shape == want.shape, f"{label}: {got.shape} != {want.shape}"
    assert np.isfinite(got).all(), f"{label}: non-finite values"
    np.testing.assert_allclose(got, want, rtol=F32_TOL,
                               atol=F32_TOL * float(np.abs(want).max() + 1e-30),
                               err_msg=label)


# (Bt, nc, Q, nh, hd, N): a one-row chunk, a whole fragment, a ragged
# chunk; one to four heads; hd and N of 16 and 32
SHAPES = ((2, 2, 1, 2, 16, 16), (1, 2, 16, 1, 32, 16),
          (2, 1, 16, 4, 16, 32), (1, 2, 40, 3, 32, 32))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_backward_matches_the_reference_vjp(shape):
    """dx, ddt, dA, dB, dC of `ref.intra_chunk_bwd_ref` against `jax.vjp`
    of the reference's `intra_chunk_ref` (which takes exp before its mask:
    finite at these chunks), compiled as one function."""
    arrs = _inputs(*shape, seed=sum(shape))
    want = jax.jit(lambda *a: jax.vjp(j_intra, *a[:5])[1](a[5:]))(
        *map(jnp.asarray, arrs))
    got = ssd_ops.ssd_intra_bwd(*map(to_torch, arrs))
    for name, g, w in zip(NAMES, got, want):
        _close(g, w, f"{shape} {name}")


def kernel_model(x, dt, A, B, C, dy, dst, dcum):
    """The kernel's decomposition in float32 on the CPU: dS = dy x^T per
    head, formed once, and from it S = cb e dt_j, P = dS * S and dcb's
    term dS * dt_j * e; dcb the sum, in group order, of each group's
    partial, its heads' terms added in order (groups of
    `group_heads(hd, N)`); dx = w (B dst^T) + S^T dy; dB's state term a
    sum of partials over the same groups; the row sums of P as partials
    over column tiles of TILE, added in order; d_j = (dw_j dt_j)
    exp(cum_end - cum_j), the column tiles' sums of d added to dcum_end;
    da the reverse cumsum of dcum in double; dA = sum of da dt in
    double."""
    bt, nc, q, nh, hd = x.shape
    n = B.shape[-1]
    group = group_heads(hd, n)
    bc = bt * nc
    x, dy = x.reshape(bc, q, nh, hd), dy.reshape(bc, q, nh, hd)
    dt, dcum = dt.reshape(bc, q, nh), dcum.reshape(bc, q, nh)
    B, C = B.reshape(bc, q, n), C.reshape(bc, q, n)
    dst = dst.reshape(bc, nh, hd, n)
    cum = torch.cumsum((dt * A).double(), 1).float()
    causal = torch.ones((q, q), dtype=torch.bool).tril()[None, :, :, None]
    e = torch.where(causal, torch.exp(torch.where(
        causal, cum[:, :, None, :] - cum[:, None, :, :], 0.0)), 0.0)
    cb = torch.einsum("bin,bjn->bij", C, B)[..., None]
    dS = torch.einsum("bihp,bjhp->bijh", dy, x)
    dtj = dt[:, None, :, :]
    dcb = torch.zeros(bc, q, q)
    for g in range(0, nh, group):
        part = (dS[..., g] * dtj[..., g]) * e[..., g]
        for h in range(g + 1, min(nh, g + group)):
            part = part + (dS[..., h] * dtj[..., h]) * e[..., h]
        dcb = dcb + part
    cbe = cb * e
    P = ((dS * dtj) * cb) * e
    V = torch.einsum("bjn,bhpn->bjhp", B, dst)
    dte = torch.exp(cum[:, -1:, :] - cum)
    w = dte * dt
    dw = (V * x).sum(-1)
    dx = V * w[..., None] + torch.einsum("bijh,bihp->bjhp", cbe * dtj, dy)
    dbs = torch.zeros(bc, q, n)
    for g in range(0, nh, group):
        part = torch.zeros(bc, q, n)
        for h in range(g, min(nh, g + group)):
            part = part + torch.einsum("bjp,bpn->bjn",
                                       x[:, :, h] * w[:, :, h, None],
                                       dst[:, h])
        dbs = dbs + part
    d = (dw * dt) * dte
    rows, end = torch.zeros(bc, q, nh), torch.zeros(bc, nh)
    for j0 in range(0, q, TILE):
        rows = rows + P[:, :, j0:j0 + TILE].sum(2)
        end = end + d[:, j0:j0 + TILE].sum(1)
    dc = dcum + rows + (-P.sum(1) - d)
    dc[:, -1] += end
    da = dc.double().flip(1).cumsum(1).flip(1).float()
    ddt = (dS * cbe).sum(1) + dw * dte + da * A
    return (dx.reshape(bt, nc, q, nh, hd), ddt.reshape(bt, nc, q, nh),
            (da.double() * dt.double()).sum((0, 1)).float(),
            (torch.einsum("bij,bin->bjn", dcb, C) + dbs).reshape(bt, nc, q, n),
            torch.einsum("bij,bjn->bin", dcb, B).reshape(bt, nc, q, n))


@pytest.mark.parametrize("shape,a", [
    ((2, 2, 40, 3, 16, 32), None),       # one ragged tile, one group
    ((1, 2, 100, 5, 16, 16), None),      # two tiles, a ragged group
    ((1, 1, 256, 2, 16, 16), -1.0),      # four tiles; exp(+200) if unmasked
    ((1, 1, 256, 9, 64, 64), None)],     # the wgmma form: a ragged group
    ids=("q40", "q100", "q256-A-1", "q256-wgmma"))
def test_kernel_decomposition_matches_the_plain_backward(shape, a):
    """`kernel_model` against `ref.intra_chunk_bwd_ref` on the same
    inputs, within 1e-5 of each gradient's largest: the kernel's algebra,
    its masks and its summation orders give the plain version's
    gradient."""
    arrs = _inputs(*shape, seed=7 + shape[2])
    if a is not None:
        arrs[2][:] = a
    ts = list(map(to_torch, arrs))
    want = ssd_ref.intra_chunk_bwd_ref(*ts)
    got = kernel_model(*ts)
    for name, g, w in zip(NAMES, got, want):
        assert torch.isfinite(w).all(), name
        _close(g, w.numpy(), f"{shape} {name}")


def test_function_routes_its_backward_to_the_plain_version(monkeypatch):
    """On the CPU, `SsdIntraFn`'s backward is `ssd_intra_bwd` (looked up
    on the module at every call), which takes the plain version: no
    launch, one backward call, the gradients those of the plain version."""
    arrs = _inputs(1, 2, 16, 2, 16, 16, seed=3)
    seen = []
    plain = ssd_ref.intra_chunk_bwd_ref

    def spy(*args):
        seen.append(args[0].shape)
        return plain(*args)

    monkeypatch.setattr(ssd_ref, "intra_chunk_bwd_ref", spy)
    ssd_ops.reset()
    ts = [to_torch(t).requires_grad_(True) for t in arrs[:5]]
    outs = ssd_ops.SsdIntraFn.apply(*ts)
    got = torch.autograd.grad(outs, ts, [to_torch(t) for t in arrs[5:]])
    assert seen == [ts[0].shape]
    assert ssd_ops.BACKWARD.calls == 1
    assert ssd_ops.BWD_LAUNCHER.launches == 0
    want = plain(*map(to_torch, arrs))
    for name, g, w in zip(NAMES, got, want):
        assert torch.equal(g, w), name


@pytest.mark.parametrize("missing", (0, 1, 2), ids=("dy", "dstates", "dcum"))
def test_a_none_cotangent_counts_as_zeros(missing):
    """Each cotangent None in turn gives the gradients of its zeros, in
    the wrapper and through the Function (an output left out of the loss);
    all three None give zeros."""
    arrs = list(map(to_torch, _inputs(2, 1, 16, 2, 16, 32, seed=11)))
    none = list(arrs[5:])
    none[missing] = None
    zeros = list(arrs[5:])
    zeros[missing] = torch.zeros_like(zeros[missing])
    got = ssd_ops.ssd_intra_bwd(*arrs[:5], *none)
    want = ssd_ops.ssd_intra_bwd(*arrs[:5], *zeros)
    for name, g, w in zip(NAMES, got, want):
        assert torch.equal(g, w), name
    ts = [t.clone().requires_grad_(True) for t in arrs[:5]]
    outs = ssd_ops.SsdIntraFn.apply(*ts)
    kept = [i for i in range(3) if i != missing]
    through = torch.autograd.grad([outs[i] for i in kept], ts,
                                  [arrs[5 + i] for i in kept])
    for name, g, w in zip(NAMES, through, want):
        torch.testing.assert_close(g, w, rtol=F32_TOL, atol=F32_TOL * float(
            w.abs().max()), msg=name)
    for name, g in zip(NAMES, ssd_ops.ssd_intra_bwd(*arrs[:5], None, None,
                                                    None)):
        assert not g.any(), name


def _kernel_args(monkeypatch):
    """The kernel's route taken as on a card; the launch recorded, not
    made (there is no card here), the scratch size a stand-in."""
    calls = []

    class Lib:
        @staticmethod
        def ssd_intra_bwd_work(bc, q, nh, n):
            return 64

    monkeypatch.setattr(ssd_ops, "kernel_route", lambda *a: True)
    monkeypatch.setattr(ssd_ops.BWD_LIB, "load", lambda: Lib)
    monkeypatch.setattr(ssd_ops.BWD_LAUNCHER, "launch",
                        lambda name, args, dev: calls.append(args))
    return calls


def test_the_wrapper_hands_the_kernel_aligned_tensors(monkeypatch):
    """On the kernel's route, inputs and cotangents that start off a
    16-byte boundary reach the C call as aligned copies, a None cotangent
    as zeros, with (Bt * nc, Q, nh, hd, N) after the pointers."""
    calls = _kernel_args(monkeypatch)
    arrs = list(map(to_torch, _inputs(1, 2, 24, 3, 16, 32, seed=5)))

    def shifted(t):
        buf = torch.empty(t.numel() + 1)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        return view

    moved = [shifted(t) if i in (0, 3, 4, 5, 6) else t
             for i, t in enumerate(arrs)]
    assert all(moved[i].data_ptr() % 16 for i in (0, 3, 4, 5, 6))
    moved[7] = None
    ssd_ops.ssd_intra_bwd(*moved)
    (args,) = calls
    ptrs, sizes = args[:14], args[14:]
    assert sizes == (2, 24, 3, 16, 32)
    assert all(ptrs[i] % 16 == 0 for i in (0, 3, 4, 5, 6, 13))
    assert ptrs[1] == arrs[1].data_ptr() and ptrs[2] == arrs[2].data_ptr()


def test_the_wrapper_refuses_what_the_kernel_does_not_take(monkeypatch):
    """On the kernel's route: widths outside HEAD_DIMS and STATE_DIMS, a
    chunk past MAX_CHUNK, another dtype, a non-contiguous or mis-shaped
    cotangent, and inputs that require a gradient while autograd records
    are refused before anything launches."""
    calls = _kernel_args(monkeypatch)
    arrs = list(map(to_torch, _inputs(1, 1, 16, 2, 32, 16, seed=9)))
    x, dt, A, B, C, dy, dst, dcum = arrs

    def call(**swap):
        args = dict(zip(("x", "dt", "A", "B", "C", "dy", "dstates", "dcum"),
                        arrs))
        args.update(swap)
        return ssd_ops.ssd_intra_bwd(*args.values())

    with pytest.raises(ValueError, match="head_dim"):
        call(x=x[..., :24].contiguous(), dy=dy[..., :24].contiguous())
    with pytest.raises(ValueError, match="d_state"):
        call(B=B[..., :8].contiguous(), C=C[..., :8].contiguous())
    with pytest.raises(ValueError, match="chunk"):
        big = list(map(to_torch, _inputs(1, 1, 512, 1, 16, 16, seed=1)))
        ssd_ops.ssd_intra_bwd(*big)
    with pytest.raises(TypeError, match="dtype"):
        call(dy=dy.double())
    with pytest.raises(ValueError, match="contiguous"):
        call(dstates=dst.transpose(3, 4).contiguous().transpose(3, 4))
    with pytest.raises(ValueError, match="dcum"):
        call(dcum=dcum[:, :, :8])
    with pytest.raises(RuntimeError, match="require a gradient"):
        call(x=x.clone().requires_grad_(True))
    assert calls == []


@pytest.mark.parametrize("index,moves", [(0, ("ddt", "dA")), (1, ("dB",))],
                         ids=("no-decay", "no-state-dB"))
def test_planted_backward_faults_move_their_gradients(index, moves):
    """Each planted SSD backward fault of `chip_smoke.py`'s phase 12 (the
    decay's gradient dropped; the state term dropped from dB), run
    through `SsdIntraFn` on the plain route, moves the gradients it
    touches by far more than the float32 tolerance and leaves the others
    as they were."""
    honest = ssd_ops.ssd_intra_bwd
    name, ctx, must_catch = chip_smoke._ssd_bwd_faults()[index]
    assert must_catch
    arrs = list(map(to_torch, _inputs(1, 2, 40, 3, 16, 32, seed=13)))

    def grads():
        ts = [t.clone().requires_grad_(True) for t in arrs[:5]]
        return torch.autograd.grad(ssd_ops.SsdIntraFn.apply(*ts), ts,
                                   arrs[5:])
    want = grads()
    with ctx:
        got = grads()
    for label, g, w in zip(NAMES, got, want):
        moved = float((g - w).abs().max() / w.abs().max())
        if label in moves:
            assert moved > 1e-2, (name, label, moved)
        else:
            assert moved <= F32_TOL, (name, label, moved)
    assert ssd_ops.ssd_intra_bwd is honest


def test_backward_path_check_sees_the_state_term_fault():
    """`chip_smoke.shadow_intra_bwd` holds each backward call on the path
    to its plain version: on the plain route the honest call passes with
    no error at all, and the fault that drops the state term from dB
    fails it (the gradient check cannot see that fault at mamba2-370m's
    floor)."""
    arrs = list(map(to_torch, _inputs(1, 2, 40, 3, 16, 32, seed=17)))

    def run(*contexts):
        log = []
        ts = [t.clone().requires_grad_(True) for t in arrs[:5]]
        with contexts[0] if contexts else chip_smoke._replaced():
            with chip_smoke.shadow_intra_bwd(log):
                torch.autograd.grad(ssd_ops.SsdIntraFn.apply(*ts), ts,
                                    arrs[5:])
        return chip_smoke._path_summary(log)

    honest = run()
    assert honest["calls"] == 1 and honest["passes"]
    assert honest["max_over_tol"] == 0.0
    _, ctx, _ = chip_smoke._ssd_bwd_faults()[1]
    faulty = run(ctx)
    assert not faulty["passes"]
    assert faulty["worst_over_tol"]["dB"] > 1.0
    assert max(v for k, v in faulty["worst_over_tol"].items()
               if k != "dB") == 0.0
