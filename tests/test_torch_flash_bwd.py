"""Port vs reference: the flash backward's wrapper, `flash_bwd`, and its
place in `FlashAttnFn`.

On the CPU the wrapper runs its plain version (`ref.flash_bwd_ref`: the
reference's chunked recomputation over the kernel route's padding); it
is held to `jax.vjp` of the reference's `custom_vjp` `_flash` (through
`attend_chunked`, on the causal self-attention over positions 0..S-1)
on inputs made with numpy from seeds, at the float32 tolerance of
tests/test_torch_train.py: 1e-5 of each gradient's largest magnitude.
The kernel itself (`csrc/flash_bwd.cu`) is held to the plain version on
the card: `-m cuda tests/test_torch_cuda.py -k FlashBwd`.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as j_attn
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention import ref as flash_ref
from torch_port_util import to_numpy, to_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402  (jax-free; its planted faults)

F32_TOL = 1e-5          # of each gradient's largest magnitude


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    """One torch thread a process while this module runs: its tensors are
    small, and several test processes share the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _inputs(b, s, h, hkv, hd, hd_v, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, hd)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, hd_v)).astype(np.float32)
    dout = rng.standard_normal((b, h, s, hd_v)).astype(np.float32)
    return q, k, v, dout


def _j_grads(q, k, v, dout, chunk):
    """(dq, dk, dv) of the reference's causal attention over 0..S-1 for
    the cotangent dout (B, H, S, hd_v) of its float32 output."""
    pos = jnp.arange(q.shape[1], dtype=jnp.int32)

    def f(q, k, v):
        return j_attn.attend_chunked(q, k, v, q_positions=pos,
                                     kv_positions=pos, causal=True,
                                     chunk=chunk)
    _, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return vjp(jnp.asarray(dout.transpose(0, 2, 1, 3)))


def _t_grads(q, k, v, dout, chunk, scale):
    """`flash_bwd` on CPU tensors (its plain version) from the plain
    forward's out and lse."""
    tq, tk, tv, tdo = (to_torch(x) for x in (q, k, v, dout))
    out, lse = flash_ref.flash_ref(tq, tk, tv, chunk=chunk, scale=scale)
    return flash_ops.flash_bwd(tq, tk, tv, out, lse, tdo, scale=scale,
                               chunk=chunk)


def _close(got, want, label):
    want = np.asarray(want, np.float32)
    got = to_numpy(got).astype(np.float32)
    assert got.shape == want.shape, f"{label}: {got.shape} != {want.shape}"
    assert np.isfinite(got).all(), label
    np.testing.assert_allclose(got, want, rtol=F32_TOL,
                               atol=F32_TOL * float(np.abs(want).max()),
                               err_msg=label)


@pytest.mark.parametrize("s", (40, 100))
@pytest.mark.parametrize("g", (1, 2, 4))
@pytest.mark.parametrize("hd", (16, 64))
def test_plain_route_matches_the_reference(hd, g, s):
    """`flash_bwd`'s plain route against `jax.vjp` of the reference's
    `_flash`: widths 16 and 64, GQA groups 1, 2 and 4, S off the
    chunk and off the kernel's 64-row tiles."""
    q, k, v, dout = _inputs(2, s, 2 * g, 2, hd, hd, seed=hd + 10 * g + s)
    want = _j_grads(q, k, v, dout, chunk=32)
    got = _t_grads(q, k, v, dout, chunk=32, scale=1.0 / np.sqrt(hd))
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        _close(a, w, f"hd {hd} g {g} S {s} {name}")


def test_padded_widths_match_the_reference():
    """MLA's widths (q and k 24, v 16 here; 192 and 128 in deepseek) as
    `flash_attention` hands them to the Function on a card: zero-padded
    to the kernel's next width (32) with the unpadded scale. The padded
    columns of dq, dk and dv are zero, the rest the reference's gradients
    at the unpadded widths."""
    q, k, v, dout = _inputs(2, 40, 4, 2, 24, 16, seed=7)
    want = _j_grads(q, k, v, dout, chunk=16)

    def pad(x):
        return np.pad(x, [(0, 0)] * 3 + [(0, 32 - x.shape[-1])])
    got = _t_grads(pad(q), pad(k), pad(v), pad(dout), chunk=16,
                   scale=1.0 / np.sqrt(24))
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        width = w.shape[-1]
        assert float(a[..., width:].abs().max()) == 0.0, name
        _close(a[..., :width], w, f"padded {name}")


def _counting(calls):
    def flash_bwd(q, k, v, out, lse, dout, *, scale, chunk):
        calls.append((tuple(q.shape), scale, chunk))
        return flash_ref.flash_bwd_ref(q, k, v, out, lse, dout, scale=scale,
                                       chunk=chunk)
    return flash_bwd


def test_kernel_route_backward_calls_flash_bwd(monkeypatch):
    """`FlashAttnFn` on the kernel's route (`flash_attention`) looks
    `flash_bwd` up on the module at its backward, once a call, with the
    forward's scale and chunk; the gradients are its plain version's."""
    calls = []
    monkeypatch.setattr(flash_ops, "flash_bwd", _counting(calls))
    q, k, v, dout = _inputs(2, 40, 4, 2, 16, 16, seed=3)
    tq, tk, tv = (to_torch(x).requires_grad_(True) for x in (q, k, v))
    out, _ = flash_ops.flash_attention(tq, tk, tv, chunk=16)
    got = torch.autograd.grad(out, (tq, tk, tv), to_torch(dout))
    assert calls == [((2, 40, 4, 16), pytest.approx(0.25), 16)]
    want = _j_grads(q, k, v, dout, chunk=16)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        _close(a, w, f"Function {name}")


def test_chunks_route_backward_skips_flash_bwd(monkeypatch):
    """The other masks (`flash_attention_chunks`) keep the plain chunked
    backward: `flash_bwd` is never called there."""
    calls = []
    monkeypatch.setattr(flash_ops, "flash_bwd", _counting(calls))
    q, k, v, dout = _inputs(2, 32, 4, 2, 16, 16, seed=4)
    tq, tk, tv = (to_torch(x).requires_grad_(True) for x in (q, k, v))
    pos = torch.arange(32, dtype=torch.int32)
    flash_ops.reset()
    out, _ = flash_ops.flash_attention_chunks(tq, tk, tv, pos, pos, None,
                                              False, 16)
    grads = torch.autograd.grad(out, (tq, tk, tv), to_torch(dout))
    assert calls == []
    assert flash_ops.BACKWARD.calls == 1
    assert all(float(g.abs().max()) > 0 for g in grads)


def test_wrapper_refuses_inputs_that_require_a_gradient(monkeypatch):
    """On the kernel's route (as on a card) the raw wrapper refuses inputs
    that require a gradient while autograd records, before it launches."""
    monkeypatch.setattr(flash_ops, "kernel_route", lambda *a: True)
    q, k, v, dout = (to_torch(x) for x in _inputs(1, 8, 2, 1, 16, 16, 5))
    out, lse = flash_ref.flash_ref(q, k, v, chunk=8)
    before = flash_ops.BWD_LAUNCHER.launches
    with pytest.raises(RuntimeError, match="require a gradient"):
        flash_ops.flash_bwd(q.requires_grad_(True), k, v, out, lse, dout,
                            scale=0.25)
    assert flash_ops.BWD_LAUNCHER.launches == before


@pytest.mark.parametrize("index", (0, 1))
def test_planted_backward_faults_differ_from_the_plain_version(index):
    """Each planted backward fault of `chip_smoke.py`'s phase 12 (delta
    left out of dS; one head of each GQA group dropped from dk and dv),
    run through `flash_bwd`'s plain route, moves the gradients it
    touches by far more than the float32 tolerance."""
    honest = flash_ops.flash_bwd
    name, ctx, must_catch = chip_smoke._flash_bwd_faults()[index]
    assert must_catch
    q, k, v, dout = _inputs(2, 40, 8, 1, 16, 16, seed=6)
    want = _t_grads(q, k, v, dout, chunk=16, scale=0.25)
    with ctx:
        got = _t_grads(q, k, v, dout, chunk=16, scale=0.25)
    moved = [float((a - w).abs().max() / w.abs().max())
             for a, w in zip(got, want)]
    assert max(moved) > 1e-2, (name, moved)
    assert flash_ops.flash_bwd is honest
