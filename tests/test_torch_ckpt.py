"""Port vs reference: checkpoints (`repro_torch/checkpoint`) — the
reference's on-disk format both ways.

A port TrainState and the reference's TrainState of the same model
flatten to the same keys in the same order (`params/...`,
`opt_state/mu/...`, `step`). The reference's `restore` reads a
checkpoint the port wrote, and the port's `restore` reads one the
reference wrote (with its `HAVE_ZSTD` set to False and `zlib` given to
its module inside the test, so it writes zlib as it does without
`zstandard`, which the chip machine lacks); keys, dtypes and
bits must be equal. The port's msgpack subset is held to the `msgpack`
package both ways.
"""
import json
import zlib

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as j_ckpt
from repro.configs import ARCHS as J_ARCHS
from repro.models.model_zoo import build_model as j_build
from repro.train.train_step import make_train_state as j_make_state
from repro_torch.checkpoint import ckpt as t_ckpt
from repro_torch.checkpoint import msgpack as t_msgpack
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.interop import model_params_from_jax
from repro_torch.optim.adamw import make_optimizer, tree_map
from repro_torch.train.train_step import TrainState
from torch_port_util import to_numpy

# (arch, its optimizer): gemma-2b's AdamW, arctic-480b's Adafactor (0-d
# column stats for its 1-d leaves)
MODELS = (("gemma-2b", "adamw"), ("arctic-480b", "adafactor"))


def _states(name, seed=0):
    """The reference's TrainState of `name` reduced (its own optimizer,
    the state's moments filled from a seed) and the port's of the same
    weights and moments."""
    jcfg = J_ARCHS[name].reduced()
    js = j_make_state(j_build(jcfg), jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    opt = jax.tree.map(lambda x: jnp.asarray(
        rng.standard_normal(x.shape).astype(np.float32)) if x.ndim else x,
        js.opt_state)
    js = js._replace(opt_state=opt._replace(step=jnp.int32(3)),
                     step=jnp.int32(3))
    tp = model_params_from_jax(jax.tree.map(np.asarray, js.params),
                               device="cpu")
    tp = tree_map(lambda p: p.requires_grad_(True), tp)
    t_opt = make_optimizer(T_ARCHS[name].optimizer)[0](tp)
    fields = []
    for field in t_opt._fields:
        j_field = getattr(js.opt_state, field)
        if field == "step":
            fields.append(torch.tensor(int(j_field), dtype=torch.int32))
        else:
            fields.append(tree_map(lambda _, x: torch.from_numpy(
                np.array(x)), getattr(t_opt, field), j_field))
    ts = TrainState(params=tp, opt_state=type(t_opt)(*fields),
                    step=torch.tensor(3, dtype=torch.int32))
    return js, ts


def _j_flat(tree):
    return j_ckpt._flatten(tree)[0]


def _bits(x):
    x = np.asarray(x)
    if x.dtype == ml_dtypes.bfloat16:
        return x.view(np.uint16)
    return x


def _np(x):
    return to_numpy(x) if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_same(j_flat: dict, t_flat: dict):
    """Same keys in the same order; each leaf the same dtype, shape and
    bits (either side numpy, JAX or torch)."""
    assert list(j_flat) == list(t_flat)
    for key, want in j_flat.items():
        got, want = _np(t_flat[key]), _np(want)
        assert got.dtype == want.dtype, (key, got.dtype, want.dtype)
        assert got.shape == want.shape, key
        np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=key)


@pytest.mark.parametrize("name,opt", MODELS)
def test_keys_are_the_reference_s(name, opt):
    assert T_ARCHS[name].optimizer == opt
    js, ts = _states(name)
    keys = list(t_ckpt.flatten(ts))
    assert keys == list(_j_flat(js))
    assert "step" in keys and "opt_state/step" in keys
    assert any(k.startswith("params/layers/") for k in keys)
    first = "mu" if opt == "adamw" else "vr"
    assert any(k.startswith(f"opt_state/{first}/") for k in keys)
    _assert_same(_j_flat(js), t_ckpt.flatten(ts))


@pytest.mark.parametrize("name,opt", MODELS)
def test_the_reference_reads_the_port_s_checkpoint(name, opt, tmp_path):
    js, ts = _states(name, seed=1)
    t_ckpt.save(str(tmp_path / "ck"), ts, step=7, extra={"arch": name})
    with open(tmp_path / "ck" / "shard_00000.msgpack.zst", "rb") as f:
        assert f.read(1) == b"\x78"               # zlib
    manifest = j_ckpt.load_manifest(str(tmp_path / "ck"))
    assert manifest == {"step": 7, "num_shards": 1,
                        "keys": sorted(_j_flat(js)),
                        "extra": {"arch": name}}
    target = jax.tree.map(jnp.zeros_like, js)
    restored, step = j_ckpt.restore(str(tmp_path / "ck"), target)
    assert step == 7
    _assert_same(_j_flat(restored), t_ckpt.flatten(ts))


@pytest.mark.parametrize("name,opt", MODELS)
def test_the_port_reads_the_reference_s_checkpoint(name, opt, tmp_path,
                                                   monkeypatch):
    # the reference's zlib branch, as a process without zstandard takes
    # it (its module imports zlib only then)
    monkeypatch.setattr(j_ckpt, "HAVE_ZSTD", False)
    monkeypatch.setattr(j_ckpt, "zlib", zlib, raising=False)
    js, ts = _states(name, seed=2)
    j_ckpt.save(str(tmp_path / "ck"), js, step=5)
    target = jax.tree.map(torch.zeros_like, ts)
    target = target._replace(params=tree_map(
        lambda p: p.requires_grad_(True), target.params))
    restored, step = t_ckpt.restore(str(tmp_path / "ck"), target)
    assert step == 5
    _assert_same(_j_flat(js), t_ckpt.flatten(restored))
    assert type(restored) is TrainState
    assert type(restored.opt_state) is type(ts.opt_state)
    leaves = jax.tree.leaves(restored.params)
    assert all(p.requires_grad and p.is_leaf for p in leaves)


def test_round_trip_and_async_snapshot(tmp_path):
    """A tree of every dtype a state holds round-trips bit for bit; the
    asynchronous save writes the tree as it was when the call returned,
    whatever the caller does to it after."""
    tree = {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "nested": {"b": torch.randn(5).to(torch.bfloat16),
                       "c": [torch.tensor(7, dtype=torch.int32),
                             torch.zeros((2, 0), dtype=torch.uint8)]},
            "step": torch.tensor(7, dtype=torch.int32)}
    t_ckpt.save(str(tmp_path / "ck"), tree, step=7)
    restored, step = t_ckpt.restore(str(tmp_path / "ck"), tree)
    assert step == 7
    _assert_same(t_ckpt.flatten(tree), t_ckpt.flatten(restored))
    assert list(t_ckpt.flatten(tree)) == ["a", "nested/b", "nested/c/[0]",
                                          "nested/c/[1]", "step"]
    before = tree["a"].clone()
    fut = t_ckpt.save_async(str(tmp_path / "ak"), tree, step=1)
    tree["a"].add_(1.0)
    fut.result(timeout=30)
    restored, step = t_ckpt.restore(str(tmp_path / "ak"), tree)
    assert step == 1 and torch.equal(restored["a"], before)


def test_missing_key_and_zstd_shard_are_refused(tmp_path, monkeypatch):
    t_ckpt.save(str(tmp_path / "ck"), {"a": torch.zeros(2)}, step=0)
    with pytest.raises(KeyError, match="missing key 'b'"):
        t_ckpt.restore(str(tmp_path / "ck"), {"a": torch.zeros(2),
                                              "b": torch.zeros(2)})
    monkeypatch.setattr(t_ckpt, "HAVE_ZSTD", False)
    with open(tmp_path / "ck" / "shard_00000.msgpack.zst", "wb") as f:
        f.write(b"\x28\xb5\x2f\xfd" + b"\x00" * 16)
    with pytest.raises(ImportError, match="zstandard"):
        t_ckpt.restore(str(tmp_path / "ck"), {"a": torch.zeros(2)})


def test_manifest_is_json(tmp_path):
    t_ckpt.save(str(tmp_path / "ck"), {"b": torch.zeros(1),
                                       "a": torch.ones(1)}, step=3,
                extra={"k": 1})
    with open(tmp_path / "ck" / "manifest.json") as f:
        assert json.load(f) == {"step": 3, "num_shards": 1,
                                "keys": ["a", "b"], "extra": {"k": 1}}
    assert t_ckpt.load_manifest(str(tmp_path / "ck"))["step"] == 3


MSGPACK_OBJECTS = (
    {"a": {"dtype": "float32", "shape": [3, 4, 5_000_000],
           "data": b"x" * 300},
     "b" * 40: [1, -1, -33, 127, 128, 255, 256, 70_000, 2 ** 40, -2 ** 40,
                []],
     "c": {}, "x" * 300: b"", "t": [True, False, None]},
    {str(i): i for i in range(70_000)},
    [0] * 20, "y" * 70_000, b"z" * 70_000, b"w" * 300)


@pytest.mark.parametrize("obj", MSGPACK_OBJECTS,
                         ids=lambda o: type(o).__name__ + str(len(o)))
def test_msgpack_subset_matches_the_package(obj):
    msgpack = pytest.importorskip("msgpack")
    assert msgpack.unpackb(t_msgpack.packb(obj), raw=False) == obj
    assert t_msgpack.unpackb(msgpack.packb(obj, use_bin_type=True)) == obj


def test_msgpack_refuses_what_a_checkpoint_does_not_hold():
    with pytest.raises(TypeError):
        t_msgpack.packb(1.5)
    with pytest.raises(ValueError, match="outside the subset"):
        t_msgpack.unpackb(b"\xcb" + b"\x00" * 8)         # a float64
    with pytest.raises(ValueError, match="trailing"):
        t_msgpack.unpackb(b"\x01\x02")
    assert zlib.decompress(zlib.compress(t_msgpack.packb({"a": 1}))) == \
        t_msgpack.packb({"a": 1})
