"""The port's partition rules against the reference package's
(`repro.distributed.sharding` over a fake 16x16 or 2x16x16 JAX mesh):
`fit_spec`, `param_specs` in train and decode mode for every arch (the
reference's specs over `jax.eval_shape(bundle.init)`, the port's over
its meta parameters), `cache_specs` for each cache kind,
`train_batch_specs`; `local_slices` against
`NamedSharding.devices_indices_map` on 8 host devices; the activation
constraints as no-ops without a mesh; the `core.ssd.workloads` shim."""
from __future__ import annotations

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec

import repro.core.ssd.workloads as jworkloads
from repro.configs import ARCHS as J_ARCHS
from repro.distributed import sharding as jsh
from repro.launch import specs as jspecs
from repro.models.model_zoo import build_model as j_build_model
from repro_torch.configs import ARCHS, SHAPES_BY_NAME
from repro_torch.core.ssd import workloads as tworkloads
from repro_torch.distributed import constraints, sharding as tsh
from repro_torch.launch import specs as tspecs
from repro_torch.launch.mesh import (make_debug_mesh, make_production_mesh)
from repro_torch.models.model_zoo import build_model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = ("single", "multi")


def _jax_mesh(which: str) -> Mesh:
    """An abstract JAX mesh for spec fitting (no devices needed), as
    tests/test_launch.py builds it."""
    if which == "single":
        devs = np.array(jax.devices() * 256)[:256].reshape(16, 16)
        return Mesh(devs, ("data", "model"))
    devs = np.array(jax.devices() * 512)[:512].reshape(2, 16, 16)
    return Mesh(devs, ("pod", "data", "model"))


def _port_mesh(which: str):
    return make_production_mesh(multi_pod=(which == "multi"))


def _jflat(tree) -> dict:
    """{path tuple: spec as a tuple} of a reference spec tree."""
    leaves, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))
    return {tuple(str(getattr(k, "key", getattr(k, "name", k)))
                  for k in path): tuple(spec) for path, spec in leaves}


def _tflat(tree) -> dict:
    out = {}
    tsh.tree_map_path(lambda p, s: out.__setitem__(tuple(map(str, p)),
                                                   tuple(s)), tree)
    return out


@pytest.mark.parametrize("which,spec_dims,shape", [
    (which, dims, shape) for which in MESHES for dims, shape in [
        (("data", "model"), (32, 64)),
        ((None, "data", "model", None), (60, 7168, 56, 128)),
        ((("data", "model"), None), (256, 128)),
        ((("data", "model"), None), (100, 128)),
        ((("data",), None), (48, 3)),
        (("model", None), (1, 5))]] + [
    ("multi", (("pod", "data"), None, "model"), (64, 3, 48)),
    ("multi", (("pod", "data"), None, "model"), (16, 3, 8))])
def test_fit_spec_matches_the_reference(which, spec_dims, shape):
    want = jsh.fit_spec(_jax_mesh(which), spec_dims, shape)
    got = tsh.fit_spec(_port_mesh(which), spec_dims, shape)
    assert tuple(got) == tuple(want)
    assert repr(got) == repr(want)


@pytest.fixture(scope="module")
def param_trees():
    """{arch: (reference param shapes, port meta params)}."""
    out = {}
    for name in ARCHS:
        jshapes = jax.eval_shape(j_build_model(J_ARCHS[name]).init,
                                 jax.random.PRNGKey(0))
        out[name] = (jshapes, tspecs.params_specs(
            build_model(ARCHS[name], device="meta")))
    return out


@pytest.mark.parametrize("mode", ["train", "decode"])
@pytest.mark.parametrize("which", MESHES)
def test_param_specs_match_the_reference(param_trees, which, mode):
    """Every arch, leaf by leaf: the same paths and the same specs."""
    for name, (jshapes, tparams) in param_trees.items():
        want = _jflat(jsh.param_specs(_jax_mesh(which), jshapes, mode=mode))
        got = _tflat(tsh.param_specs(_port_mesh(which), tparams, mode=mode))
        assert got.keys() == want.keys(), name
        bad = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
        assert not bad, (name, bad)


@pytest.mark.parametrize("arch", ["gemma-2b", "deepseek-v2-lite-16b",
                                  "whisper-tiny", "mamba2-370m",
                                  "zamba2-1.2b"])
@pytest.mark.parametrize("which", MESHES)
def test_cache_specs_match_the_reference(arch, which):
    """The gqa, mla, encdec_self, ssm and hybrid cache kinds at the
    decode_32k shape."""
    shape = SHAPES_BY_NAME["decode_32k"]
    jcache, _ = jspecs.decode_cache_specs(j_build_model(J_ARCHS[arch]),
                                          shape.global_batch, shape.seq_len)
    tcache, _ = tspecs.decode_cache_specs(
        build_model(ARCHS[arch], device="meta"), shape.global_batch,
        shape.seq_len)
    want = _jflat(jsh.cache_specs(_jax_mesh(which), jcache))
    got = _tflat(tsh.cache_specs(_port_mesh(which), tcache))
    assert got == want


@pytest.mark.parametrize("arch", ["gemma-2b", "llava-next-34b",
                                  "whisper-tiny"])
@pytest.mark.parametrize("batch", [256, 32, 1])
@pytest.mark.parametrize("which", MESHES)
def test_train_batch_specs_match_the_reference(arch, batch, which):
    jbatch = jspecs.batch_specs(J_ARCHS[arch], batch, 4096)
    tbatch = tspecs.batch_specs(ARCHS[arch], batch, 4096)
    want = _jflat(jsh.train_batch_specs(_jax_mesh(which), jbatch))
    got = _tflat(tsh.train_batch_specs(_port_mesh(which), tbatch))
    assert got == want
    assert tuple(tsh.logits_spec(_port_mesh(which))) == tuple(
        jsh.logits_spec(_jax_mesh(which)))


_SLICE_CASES = [
    (("data", "model"), (8, 6)),
    (("model", None, "data"), (4, 3, 8)),
    ((("data", "model"), None), (16, 5)),
    ((None, ("data", "model")), (3, 8)),
    (("data",), (12,)),
    ((None, None), (5, 7)),
]


def test_local_slices_match_named_sharding():
    """On a 4x2 mesh of 8 host devices (a subprocess: the device count is
    fixed when JAX starts), every device's index slices under each spec
    equal `NamedSharding(mesh, spec).devices_indices_map(shape)`."""
    code = f"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json, jax, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
mesh = jax.make_mesh((4, 2), ("data", "model"))
out = []
for spec, shape in {_SLICE_CASES!r}:
    m = NamedSharding(mesh, P(*spec)).devices_indices_map(shape)
    cells = []
    for d, idx in m.items():
        (i, j), = np.argwhere(mesh.devices == d)
        cells.append([[int(i), int(j)],
                      [[s.start or 0, n if s.stop is None else s.stop]
                       for s, n in zip(idx, shape)]])
    out.append(cells)
print("SLICES", json.dumps(out))
"""
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
           "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=300)
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("SLICES")]
    assert line, proc.stderr[-2000:]
    want = json.loads(line[0].split(" ", 1)[1])
    mesh = make_debug_mesh(8, 2)
    assert mesh.shape == {"data": 4, "model": 2}
    for (spec, shape), cells in zip(_SLICE_CASES, want):
        assert len(cells) == 8
        for (i, j), bounds in cells:
            got = tsh.local_slices(mesh, tsh.P(*spec), shape,
                                   {"data": i, "model": j})
            assert [[s.start, s.stop] for s in got] == bounds, (spec, i, j)
            assert mesh.coords(i * 2 + j) == {"data": i, "model": j}


def test_local_nbytes_and_placements():
    from torch.distributed.tensor import Replicate, Shard
    mesh = make_production_mesh(multi_pod=True)
    spec = tsh.P(("pod", "data"), None, "model")
    assert tsh.local_nbytes(mesh, spec, (64, 3, 48), 2) == 64 * 3 * 48 * 2 \
        // (2 * 16 * 16)
    assert tsh.placements(mesh, spec) == [Shard(0), Shard(0), Shard(2)]
    assert tsh.placements(mesh, tsh.P(None, None)) == [Replicate()] * 3
    with pytest.raises(ValueError, match="axis order"):
        tsh.placements(mesh, tsh.P(("data", "pod"),))


def test_constraints_are_no_ops_without_a_mesh():
    """No mesh: every constraint returns its input itself; a plain tensor
    under a registered mesh object stays itself too."""
    x = torch.randn(2, 3, 4)
    assert constraints.constrain_bsd(x) is x
    assert constraints.constrain(x, "batch", None, "model") is x
    assert constraints.constrain(None, "batch") is None
    with constraints.activation_mesh(object()):
        assert constraints._MESH is not None
        assert constraints.constrain_bsd(x) is x
    assert constraints._MESH is None


def test_workloads_shim_matches_the_reference():
    assert tworkloads.__all__ == jworkloads.__all__
    assert tworkloads.PAD_OPS == jworkloads.PAD_OPS
    assert tworkloads.TRACE_NAMES == jworkloads.TRACE_NAMES
    for name in jworkloads.TRACE_NAMES:
        assert (tworkloads.TRACES[name].__dict__
                == jworkloads.TRACES[name].__dict__)
    want = jworkloads.make_trace("hm_0", 1 << 16, mode="daily")
    got = tworkloads.make_trace("hm_0", 1 << 16, mode="daily")
    for key in ("arrival_ms", "lba", "is_write"):
        np.testing.assert_array_equal(np.asarray(got[key]),
                                      np.asarray(want[key]))
