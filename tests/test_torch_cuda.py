"""The `ssd_step` CUDA kernel against its plain version, on the card.

A CUDA kernel has no CPU mode, so every test here needs an NVIDIA GPU
and `nvcc`, and skips elsewhere. On a machine with a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

(`python3 chip_smoke.py` runs the same comparison at the paper's trace
lengths and then the whole paper grid.)
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.ssd_paper import PAPER_SSD
from repro_torch.core.ssd.policies.spec import PolicySpec
from repro_torch.core.ssd.policies.state import CellParams, init_state
from repro_torch.core.ssd.sim import default_params
from repro_torch.kernels.ssd_step import ops as ssd_step
from repro_torch.workloads import build_ops, compress_ops, truncate_trace

pytestmark = pytest.mark.cuda

CFG = PAPER_SSD.scaled(128)
N_LOGICAL = 1 << 16
OPS, PAD = 512, 1024


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def streams():
    """Two cells (hm_0, proj_0): the per-op form and the K = 32 form."""
    traces = []
    for name in ("hm_0", "proj_0"):
        ops = truncate_trace(build_ops(name, N_LOGICAL,
                                       capacity_pages=CFG.total_pages), OPS)
        traces.append({
            "arrival_ms": np.concatenate(
                [ops["arrival_ms"],
                 np.full(PAD, ops["arrival_ms"][-1], np.float32)]),
            "lba": np.concatenate([ops["lba"], np.zeros(PAD, np.int32)]),
            "is_write": np.concatenate(
                [ops["is_write"], np.full(PAD, -1, np.int8)])})
    per_op = {k: np.stack([t[k][:OPS] for t in traces]).astype(
        np.float32 if k == "arrival_ms" else np.int32).reshape(2, OPS, 1)
        for k in traces[0]}
    plans = [compress_ops(t, quantum=256) for t in traces]
    seg = {k: np.stack([p.segs[k] for p in plans]) for k in plans[0].segs}
    pad_t = np.float32([t["arrival_ms"][OPS] for t in traces])
    return {"K=1": per_op, "K=32": seg}, pad_t


def _run(policy, mode, arrays, pad_t, device, packed):
    p = default_params(CFG, policy, 0.05, device="cpu")
    return ssd_step.run_stream(
        CFG, policy, {k: torch.from_numpy(v).to(device)
                      for k, v in arrays.items()},
        init_state(CFG, N_LOGICAL, packed=packed, n_cells=2, device=device),
        closed_loop=(mode == "bursty"),
        params=CellParams(*(torch.stack([x, x]).to(device) for x in p)),
        n_pad=PAD, pad_t=torch.from_numpy(pad_t).to(device))


@pytest.mark.parametrize("form", ("K=1", "K=32"))
@pytest.mark.parametrize("mode", ("daily", "bursty"))
@pytest.mark.parametrize("policy", (
    "baseline", "ips", "ips_agc", "coop", "dyn_slc", "ips_lazy",
    # the two valid compositions no name registers
    PolicySpec("static", "idle_gap", "migrate", "greedy"),
    PolicySpec("adaptive", "idle_gap", "migrate", "greedy")),
    ids=lambda p: getattr(p, "composition", p))
def test_kernel_equals_plain_version(cuda, streams, policy, mode, form):
    arrays, pad_t = streams
    packed = form == "K=1"
    before = ssd_step.launches
    lat_k, st_k = _run(policy, mode, arrays[form], pad_t, cuda, packed)
    torch.cuda.synchronize()
    assert ssd_step.launches == before + 1
    lat_p, st_p = _run(policy, mode, arrays[form], pad_t,
                       torch.device("cpu"), packed)
    assert torch.equal(lat_k.cpu(), lat_p)
    for field in st_p._fields:
        got, want = getattr(st_k, field).cpu(), getattr(st_p, field)
        assert got.dtype == want.dtype and torch.equal(got, want), field


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda, streams):
    arrays, pad_t = streams
    before = ssd_step.launches
    bad = dict(arrays["K=1"], lba=arrays["K=1"]["lba"].astype(np.int64))
    with pytest.raises(TypeError, match="lba"):
        _run("ips", "daily", bad, pad_t, cuda, False)
    no_plan = {k: v for k, v in arrays["K=32"].items()
               if k not in ("src", "scat_lba")}
    with pytest.raises(ValueError, match="hazard plan"):
        _run("ips", "daily", no_plan, pad_t, cuda, False)
    wide = {k: np.concatenate([v, v], axis=2) for k, v in
            arrays["K=32"].items()}
    with pytest.raises(ValueError, match="lanes"):
        _run("ips", "daily", wide, pad_t, cuda, False)
    assert ssd_step.launches == before
