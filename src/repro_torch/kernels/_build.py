"""Build, load and launch of the port's CUDA kernels: `nvcc` into a
shared library with a plain C interface, loaded with ctypes.

Each kernel package holds one `Library`: its source under `csrc/`, its
flags, and a `bind` function that sets the C functions' argument types.
The library is built at first use into `build/kernels/` at the root of
the checkout; its file name carries a hash of the source and the flags,
so an edited source or flag set is rebuilt. Nothing is built when a
module is imported: this package imports on machines without `nvcc`.

`Launcher` is what every wrapper shares around its C call: the launch
count, the optional CUDA events, the stream, and the raise on a refused
launch. `check` is the wrappers' argument check; `kernel_route` their
device check and `refuse_grad` their refusal to run under autograd.
"""
from __future__ import annotations

import contextlib
import contextvars
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Sequence

import torch

__all__ = ["Library", "Launcher", "Span", "check", "kernel_route",
           "shapes_only", "refuse_grad",
           "BUILD_DIR", "BASE_FLAGS", "LINK_FLAGS", "build_all", "nvcc"]

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
BUILD_DIR = os.path.join(_ROOT, "build", "kernels")
# sm_90a keeps wgmma and setmaxnreg available; -Xptxas -v reports each
# kernel's registers, shared memory and spills into `build_log`
BASE_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3")
LINK_FLAGS = ("-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    """Path of the CUDA toolkit's nvcc (PATH, then CUDA_HOME)."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the port's kernels are built with "
                       "the CUDA toolkit's nvcc (PATH or CUDA_HOME)")


class Library:
    """One kernel source built into one shared library."""

    def __init__(self, name: str, source: str, flags: Sequence[str],
                 bind: Callable[[ctypes.CDLL], None]):
        self.name = name
        self.source = source
        self.flags = tuple(flags)
        self._bind = bind
        self._lib = None
        self._lock = threading.Lock()
        self.build_log = ""      # nvcc's output of the build this process did
        self.build_s = 0.0       # seconds that build took (0 if cached)

    def path(self) -> str:
        with open(self.source, "rb") as f:
            digest = hashlib.sha256(f.read() + " ".join(self.flags).encode())
        return os.path.join(BUILD_DIR,
                            f"lib{self.name}-{digest.hexdigest()[:16]}.so")

    def build(self) -> str:
        """Compile the source unless this source and flag set were built
        already; returns the library's path."""
        with self._lock:
            lib_path = self.path()
            if os.path.exists(lib_path):
                return lib_path
            os.makedirs(BUILD_DIR, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so")
            os.close(fd)
            t0 = time.perf_counter()
            proc = subprocess.run([nvcc(), *self.flags, "-o", tmp,
                                   self.source],
                                  capture_output=True, text=True)
            self.build_s = time.perf_counter() - t0
            self.build_log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                os.remove(tmp)
                raise RuntimeError(f"nvcc failed building {self.source}:\n"
                                   f"{self.build_log}")
            os.replace(tmp, lib_path)
            return lib_path

    def load(self) -> ctypes.CDLL:
        if self._lib is None:
            lib = ctypes.CDLL(self.build())
            self._bind(lib)
            self._lib = lib
        return self._lib

    def sass_count(self, opcode: str) -> int:
        """Instructions of `opcode` (e.g. "HGMMA") in the built library's
        machine code, as the toolkit's cuobjdump disassembles it."""
        tool = os.path.join(os.path.dirname(nvcc()), "cuobjdump")
        sass = subprocess.run([tool, "-sass", self.build()],
                              capture_output=True, text=True,
                              check=True).stdout
        return len(re.findall(rf"\b{re.escape(opcode)}\b", sass))

    def ptxas(self) -> dict:
        """Registers per kernel and the largest spill store that ptxas
        reported in this process's build (empty if it was cached)."""
        log = self.build_log.splitlines()
        regs = sorted({int(ln.split("Used ")[1].split()[0])
                       for ln in log if "registers" in ln and "Used " in ln})
        spills = max((int(ln.split("bytes spill stores")[0].split(",")[-1])
                      for ln in log if "bytes spill stores" in ln),
                     default=0)
        return {"ptxas_registers": regs, "ptxas_max_spill_store_bytes": spills}


def build_all(libraries: Sequence[Library]) -> list:
    """Build several libraries at once, one nvcc each; returns their
    paths in order. The first failure is raised."""
    with ThreadPoolExecutor(max_workers=max(1, len(libraries))) as pool:
        return list(pool.map(lambda lib: lib.build(), libraries))


class Launcher:
    """Launch count and CUDA-event timing of one kernel's wrapper.

    `launches` counts the launches since the last `reset()`: the wrapper
    calls `launch` only where it launches the kernel, never for the plain
    version or an argument it refuses. With `record` set, each launch is
    bracketed by CUDA events on its stream (`events`, `ms()`)."""

    def __init__(self, library: Library, kernel: str):
        self.library = library
        self.kernel = kernel
        self.launches = 0
        self.record = False
        self.events: list = []

    def reset(self) -> None:
        self.launches = 0
        self.events.clear()

    def launch(self, fn_name: str, args: Sequence, device) -> None:
        fn = getattr(self.library.load(), fn_name)
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device)
            if self.record:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record(stream)
            rc = fn(*args, stream.cuda_stream)
            if self.record:
                end.record(stream)
        if rc != 0:
            raise RuntimeError(
                f"{self.kernel}: launch failed with code {rc} (negative: "
                "arguments refused by the C interface; positive: "
                "cudaGetLastError)")
        self.launches += 1
        if self.record:
            self.events.append((start, end))

    def ms(self) -> list:
        """Milliseconds of each recorded launch (synchronises)."""
        torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in self.events]


class Span:
    """Calls and CUDA-event times of a plain-PyTorch stage that sits
    beside a kernel on its path (the flash backward beside `flash_fwd`).

    `calls` counts each `with span(device):` since the last `reset()`;
    with `record` set and a CUDA device, each call is bracketed by CUDA
    events on the current stream (`events`, `ms()`)."""

    def __init__(self, name: str):
        self.name = name
        self.calls = 0
        self.record = False
        self.events: list = []

    def reset(self) -> None:
        self.calls = 0
        self.events.clear()

    @contextlib.contextmanager
    def __call__(self, device):
        timed = self.record and device.type == "cuda"
        if timed:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(torch.cuda.current_stream(device))
        yield
        if timed:
            end.record(torch.cuda.current_stream(device))
            self.events.append((start, end))
        self.calls += 1

    def ms(self) -> list:
        """Milliseconds of each recorded call (synchronises)."""
        torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in self.events]


def check(kernel: str, name: str, t, dtypes, shape, device) -> None:
    """Raise unless `t` is a contiguous tensor on `device` with one of
    `dtypes` and the given shape (None in `shape` matches any size)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{kernel}: {name} must be a tensor")
    if t.device != device:
        raise ValueError(f"{kernel}: {name} is on {t.device}, expected "
                         f"{device}")
    dtypes = dtypes if isinstance(dtypes, tuple) else (dtypes,)
    if t.dtype not in dtypes:
        raise TypeError(f"{kernel}: {name} has dtype {t.dtype}, the kernel "
                        f"takes {' or '.join(map(str, dtypes))}")
    if len(t.shape) != len(shape) or any(
            w is not None and g != w for g, w in zip(t.shape, shape)):
        raise ValueError(f"{kernel}: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be contiguous")


_SHAPES_ONLY = contextvars.ContextVar("shapes_only", default=False)


@contextlib.contextmanager
def shapes_only():
    """Within it, a wrapper given meta tensors runs its plain version on
    shapes alone (the dry run's FLOP and byte accounting,
    `launch.cost_analysis`); outside it a meta tensor is refused."""
    token = _SHAPES_ONLY.set(True)
    try:
        yield
    finally:
        _SHAPES_ONLY.reset(token)


def kernel_route(kernel: str, t) -> bool:
    """The wrappers' device check: True for a tensor on a CUDA device (the
    kernel runs), False for one on the CPU (the plain version runs), and
    for one on the meta device inside `shapes_only()`; any other device
    is refused."""
    if t.device.type == "cpu" or (t.device.type == "meta"
                                  and _SHAPES_ONLY.get()):
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{kernel}: no kernel for device {t.device}")
    return True


def _tensors(x):
    """The tensors in x: a tensor, or tuples, lists and dicts of them."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from _tensors(v)


def refuse_grad(kernel: str, *inputs) -> None:
    """Raise when autograd is recording and an input requires a gradient
    (`inputs`: tensors, or tuples, lists and dicts of them).

    A kernel writes its outputs through a raw pointer, so they carry no
    autograd graph: called on such inputs it would cut every gradient
    upstream of it without a word. A differentiable path calls the kernel
    inside its `torch.autograd.Function`, whose forward runs with
    recording off, so this never fires there."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in _tensors(inputs)):
        raise RuntimeError(
            f"{kernel}: called on inputs that require a gradient while "
            "autograd is recording; the kernel's outputs carry no graph, "
            "so the gradient would stop here. Call it through its "
            "autograd Function, or under torch.no_grad()")
