"""Content-addressed compiled-trace cache.

Port of the reference package's `workloads/cache.py`: the same keying
(recipe JSON, format version, the generator `VERSION` and the file
digest inside the recipe), the same best-effort contract, its own
directory and environment variables (it never reads or writes the
reference's store), and no telemetry events. Its entries are written
uncompressed (`np.savez`): compressing an entry costs the host more
time than building the trace, which a cold sweep would pay; the entries
are some ten times larger instead.

Building a trace (python-loop synthesis + page expansion + padding) costs
orders of magnitude more than loading its op tensors, and the sweep layers
rebuild the same (trace, seed, mode, repeat) recipe every run. This cache
memoizes *compiled* op dicts twice over:

  * in-process — one build per recipe per process (replaces the ad-hoc
    dict that lived in `sweep.runner`);
  * on disk — one `.npz` per recipe under `$REPRO_TORCH_TRACE_CACHE_DIR`
    (default `~/.cache/repro_torch/traces`), shared across processes and runs.

Entries are content-addressed: the key is a SHA-256 over the canonical
JSON of the build recipe (spec, seed, mode, repeat, logical window,
capacity) plus a format version — and, for file-backed traces, a digest of
the file *contents*, so editing a trace file invalidates its entries
without any mtime heuristics. Cache misses rebuild; disk failures degrade
to building (a cache must never be load-bearing for correctness).

The on-disk store is size-capped with LRU eviction: when the directory
grows past `$REPRO_TORCH_TRACE_CACHE_MAX_MB` (or the `max_mb` constructor
argument; unset/<=0 means unlimited), the least-recently-USED entries are
deleted first — a disk hit refreshes the entry's mtime, so recency tracks
use, not creation. Eviction is best-effort like every other disk path
here, and guarded against concurrent sweeps sharing the store: evictors
serialize on a non-blocking `flock` over `.evict.lock` (a busy lock means
another process is already evicting — skip), and each candidate is
re-`stat`ed immediately before deletion so an entry a concurrent reader
just touched (refreshed mtime) is no longer LRU and survives. A reader
that still loses the race to a deletion simply misses and rebuilds.

Hit/miss/eviction counts are exported via `stats()` and logged into
`BENCH_*` run metadata by the sweep CLI, so trace-build amortization is
visible in the perf trajectory.
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import os
import tempfile
import time
from typing import Callable, Dict, Mapping, Optional

import numpy as np

try:                                    # POSIX; eviction runs unlocked on
    import fcntl                        # platforms without flock
except ImportError:                     # pragma: no cover
    fcntl = None

__all__ = ["TraceCache", "default_cache_dir", "default_max_mb",
           "file_digest", "FORMAT_VERSION"]

FORMAT_VERSION = 1
_TMP_MAX_AGE_S = 3600      # reap orphaned .npz.tmp spills older than this

_ARRAY_KEYS = ("arrival_ms", "lba", "is_write", "req_id")
_SCALAR_KEYS = ("n_ops", "n_reqs")


def default_cache_dir() -> str:
    return (os.environ.get("REPRO_TORCH_TRACE_CACHE_DIR")
            or os.path.join(os.path.expanduser("~"), ".cache",
                            "repro_torch", "traces"))


def default_max_mb() -> Optional[float]:
    """Size cap from `$REPRO_TORCH_TRACE_CACHE_MAX_MB`; None (unset, empty or
    <= 0) means unlimited."""
    raw = os.environ.get("REPRO_TORCH_TRACE_CACHE_MAX_MB", "").strip()
    if not raw:
        return None
    try:
        val = float(raw)
    except ValueError:
        return None
    return val if val > 0 else None


_DIGEST_MEMO: Dict[tuple, str] = {}


def file_digest(path: str) -> str:
    """Streaming SHA-256 of a file's contents (content addressing for
    file-backed trace recipes).

    Memoized per (path, mtime, size) so a sweep with many cells over one
    large trace file hashes it once, while an edited file (new mtime/size)
    still re-hashes."""
    st = os.stat(path)
    memo_key = (os.path.abspath(path), st.st_mtime_ns, st.st_size)
    if memo_key not in _DIGEST_MEMO:
        h = hashlib.sha256()
        with open(path, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                h.update(chunk)
        _DIGEST_MEMO[memo_key] = h.hexdigest()
    return _DIGEST_MEMO[memo_key]


class TraceCache:
    """Two-level (memory + disk) memo for compiled trace op dicts."""

    def __init__(self, root: Optional[str] = None, *,
                 use_disk: bool = True,
                 max_mb: Optional[float] = None):
        self.root = root or default_cache_dir()
        self.use_disk = use_disk
        self.max_mb = default_max_mb() if max_mb is None else (
            max_mb if max_mb > 0 else None)
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self._mem: Dict[str, Dict] = {}
        self._comp: Dict[str, object] = {}
        self._tmp_reaped = False    # uncapped: one orphan sweep per process

    @staticmethod
    def key(recipe: Mapping) -> str:
        canon = json.dumps({**recipe, "__format__": FORMAT_VERSION},
                           sort_keys=True, separators=(",", ":"),
                           default=str)
        return hashlib.sha256(canon.encode()).hexdigest()[:32]

    def _path(self, key: str) -> str:
        return os.path.join(self.root, f"trace_{key}.npz")

    def _load_disk(self, key: str) -> Optional[Dict]:
        path = self._path(key)
        try:
            with np.load(path) as z:
                ops = {**{k: z[k] for k in _ARRAY_KEYS},
                       **{k: int(z[k]) for k in _SCALAR_KEYS}}
        except (OSError, KeyError, ValueError):
            return None
        try:
            os.utime(path)          # LRU recency: a hit refreshes mtime
        except OSError:
            pass
        return ops

    def _store_disk(self, key: str, ops: Dict) -> None:
        try:
            os.makedirs(self.root, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=self.root, suffix=".npz.tmp")
            with os.fdopen(fd, "wb") as f:
                np.savez(
                    f, **{k: ops[k] for k in _ARRAY_KEYS},
                    **{k: np.int64(ops[k]) for k in _SCALAR_KEYS})
            os.replace(tmp, self._path(key))   # atomic: no torn entries
        except OSError:
            return                              # disk cache is best-effort
        self._evict(keep=self._path(key))

    @contextlib.contextmanager
    def _evict_lock(self):
        """Non-blocking exclusive lock serializing evictors across
        processes (yields whether the lock was won). Losing the race
        means another sweep is already evicting this store — skipping is
        both safe and cheaper. No-ops (always "won") without flock."""
        if fcntl is None:
            yield True
            return
        fd = None
        try:
            fd = os.open(os.path.join(self.root, ".evict.lock"),
                         os.O_CREAT | os.O_RDWR, 0o644)
            fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            if fd is not None:
                os.close(fd)
            yield False
            return
        try:
            yield True
        finally:
            try:
                fcntl.flock(fd, fcntl.LOCK_UN)
            finally:
                os.close(fd)

    def _evict(self, keep: Optional[str] = None) -> None:
        """Reap abandoned `.npz.tmp` spills (interrupted writes), then —
        when a size cap is set — delete least-recently-used entries until
        the store fits `max_mb`. Never evicts `keep` (the entry just
        written). All failures are swallowed — concurrent processes may
        race on the same files, and losing the race only means the space
        is freed.

        Concurrency (module docstring): evictors hold the `.evict.lock`
        flock, and every candidate is re-stat'ed right before deletion —
        an entry whose mtime moved since the scan was just USED by a
        concurrent sweep, is no longer least-recently-used, and must
        survive.

        Without a size cap the directory scan exists only for orphan
        reaping, so it runs once per instance instead of on every store
        (a capped store needs the scan anyway, for budget accounting)."""
        if not self.max_mb and self._tmp_reaped:
            return
        with self._evict_lock() as won:
            if not won:
                return
            self._evict_locked(keep)

    def _evict_locked(self, keep: Optional[str]) -> None:
        try:
            entries = []
            with os.scandir(self.root) as it:
                for de in it:
                    try:
                        st = de.stat()
                    except OSError:
                        continue
                    if de.name.endswith(".npz.tmp"):
                        # orphan from an interrupted write: invisible to
                        # loads, so reap it once it is clearly abandoned
                        # (another process may still be writing a fresh one)
                        if time.time() - st.st_mtime > _TMP_MAX_AGE_S:
                            try:
                                os.remove(de.path)
                            except OSError:
                                pass
                        continue
                    if not (de.name.startswith("trace_")
                            and de.name.endswith(".npz")):
                        continue
                    entries.append((st.st_mtime_ns, st.st_size, de.path))
        except OSError:
            return
        self._tmp_reaped = True
        if not self.max_mb:
            return
        total = sum(size for _, size, _ in entries)
        budget = self.max_mb * 1024 * 1024
        for mtime, size, path in sorted(entries):
            if total <= budget:
                break
            if keep is not None and \
                    os.path.abspath(path) == os.path.abspath(keep):
                continue
            try:
                # freshness re-check: an mtime moved since the scan means
                # a concurrent sweep just hit this entry — it is no longer
                # LRU, so it survives this pass
                if os.stat(path).st_mtime_ns != mtime:
                    continue
                os.remove(path)
            except OSError:
                continue
            total -= size
            self.evictions += 1

    def get_or_build(self, recipe: Mapping,
                     builder: Callable[[], Dict]) -> Dict:
        """Memoized compiled op dict for `recipe`; `builder` runs on miss."""
        key = self.key(recipe)
        if key in self._mem:
            self.hits += 1
            return self._mem[key]
        ops = self._load_disk(key) if self.use_disk else None
        if ops is not None:
            self.hits += 1
        else:
            self.misses += 1
            ops = builder()
            if self.use_disk:
                self._store_disk(key, ops)
        self._mem[key] = ops
        return ops

    def compressed(self, ops: Mapping, *, key: Optional[str] = None):
        """In-process memo of the segment-compressed form of a compiled
        trace (`workloads.compress.compress_ops` — DESIGN.md §12).

        Compression is policy-independent, so one compressed bundle
        serves every (composition, mode) a sweep runs over the trace.
        Keyed by the trace's recipe key when the caller knows it (the
        compiled tensors are immutable once built); falls back to the op
        dict's object identity, which is exactly the lifetime of the
        in-memory `get_or_build` entry it came from. Memory-only: the
        transform is a few ms per trace, not worth disk format churn."""
        from repro_torch.workloads.compress import compress_ops
        k = key if key is not None else f"id:{id(ops['lba'])}"
        if k not in self._comp:
            self._comp[k] = compress_ops(ops)
        return self._comp[k]

    def stats(self) -> Dict:
        return {"hits": self.hits, "misses": self.misses,
                "evictions": self.evictions,
                "compressed": len(self._comp),
                "max_mb": self.max_mb,
                "dir": self.root if self.use_disk else None}
