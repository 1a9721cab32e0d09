"""On-disk trace parsers: MSR Cambridge CSV, generic CSV, fio iolog,
blktrace text.

Port of the reference package's `workloads/parsers.py`: a numpy copy
(the reference's telemetry span around `load_trace` is left out; the
port has no span layer yet).

`load_trace(path, mode=..., max_ops=...)` is the kv-emulator-style entry
point (ROADMAP "trace realism" item): parse a real trace file into the
Trace IR, page-granular and clipped to the simulator's logical window, so
real traces flow through the exact same `stack_traces` / fleet path as the
synthetic MSR set.

Formats (auto-sniffed from the first data line, or forced via `fmt=`):

  * msr     — MSR Cambridge SNIA CSV:
              `Timestamp,Hostname,DiskNumber,Type,Offset,Size,ResponseTime`
              (timestamp in Windows 100 ns ticks, offset/size in bytes).
  * generic — CSV with a header naming any of
              time_ms|arrival_ms|timestamp, lba|offset|offset_bytes,
              pages|size|size_bytes, op|type|rw|is_write; or headerless
              4-column `time_ms,lba,pages,R|W`.
  * fio     — fio iolog v2/v3 lines: `<file> <read|write> <offset> <len>`
              (v3 prefixes a timestamp-ms column).
  * blktrace — `blkparse` text output:
              `maj,min cpu seq timestamp pid ACTION RWBS sector + nsect
              [process]` (timestamp in seconds, sectors of 512 bytes).
              Each I/O appears once per lifecycle action; to avoid
              double counting, only one action class is kept — queue
              (`Q`) events when present, else dispatch (`D`), else
              completion (`C`).

Compression follows the optional-dependency pattern of `checkpoint/ckpt.py`:
`.zst` uses zstandard when installed (informative ImportError otherwise),
`.gz` always works via the stdlib, plain files need nothing.
"""
from __future__ import annotations

import io
import os
import re
from typing import Dict, Iterable, Optional

import numpy as np

from repro_torch.workloads import ir

try:
    import zstandard as zstd
    HAVE_ZSTD = True
except ImportError:          # zstandard is optional in this container:
    zstd = None              # .gz / plain files still work; only .zst
    HAVE_ZSTD = False        # inputs need the library

__all__ = ["load_trace", "parse_requests", "sniff_format", "open_trace",
           "PAGE_BYTES", "DEFAULT_LOGICAL_PAGES", "HAVE_ZSTD"]

PAGE_BYTES = 4096
# matches driver.LOGICAL_SPACE_CAP (not imported: the workloads package
# stays free of the simulator's modules)
DEFAULT_LOGICAL_PAGES = 1 << 16

_MSR_TICKS_PER_MS = 10_000          # Windows filetime: 100 ns ticks

_TIME_COLS = ("arrival_ms", "time_ms", "time", "timestamp_ms", "timestamp")
_LBA_COLS = ("lba", "page", "offset_pages")
_OFFSET_COLS = ("offset", "offset_bytes")
_PAGES_COLS = ("pages", "size_pages")
_BYTES_COLS = ("size", "size_bytes", "length", "bytes")
_OP_COLS = ("op", "type", "rw", "is_write")
_WRITE_TOKENS = {"w", "write", "writes", "1", "true"}
_READ_TOKENS = {"r", "read", "reads", "0", "false", "trim"}


def open_trace(path: str) -> io.TextIOBase:
    """Open a (possibly compressed) trace file as text lines."""
    if path.endswith(".zst"):
        if not HAVE_ZSTD:
            raise ImportError(
                f"{path} is zstd-compressed but zstandard is not installed; "
                "decompress it or `pip install zstandard`")
        fh = open(path, "rb")
        reader = zstd.ZstdDecompressor().stream_reader(fh)
        return io.TextIOWrapper(reader, encoding="utf-8", errors="replace")
    if path.endswith(".gz"):
        import gzip
        return io.TextIOWrapper(gzip.open(path, "rb"), encoding="utf-8",
                                errors="replace")
    return open(path, "r", encoding="utf-8", errors="replace")


def _is_float(tok: str) -> bool:
    try:
        float(tok)
        return True
    except ValueError:
        return False


_BLK_DEV = re.compile(r"^\d+,\d+$")     # blkparse device column: maj,min


def sniff_format(first_line: str) -> str:
    """Guess the trace format from its first data line."""
    line = first_line.strip()
    # blktrace before the comma-delimited formats: its only comma is the
    # maj,min device column of a whitespace-separated line
    parts = line.split()
    if len(parts) >= 6 and _BLK_DEV.match(parts[0]):
        return "blktrace"
    if "," in line:
        parts = [p.strip() for p in line.split(",")]
        if len(parts) >= 6 and parts[3].lower() in ("read", "write"):
            return "msr"
        return "generic"
    parts = line.split()
    if line.lower().startswith("fio version") or \
            any(p.lower() in ("read", "write") for p in parts):
        return "fio"
    raise ValueError(f"cannot sniff trace format from line {line!r}")


def _parse_msr(lines: Iterable[str], rows: Dict) -> None:
    t0 = None
    for line in lines:
        parts = [p.strip() for p in line.split(",")]
        if len(parts) < 6 or not _is_float(parts[0]):
            continue
        ticks = float(parts[0])
        if t0 is None:
            t0 = ticks
        size = max(int(float(parts[5])), 1)
        rows["arrival_ms"].append((ticks - t0) / _MSR_TICKS_PER_MS)
        rows["lba"].append(int(float(parts[4])) // PAGE_BYTES)
        rows["pages"].append(-(-size // PAGE_BYTES))
        rows["is_write"].append(parts[3].lower() == "write")


def _op_is_write(tok: str) -> Optional[bool]:
    tok = tok.lower()
    if tok in _WRITE_TOKENS:
        return True
    if tok in _READ_TOKENS:
        return False
    return None


def _generic_header(parts) -> Optional[Dict[str, int]]:
    """Column map from a header row, or None if the row is data."""
    names = [p.strip().lower() for p in parts]
    if all(_is_float(n) or _op_is_write(n) is not None for n in names):
        return None
    cols = {}
    for role, aliases in (("time", _TIME_COLS), ("lba", _LBA_COLS),
                          ("offset", _OFFSET_COLS), ("pages", _PAGES_COLS),
                          ("bytes", _BYTES_COLS), ("op", _OP_COLS)):
        for alias in aliases:
            if alias in names:
                cols[role] = names.index(alias)
                break
    if "op" not in cols or ("lba" not in cols and "offset" not in cols):
        raise ValueError(f"generic trace header {names} must name an op "
                         "column and an lba/offset column")
    return cols


def _parse_generic(lines: Iterable[str], rows: Dict) -> None:
    cols = None
    for line in lines:
        parts = [p.strip() for p in line.split(",")]
        if len(parts) < 3:
            continue
        if cols is None:
            cols = _generic_header(parts)
            if cols is None:        # headerless: time_ms, lba, pages, op
                cols = {"time": 0, "lba": 1, "pages": 2, "op": 3}
            else:
                continue
        if len(parts) <= max(cols.values()):
            continue                # truncated/malformed row
        w = _op_is_write(parts[cols["op"]])
        if w is None:
            continue
        if "lba" in cols:
            lba = int(float(parts[cols["lba"]]))
        else:
            lba = int(float(parts[cols["offset"]])) // PAGE_BYTES
        if "pages" in cols:
            pages = int(float(parts[cols["pages"]]))
        elif "bytes" in cols:
            pages = -(-max(int(float(parts[cols["bytes"]])), 1) // PAGE_BYTES)
        else:
            pages = 1
        t = float(parts[cols["time"]]) if "time" in cols else 0.0
        rows["arrival_ms"].append(t)
        rows["lba"].append(lba)
        rows["pages"].append(max(pages, 1))
        rows["is_write"].append(w)


def _parse_fio(lines: Iterable[str], rows: Dict) -> None:
    for line in lines:
        parts = line.split()
        ops = [i for i, p in enumerate(parts)
               if p.lower() in ("read", "write")]
        if not ops or len(parts) < ops[0] + 3:
            continue
        i = ops[0]
        # v3 iologs lead with a timestamp-ms column; v2 has none
        t = float(parts[0]) if i >= 1 and _is_float(parts[0]) else 0.0
        rows["arrival_ms"].append(t)
        rows["lba"].append(int(parts[i + 1]) // PAGE_BYTES)
        rows["pages"].append(-(-max(int(parts[i + 2]), 1) // PAGE_BYTES))
        rows["is_write"].append(parts[i].lower() == "write")


_BLK_SECTOR_BYTES = 512
# lifecycle action classes, most host-like first: a queue (Q) event exists
# for every I/O an application issued; dispatch (D) / completion (C) only
# cover what reached the device, so they are fallbacks for filtered logs
_BLK_ACTION_PREF = ("Q", "D", "C")


def _parse_blktrace(lines: Iterable[str], rows: Dict) -> None:
    """`blkparse` text output. Keeps the most host-like action class
    present (module docstring) so an I/O traced through its whole
    lifecycle (Q..G..I..D..C) counts once. Memory stays ~1x the kept
    class: once a higher-preference class appears, lower classes can
    never win, so their events are skipped (and stale buffers freed)
    rather than accumulated."""
    rank = {a: i for i, a in enumerate(_BLK_ACTION_PREF)}
    per_action = {a: {k: [] for k in rows} for a in _BLK_ACTION_PREF}
    best = len(_BLK_ACTION_PREF)            # rank of best class seen
    for line in lines:
        parts = line.split()
        # payload lines: maj,min cpu seq ts pid ACTION RWBS sector + nsect
        if (len(parts) < 10 or not _BLK_DEV.match(parts[0])
                or parts[8] != "+" or not _is_float(parts[3])
                or not parts[7].isdigit() or not parts[9].isdigit()):
            continue
        action = parts[5]
        r = rank.get(action)
        if r is None or r > best:
            continue
        rwbs = parts[6].upper()
        if "W" in rwbs:
            w = True
        elif "R" in rwbs and "A" not in rwbs:   # skip readahead
            w = False
        else:
            continue                            # N / flush-only / discard
        if r < best:                            # new winner: free the rest
            best = r
            per_action = {a: buf for a, buf in per_action.items()
                          if rank[a] <= best}
        out = per_action[action]
        nsect = max(int(parts[9]), 1)
        out["arrival_ms"].append(float(parts[3]) * 1e3)
        out["lba"].append(int(parts[7]) * _BLK_SECTOR_BYTES // PAGE_BYTES)
        out["pages"].append(
            -(-(nsect * _BLK_SECTOR_BYTES) // PAGE_BYTES))
        out["is_write"].append(w)
    if best < len(_BLK_ACTION_PREF):
        for k in rows:
            rows[k].extend(per_action[_BLK_ACTION_PREF[best]][k])


_PARSERS = {"msr": _parse_msr, "generic": _parse_generic, "fio": _parse_fio,
            "blktrace": _parse_blktrace}


def parse_requests(path: str, fmt: Optional[str] = None) -> Dict:
    """Parse a trace file into a request-level dict (arrival_ms f64 ms from
    trace start, lba/pages in 4 KB page units, is_write bool), sorted by
    arrival."""
    with open_trace(path) as fh:
        if fmt is None:
            pos = None
            for line in fh:
                if line.strip():
                    fmt = sniff_format(line)
                    pos = line
                    break
            if fmt is None:
                raise ValueError(f"{path}: empty trace file")
            lines = [pos] + list(fh)
        else:
            lines = list(fh)
        if fmt not in _PARSERS:
            raise ValueError(f"unknown trace format {fmt!r}; "
                             f"choose from {sorted(_PARSERS)}")
        rows = {"arrival_ms": [], "lba": [], "pages": [], "is_write": []}
        _PARSERS[fmt](lines, rows)
    if not rows["arrival_ms"]:
        raise ValueError(f"{path}: no parsable requests (format {fmt})")
    req = {
        "arrival_ms": np.asarray(rows["arrival_ms"], np.float64),
        "lba": np.asarray(rows["lba"], np.int64),
        "pages": np.asarray(rows["pages"], np.int64),
        "is_write": np.asarray(rows["is_write"], bool),
    }
    order = np.argsort(req["arrival_ms"], kind="stable")
    if not np.array_equal(order, np.arange(len(order))):
        req = {k: v[order] for k, v in req.items()}
    req["arrival_ms"] = req["arrival_ms"] - req["arrival_ms"][0]
    return req


def load_trace(path: str, mode: str = "daily",
               max_ops: Optional[int] = None, *,
               total_logical_pages: int = DEFAULT_LOGICAL_PAGES,
               fmt: Optional[str] = None) -> ir.Trace:
    """Parse a real trace file into a Trace IR record.

    Addresses are taken mod `total_logical_pages` (the simulator's
    compressed logical window); `mode="bursty"` applies the paper's
    bursty rewrite; `max_ops` truncates after page expansion."""
    req = parse_requests(path, fmt)
    tr = ir.trace_from_requests(req, mode, total_logical_pages,
                                f"file:{os.path.basename(path)}")
    if max_ops is not None:
        tr = tr.truncate(max_ops)
    return tr
