"""Host-tier block cache example on the PyTorch / CUDA port (the
counterpart of `examples/host_cache.py`): the two-level cliff (DESIGN.md
§14).

Three views of the stacked host-cache + SSD hierarchy on the diurnal
`flush_burst` scenario:

 1. write policy — write-back vs write-through vs no host tier: the wb
    tier absorbs most of the write stream (host hit rate > 0, device-
    visible writes well below trace writes) and host-visible write
    latency collapses to the DRAM-tier hit time.
 2. per-tier timelines — host windows (hits, dirty level, flush bursts)
    against device windows: watermark flush bursts land on the device as
    write-back volume, and where a burst overlaps SLC reclamation the
    device-visible window latency spikes (the flush-burst-vs-reclamation
    interaction window).
 3. the two-level cliff — on the bursty rewrite the host-visible write
    latency is FLAT (wb absorbs everything at hit_ms), while the
    device-visible latency series still cliffs when the SLC cache
    exhausts. `detect_cliff` on the device-visible series surfaces it.

On the card each run with a host tier is one `host_tier` launch (the
tier pass) and one `ssd_step` launch (the device sub-ops); without one,
one `ssd_step` launch.

Run: PYTHONPATH=src python examples/host_cache_torch.py [--max-ops N] \\
         [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.configs.ssd_paper import PAPER_SSD
from repro_torch.core.ssd.sim import CTR, run_trace, summarize
from repro_torch.hostcache import HostCacheSpec
from repro_torch.telemetry.timeline import detect_cliff
from repro_torch.workloads.generators import flush_burst


def _np(x) -> np.ndarray:
    return np.asarray(x.detach().cpu() if torch.is_tensor(x) else x)


def _series(hw):
    """Device-visible per-window mean latency + device ops from a
    HostWindows record — the series the cliff detector consumes."""
    dev_n = _np(hw.dev_ops + hw.flush_w + hw.evict_w).astype(np.float64)
    dev_lat = _np(hw.dev_lat_ms).astype(np.float64)
    mean = np.where(dev_n > 0, dev_lat / np.maximum(dev_n, 1), np.nan)
    return mean, dev_n


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--max-ops", type=int, default=None)
    ap.add_argument("--window-ops", type=int, default=1024)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device (use --device cpu "
                         "for the kernels' plain versions)")

    cfg = PAPER_SSD.scaled(128)
    n_logical = min(cfg.total_pages, 1 << 16)
    base = flush_burst(n_logical, capacity_pages=cfg.total_pages)
    if args.max_ops:
        base = base.truncate(args.max_ops)
    daily = base.compile()
    bursty = base.to_bursty(n_logical).compile()
    isw = np.asarray(daily["is_write"])
    trace_w = int((isw == 1).sum())
    out = {}

    # -- 1. write policy: wb vs wt vs no host tier ----------------------
    print(f"flush_burst daily, ips policy ({trace_w} trace writes)")
    print(f"{'tier':<14}{'hit rate':>9}{'dev wr':>8}{'dev/trace':>10}"
          f"{'host lat ms':>12}")
    variants = [("off", None), ("wb:watermark", HostCacheSpec()),
                ("wt", HostCacheSpec(mode="wt"))]
    for label, hc in variants:
        lat, st = run_trace(cfg, "ips", daily, closed_loop=False,
                            n_logical=n_logical, hostcache=hc, device=dev)
        s = summarize(lat, isw, st)
        dev_w = float(st.counters[CTR["host_w"]])
        hit = float(s.get("host_hit_rate", 0.0))
        print(f"{label:<14}{hit:>9.3f}{dev_w:>8.0f}"
              f"{dev_w / trace_w:>10.3f}"
              f"{float(s['mean_write_latency_ms']):>12.4f}")
        out[label] = {"hit": hit, "dev_w": dev_w,
                      "lat": float(s["mean_write_latency_ms"])}

    # -- 2. per-tier timelines on the diurnal trace ---------------------
    w = args.window_ops
    _, st = run_trace(cfg, "ips", daily, closed_loop=False,
                      n_logical=n_logical, hostcache=HostCacheSpec(),
                      timeline_ops=w, device=dev)
    hw = st.hostcache.hwin
    mean, dev_n = _series(hw)
    hits, dirty, flush_w = _np(hw.hits), _np(hw.dirty_frac), _np(hw.flush_w)
    live = _np(hw.absorbed + hw.dev_ops) > 0
    print(f"\nper-tier windows ({w} ops each; host tier above, device "
          f"view below):")
    print(f"{'win':>4}{'hits':>7}{'dirty%':>8}{'flush_w':>8}"
          f"{'dev ops':>8}{'dev lat/op ms':>14}")
    idx = np.flatnonzero(live)
    for i in idx[:: max(1, len(idx) // 16)]:
        print(f"{i:>4}{float(hits[i]):>7.0f}"
              f"{100 * float(dirty[i]):>7.1f}%"
              f"{float(flush_w[i]):>8.0f}{dev_n[i]:>8.0f}"
              f"{mean[i] if dev_n[i] else 0.0:>14.3f}")
    burst = flush_w > 0
    if burst.any() and dev_n[~burst & live].sum() > 0:
        in_b = mean[burst & (dev_n > 0)]
        out_b = mean[~burst & live & (dev_n > 0)]
        print(f"flush-burst windows: {int(burst.sum())}; device lat/op "
              f"{np.nanmean(in_b):.3f} ms inside bursts vs "
              f"{np.nanmean(out_b):.3f} ms outside — the "
              f"flush-burst-vs-reclamation interaction window")

    # -- 3. the two-level cliff (bursty rewrite) ------------------------
    print("\nbursty rewrite, wb host tier — device-visible cliff:")
    for pol in ("baseline", "ips"):
        lat, st = run_trace(cfg, pol, bursty, closed_loop=True,
                            n_logical=n_logical, hostcache=HostCacheSpec(),
                            timeline_ops=w, device=dev)
        s = summarize(lat, np.asarray(bursty["is_write"]), st)
        mean, dev_n = _series(st.hostcache.hwin)
        cliff = detect_cliff(mean, dev_n, window_ops=w)
        host_lat = float(s["mean_write_latency_ms"])
        tot = float(st.hostcache.dev_lat_ms)
        where = (f"window {cliff['window']} "
                 f"({cliff['ratio']:.1f}x steady)" if cliff["detected"]
                 else "none")
        print(f"  {pol:<9} host-visible lat {host_lat:.4f} ms (flat), "
              f"device cliff: {where}, total device ms {tot:.0f}")
        out[f"cliff/{pol}"] = {"cliff": cliff, "host_lat": host_lat,
                               "dev_ms": tot}
    return out


if __name__ == "__main__":
    main()
