"""The paper's own simulated-SSD configuration (Table I) + scheme settings.

384GB; 8 Channels; 4 Chips/Channel; 2 Dies/Chip; 2 Planes/Die;
2048 Blocks/Plane; 384 Pages/Block; 4KB Page.
Timing: 0.02ms SLC read; 0.066ms TLC read; 0.5ms SLC write; 3ms TLC write;
10ms erase.

SLC cache: 4GB (baseline / IPS / IPS-agc); cooperative: 64GB total
(3.125GB IPS/agc + 60.875GB traditional).
"""
from repro_torch.core.ssd.config import SSDConfig, TimingConfig

PAPER_TIMING = TimingConfig(
    slc_read_ms=0.02,
    tlc_read_ms=0.066,
    slc_write_ms=0.5,
    tlc_write_ms=3.0,
    erase_ms=10.0,
    reprogram_ms=3.0,       # conservatively TLC program latency (paper §IV.B)
)

PAPER_SSD = SSDConfig(
    channels=8,
    chips_per_channel=4,
    dies_per_chip=2,
    planes_per_die=2,
    blocks_per_plane=2048,
    pages_per_block=384,
    page_kb=4,
    layers_per_block=64,    # 3D block: 384 pages / (3 bits x 2 wordline-pages) -> 64 layers x 6 pages
    timing=PAPER_TIMING,
    slc_cache_gb=4.0,
    coop_ips_gb=3.125,
    coop_traditional_gb=60.875,
)


def scaled_ssd(scale: int = 64) -> SSDConfig:
    """Proportionally scaled SSD for CPU-budget simulation (DESIGN.md §2).

    Scale divides blocks_per_plane (capacity and cache scale together), so
    cache-to-writeset ratios — which set the normalized latency / WA
    behaviour — are preserved when traces are scaled by the same factor.
    """
    return PAPER_SSD.scaled(scale)
