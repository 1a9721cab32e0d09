"""Simulated hybrid 3D SSD configuration (paper Table I) and derived geometry.

Time unit everywhere in the simulator: **milliseconds, float32**. Synthetic
traces are generated with total spans <= ~1e5 ms so f32 resolution (<0.01 ms
at that magnitude) is far below the smallest latency constant (0.02 ms).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class TimingConfig:
    slc_read_ms: float = 0.02
    tlc_read_ms: float = 0.066
    slc_write_ms: float = 0.5
    tlc_write_ms: float = 3.0
    erase_ms: float = 10.0
    reprogram_ms: float = 3.0   # conservatively TLC program latency (paper §IV.B)


@dataclass(frozen=True)
class SSDConfig:
    channels: int = 8
    chips_per_channel: int = 4
    dies_per_chip: int = 2
    planes_per_die: int = 2
    blocks_per_plane: int = 2048
    pages_per_block: int = 384          # TLC pages
    page_kb: int = 4
    layers_per_block: int = 64
    timing: TimingConfig = TimingConfig()
    slc_cache_gb: float = 4.0           # baseline / IPS / IPS-agc cache size
    coop_ips_gb: float = 3.125          # cooperative: IPS/agc region
    coop_traditional_gb: float = 60.875  # cooperative: traditional region
    # SLC mode stores 1 bit/cell vs TLC's 3: an SLC block holds 1/3 the pages
    slc_density_ratio: int = 3
    # idle handling
    idle_threshold_ms: float = 5.0      # gaps longer than this count as idle
    # endurance model (DESIGN.md §9): wear buckets per plane cache region —
    # the static block-granularity of P/E tracking (shapes, so not traced)
    wear_buckets: int = 8

    # ------------------------------------------------------------------
    @property
    def num_planes(self) -> int:
        return (self.channels * self.chips_per_channel * self.dies_per_chip
                * self.planes_per_die)

    @property
    def page_bytes(self) -> int:
        return self.page_kb * 1024

    @property
    def pages_per_plane(self) -> int:
        return self.blocks_per_plane * self.pages_per_block

    @property
    def total_pages(self) -> int:
        return self.num_planes * self.pages_per_plane

    @property
    def capacity_gb(self) -> float:
        return self.total_pages * self.page_bytes / 1024 ** 3

    @property
    def pages_per_slc_block(self) -> int:
        return self.pages_per_block // self.slc_density_ratio

    def _gb_to_pages_per_plane(self, gb: float) -> int:
        return max(int(gb * 1024 ** 3 / self.page_bytes / self.num_planes), 4)

    @property
    def slc_cap_pages(self) -> int:
        """SLC cache pages per plane (evenly striped, paper §V.A)."""
        return self._gb_to_pages_per_plane(self.slc_cache_gb)

    @property
    def coop_ips_pages(self) -> int:
        return self._gb_to_pages_per_plane(self.coop_ips_gb)

    @property
    def coop_trad_pages(self) -> int:
        return self._gb_to_pages_per_plane(self.coop_traditional_gb)

    def scaled(self, scale: int) -> "SSDConfig":
        """Proportional scale-down: capacity and all cache regions divided by
        `scale`; hierarchy, page size, and timing unchanged (DESIGN.md §2)."""
        return dataclasses.replace(
            self,
            blocks_per_plane=max(self.blocks_per_plane // scale, 8),
            slc_cache_gb=self.slc_cache_gb / scale,
            coop_ips_gb=self.coop_ips_gb / scale,
            coop_traditional_gb=self.coop_traditional_gb / scale,
        )
