"""Architecture registry: --arch <id> resolution for every launcher.

Copy of the reference's `repro/configs/registry.py`: the port imports
nothing of the reference package.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import (ArchConfig, ShapeConfig, SHAPES,
                                      SHAPES_BY_NAME, shape_applicable)

from repro_torch.configs.zamba2_1p2b import CONFIG as _zamba2
from repro_torch.configs.deepseek_v2_lite_16b import CONFIG as _dsv2l
from repro_torch.configs.arctic_480b import CONFIG as _arctic
from repro_torch.configs.yi_34b import CONFIG as _yi34
from repro_torch.configs.minitron_4b import CONFIG as _minitron
from repro_torch.configs.yi_6b import CONFIG as _yi6
from repro_torch.configs.gemma_2b import CONFIG as _gemma
from repro_torch.configs.mamba2_370m import CONFIG as _mamba2
from repro_torch.configs.whisper_tiny import CONFIG as _whisper
from repro_torch.configs.llava_next_34b import CONFIG as _llava

ARCHS: Dict[str, ArchConfig] = {
    c.name: c
    for c in (
        _zamba2, _dsv2l, _arctic, _yi34, _minitron,
        _yi6, _gemma, _mamba2, _whisper, _llava,
    )
}

ARCH_IDS = tuple(ARCHS)


def get_arch(name: str) -> ArchConfig:
    try:
        return ARCHS[name]
    except KeyError:
        raise KeyError(
            f"unknown arch {name!r}; available: {', '.join(ARCH_IDS)}") from None


def get_shape(name: str) -> ShapeConfig:
    try:
        return SHAPES_BY_NAME[name]
    except KeyError:
        raise KeyError(
            f"unknown shape {name!r}; available: "
            f"{', '.join(SHAPES_BY_NAME)}") from None


def dryrun_cells():
    """All (arch, shape, runnable, skip_reason) dry-run cells — 40 total."""
    cells = []
    for arch in ARCHS.values():
        for shape in SHAPES:
            ok, reason = shape_applicable(arch, shape)
            cells.append((arch, shape, ok, reason))
    return cells
