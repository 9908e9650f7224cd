"""Assigned-architecture registry: ``--arch <id>`` resolution.

Data-only copy of `repro.configs` for the PyTorch port (which imports
nothing of the JAX package): each architecture lives in its own module with
the exact published config; this package assembles the registry and exposes
the shape table.  `repro_torch.core.density.rho_v24` calibrates over it.
"""
from repro_torch.configs.base import SHAPES, ArchConfig, ShapeConfig, reduced
from repro_torch.configs.chameleon_34b import CONFIG as chameleon_34b
from repro_torch.configs.deepseek_v2_236b import CONFIG as deepseek_v2_236b
from repro_torch.configs.gemma_2b import CONFIG as gemma_2b
from repro_torch.configs.gemma_7b import CONFIG as gemma_7b
from repro_torch.configs.granite_34b import CONFIG as granite_34b
from repro_torch.configs.granite_3_2b import CONFIG as granite_3_2b
from repro_torch.configs.mixtral_8x7b import CONFIG as mixtral_8x7b
from repro_torch.configs.musicgen_large import CONFIG as musicgen_large
from repro_torch.configs.rwkv6_1_6b import CONFIG as rwkv6_1_6b
from repro_torch.configs.zamba2_7b import CONFIG as zamba2_7b

ALL_ARCHS: dict[str, ArchConfig] = {
    c.name: c for c in (
        gemma_7b, gemma_2b, granite_34b, granite_3_2b, zamba2_7b,
        mixtral_8x7b, deepseek_v2_236b, rwkv6_1_6b, chameleon_34b,
        musicgen_large,
    )
}


def get_arch(name: str) -> ArchConfig:
    if name not in ALL_ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ALL_ARCHS)}")
    return ALL_ARCHS[name]


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; known: {sorted(SHAPES)}")
    return SHAPES[name]


def live_cells() -> list[tuple[str, str]]:
    """All (arch, shape) dry-run cells, excluding documented long_500k skips
    (DESIGN.md §4: long_500k needs sub-quadratic attention)."""
    cells = []
    for a, cfg in ALL_ARCHS.items():
        for s, sh in SHAPES.items():
            if s == "long_500k" and not cfg.sub_quadratic:
                continue
            cells.append((a, s))
    return cells


__all__ = ["ALL_ARCHS", "SHAPES", "ArchConfig", "ShapeConfig", "reduced",
           "get_arch", "get_shape", "live_cells"]
