"""Architecture registry: ``get(name)`` returns the exact assigned config,
``get_smoke(name)`` a reduced same-family variant for CPU smoke tests.

The port's own copy of the JAX package's ``configs`` (the port imports
nothing of that package); ``tests/test_torch_lm.py`` holds the two equal
field by field."""

from __future__ import annotations

from .base import SHAPES, ArchConfig, RunConfig, ShapeConfig, reduced
from .stablelm_3b import CONFIG as stablelm_3b
from .granite_20b import CONFIG as granite_20b
from .smollm_135m import CONFIG as smollm_135m
from .qwen3_32b import CONFIG as qwen3_32b
from .whisper_base import CONFIG as whisper_base
from .falcon_mamba_7b import CONFIG as falcon_mamba_7b
from .internvl2_26b import CONFIG as internvl2_26b
from .jamba_v01_52b import CONFIG as jamba_v01_52b
from .kimi_k2_1t import CONFIG as kimi_k2_1t
from .qwen3_moe_30b import CONFIG as qwen3_moe_30b

ARCHS: dict[str, ArchConfig] = {
    c.name: c
    for c in [
        stablelm_3b,
        granite_20b,
        smollm_135m,
        qwen3_32b,
        whisper_base,
        falcon_mamba_7b,
        internvl2_26b,
        jamba_v01_52b,
        kimi_k2_1t,
        qwen3_moe_30b,
    ]
}


def get(name: str) -> ArchConfig:
    return ARCHS[name]


def get_smoke(name: str, **kw) -> ArchConfig:
    return reduced(ARCHS[name], **kw)


def applicable_shapes(cfg: ArchConfig) -> list[str]:
    """Which of the four shape cells apply (long_500k needs sub-quadratic
    attention: SSM/hybrid only)."""
    shapes = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.family in ("ssm", "hybrid"):
        shapes.append("long_500k")
    return shapes


__all__ = [
    "ARCHS",
    "SHAPES",
    "ArchConfig",
    "RunConfig",
    "ShapeConfig",
    "applicable_shapes",
    "get",
    "get_smoke",
    "reduced",
]
