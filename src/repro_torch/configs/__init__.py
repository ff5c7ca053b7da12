"""Architecture config registry: ``repro_torch.configs.get("<arch>")``.

Each module exports CONFIG (exact published spec, source cited in its
docstring) and REDUCED (<=2 layers, d_model<=512, <=4 experts) for the CPU
tests, copied from ``repro.configs`` field for field.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig  # noqa: F401

ARCHS = (
    "whisper_medium",
    "qwen3_14b",
    "qwen2_moe_a2_7b",
    "grok_1_314b",
    "gemma2_27b",
    "internvl2_26b",
    "llama3_8b",
    "recurrentgemma_2b",
    "mamba2_2_7b",
    "qwen3_32b",
    "paper_ae",
)


def canonical(name: str) -> str:
    """Arch id of a published name ("qwen2-moe-a2.7b" -> "qwen2_moe_a2_7b"),
    as the reference's alias table gives it."""
    return name.replace("-", "_").replace(".", "_")


def get(name: str, reduced: bool = False) -> ModelConfig:
    arch = canonical(name)
    if arch not in ARCHS:
        raise ValueError(f"unknown arch {name!r}: the archs are {', '.join(ARCHS)}")
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.REDUCED if reduced else mod.CONFIG


def model_archs() -> tuple[str, ...]:
    """The ten assigned transformer/SSM architectures (excludes paper_ae)."""
    return tuple(a for a in ARCHS if a != "paper_ae")
