"""Architecture config registry: ``repro_torch.configs.get("<arch>")``.

The ported architectures (dense, vlm and hybrid families) each export CONFIG
(exact published spec, source cited in its docstring) and REDUCED (the
small variant of the CPU tests), copied from ``repro.configs``.  The other
architectures of the reference raise ``NotImplementedError``: their
families are not ported yet (ROADMAP queue 1 item 16).
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig  # noqa: F401

ARCHS = ("gemma2_27b", "internvl2_26b", "llama3_8b", "recurrentgemma_2b")


def canonical(name: str) -> str:
    """Arch id of a published name ("recurrentgemma-2b" -> "recurrentgemma_2b"),
    as the reference's alias table gives it."""
    return name.replace("-", "_").replace(".", "_")


def get(name: str, reduced: bool = False) -> ModelConfig:
    arch = canonical(name)
    if arch not in ARCHS:
        raise NotImplementedError(
            f"{name!r} is not ported: the port has {', '.join(ARCHS)} "
            "(ROADMAP queue 1 item 16)"
        )
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.REDUCED if reduced else mod.CONFIG
