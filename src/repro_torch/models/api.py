"""Model API over the ported language-model families: init / decode step
/ cache, the serving subset of ``repro.models.api``.

Ported families: ``dense`` and ``vlm`` (``models/transformer``) and
``hybrid`` (``models/rglru``).  ``moe``, ``ssm`` and ``encdec`` raise
``NotImplementedError`` (ROADMAP queue 1 item 16), as do the train,
prefill-by-``forward`` and dry-run builders, which are not ported.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import rglru, transformer

Params = Any

_FAMILY = {
    "dense": transformer,
    "vlm": transformer,
    "hybrid": rglru,
}


def module(cfg: ModelConfig):
    if cfg.family not in _FAMILY:
        raise NotImplementedError(
            f"the {cfg.family!r} family ({cfg.name}) is not ported (ROADMAP queue 1 item 16)"
        )
    return _FAMILY[cfg.family]


def init_params(generator: torch.Generator, cfg: ModelConfig) -> Params:
    """Random params drawn on the generator's device."""
    return module(cfg).init(generator, cfg)


def make_serve_step(cfg: ModelConfig, long_context: bool = False) -> Callable:
    """``serve_step(params, cache, tokens (b, 1)) -> (cache, logits (b, 1,
    vocab) f32)``; the KV caches are updated in place."""
    mod = module(cfg)

    def serve_step(params: Params, cache, tokens: torch.Tensor):
        return mod.decode_step(params, cache, tokens, cfg, long_context=long_context)

    return serve_step


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, long_context: bool = False,
               device: torch.device | str | None = None):
    return module(cfg).init_cache(cfg, batch, max_seq, long_context, device=device)
