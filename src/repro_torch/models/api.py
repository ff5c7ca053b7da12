"""Model API over the ported language-model families: init, loss, the
train / prefill / serve step builders, the decode cache and the dry run's
abstract inputs of ``repro.models.api``.

Families: ``dense`` and ``vlm`` (``models/transformer``), ``moe``
(``models/moe``), ``ssm`` (``models/ssm``), ``hybrid`` (``models/rglru``)
and ``encdec`` (``models/encdec``).  The dry-run builders
(:func:`abstract_params`, :func:`abstract_cache`, :func:`input_specs`) give
``device="meta"`` tensors, shapes and dtypes without storage: the family's
own init runs under ``FakeTensorMode``, so nothing is allocated even for
grok-1's 3.2e11 parameters.

Gradients come from ``optim/sgd.grad_and_value``, ``torch.autograd.grad``
over copies of the leaves: ``torch.func.grad`` refuses a loss that runs
non-reentrant checkpointing (the blocks under ``cfg.remat`` and every
cross-entropy chunk), since it does not support saved-tensor hooks.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import encdec, moe, rglru, ssm, transformer
from repro_torch.models import layers as L
from repro_torch.optim import sgd

Params = Any

_FAMILY = {
    "dense": transformer,
    "vlm": transformer,
    "moe": moe,
    "ssm": ssm,
    "hybrid": rglru,
    "encdec": encdec,
}


def module(cfg: ModelConfig):
    if cfg.family not in _FAMILY:
        raise ValueError(f"unknown model family {cfg.family!r} ({cfg.name})")
    return _FAMILY[cfg.family]


def init_params(generator: torch.Generator, cfg: ModelConfig) -> Params:
    """Random params drawn on the generator's device."""
    return module(cfg).init(generator, cfg)


def _meta(tree):
    return L.map_leaves(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), tree)


def abstract_params(cfg: ModelConfig) -> Params:
    """The params' shapes and dtypes as ``meta`` tensors, allocating
    nothing: the family's init runs under ``FakeTensorMode`` with a CPU
    generator (a generator on ``meta`` is refused)."""
    with FakeTensorMode():
        params = init_params(torch.Generator(), cfg)
    return _meta(params)


def param_axes(cfg: ModelConfig) -> Params:
    """Logical sharding axes of the params (``launch/sharding``)."""
    return module(cfg).axes(cfg)


def loss_fn(cfg: ModelConfig, data: Any = None) -> Callable[[Params, dict], torch.Tensor]:
    """``loss(params, batch) -> f32 scalar``, the family's next-token
    cross-entropy (plus the router aux loss of a MoE); ``batch["tokens"]``
    (b, s) int (+ a VLM's ``visual_embeds``, an enc-dec model's
    ``audio_embeds``).  ``data`` (a ``launch/sharding.ClientMesh`` over
    which the batch is split) reaches only a MoE's loss, whose aux loss
    is the whole batch's (``models/moe.loss``)."""
    mod = module(cfg)
    if cfg.family == "moe":
        return lambda params, batch: mod.loss(params, batch, cfg, data=data)
    return lambda params, batch: mod.loss(params, batch, cfg)


SGD_CHUNK = 2 ** 26      # elements of a leaf updated at a time


def sgd_update(p: torch.Tensor, g: torch.Tensor, step: float) -> torch.Tensor:
    """``(p.f32 + step * g.f32).to(p.dtype)`` as a new tensor, made in
    slices along the leading axis of at most ``SGD_CHUNK`` elements (a
    whole number of rows, at least one), so the f32 transients stay small:
    a stacked leaf goes a layer at a time."""
    out = torch.empty_like(p)
    if p.dim() == 0:
        return out.copy_(p.to(torch.float32) + step * g.to(torch.float32))
    rows = max(1, SGD_CHUNK // max(1, p[0].numel()))
    for o, pp, gg in zip(out.split(rows), p.split(rows), g.split(rows)):
        o.copy_(pp.to(torch.float32) + step * gg.to(torch.float32))
    return out


def make_train_step(cfg: ModelConfig, data: Any = None) -> Callable:
    """Plain-SGD step ``train_step(params, batch) -> (new params, loss)``:
    each leaf ``(p.f32 - lr * g.f32).to(p.dtype)``, as in the reference.
    The given params are left as they are.

    ``data`` (a ``launch/sharding.ClientMesh``, the reference's ``data``
    mesh axis) makes the step data-parallel: each rank passes its equal
    share of the global batch, and each leaf's gradient is mean-reduced
    over the group in f32 just before its update, one leaf at a time, so
    no f32 copy of every gradient lives at once.  The loss is the mean
    over the ranks, and every rank's new params are the same bits."""
    lfn = loss_fn(cfg, data)

    def train_step(params: Params, batch: dict) -> tuple[Params, torch.Tensor]:
        grads, loss = sgd.grad_and_value(lfn)(params, batch)
        grads = sgd.tree_leaves(grads)
        new = []
        for i, p in enumerate(sgd.tree_leaves(params)):
            g = grads[i] if data is None else data.mean_(grads[i])
            new.append(sgd_update(p, g, -cfg.learning_rate))
            grads[i] = g = None    # drop each gradient once its leaf is updated
        if data is not None:
            loss = data.mean_(loss.clone())
        return sgd.tree_unflatten(params, new), loss

    return train_step


def make_prefill_step(cfg: ModelConfig) -> Callable:
    """Forward-only full-sequence step: ``prefill_step(params, batch) ->
    the last position's hidden state (b, d)`` after the final norm (a
    MoE's forward also returns its aux loss, which is dropped)."""
    mod = module(cfg)

    def prefill_step(params: Params, batch: dict) -> torch.Tensor:
        with torch.no_grad():
            h = mod.forward(params, batch, cfg)
            if cfg.family == "moe":
                h = h[0]
            return h[:, -1, :]

    return prefill_step


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


def abstract_cache(cfg: ModelConfig, batch: int, max_seq: int, long_context: bool = False):
    """The decode cache's shapes and dtypes as ``meta`` tensors, allocating
    nothing (:func:`init_cache` under ``FakeTensorMode``)."""
    with FakeTensorMode():
        cache = init_cache(cfg, batch, max_seq, long_context, device="cpu")
    return _meta(cache)


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict[str, torch.Tensor]:
    """``meta`` stand-ins for every model input of this shape.  train and
    prefill: the token batch (b, s) int32, plus an enc-dec model's
    ``audio_embeds`` and a VLM's ``visual_embeds``; decode: one new token a
    sequence (the cache is a separate argument, :func:`abstract_cache`)."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind in ("train", "prefill"):
        specs = {"tokens": torch.empty((b, s), dtype=torch.int32, device="meta")}
        if cfg.family == "encdec":
            specs["audio_embeds"] = torch.empty((b, cfg.n_audio_frames, cfg.d_model),
                                                dtype=cfg.dtype, device="meta")
        if cfg.n_visual_tokens > 0:
            specs["visual_embeds"] = torch.empty((b, cfg.n_visual_tokens, cfg.d_model),
                                                 dtype=cfg.dtype, device="meta")
        return specs
    return {"tokens": torch.empty((b, 1), dtype=torch.int32, device="meta")}


def supports_shape(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Whether (arch, shape) is runnable, and why not."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, (
            "full-attention architecture without a sub-quadratic variant; "
            "long_500k decode skipped (DESIGN.md §5)"
        )
    return True, ""
