"""Flat-npz pytree checkpointing, key-compatible with ``repro.checkpoint``.

Keys are the key paths that ``jax.tree_util.keystr`` gives (``[0]['b']``
for layer 0's bias), built here without JAX, so either package loads the
other's rounds.  Trees are nests of lists, tuples and dicts (keys sorted,
as JAX flattens them) over tensor or array leaves.  ``CheckpointStore``
adds step management (latest, retention) for the trainer and the serving
hot-swap; ``save`` is atomic — the payload is staged to a unique temp file
in the same directory, fsynced, and ``os.replace``d into place — so a
concurrent reader never observes a half-written round.
"""
from __future__ import annotations

import os
import re
import tempfile
from typing import Any, Callable

import numpy as np
import torch


def _walk(tree: Any, prefix: str, visit: Callable[[str, Any], Any]) -> Any:
    """Rebuild ``tree`` with ``visit(keystr, leaf)`` at every leaf."""
    if isinstance(tree, dict):
        return {k: _walk(tree[k], f"{prefix}[{k!r}]", visit) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        out = [_walk(v, f"{prefix}[{i}]", visit) for i, v in enumerate(tree)]
        return out if isinstance(tree, list) else tuple(out)
    return visit(prefix, tree)


def _host(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree: Any) -> dict[str, np.ndarray]:
    flat: dict[str, np.ndarray] = {}
    _walk(tree, "", lambda key, leaf: flat.__setitem__(key, _host(leaf)))
    return flat


def save_pytree(path: str, tree: Any) -> None:
    """Atomically write ``tree`` to ``path`` (tmp file + ``os.replace``).

    The temp name is unique per call (no collision between concurrent
    writers of the same step) and lives in the target directory, so the
    final rename stays within one filesystem and is atomic.
    """
    directory = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=directory, prefix=".inflight-", suffix=".npz")
    try:
        with os.fdopen(fd, "wb") as f:
            # A file object keeps np.savez from appending ".npz" to the name.
            np.savez(f, **_flatten(tree))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def load_pytree(path: str, like: Any) -> Any:
    """Load into the structure of ``like``.  Each leaf comes back as a
    tensor on the device of ``like``'s leaf (the CPU for array leaves)."""
    with np.load(path) as data:
        def visit(key: str, ref: Any) -> torch.Tensor:
            if key not in data:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            arr = data[key]
            if tuple(arr.shape) != tuple(ref.shape):
                raise ValueError(
                    f"shape mismatch at {key!r}: {arr.shape} vs {tuple(ref.shape)}"
                )
            dev = ref.device if isinstance(ref, torch.Tensor) else "cpu"
            return torch.from_numpy(arr).to(dev)

        return _walk(like, "", visit)


class CheckpointStore:
    """Step-indexed checkpoints under one directory, keeping the last K."""

    _FMT = "step_{:08d}.npz"
    _RE = re.compile(r"step_(\d+)\.npz$")

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, self._FMT.format(step))

    def steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.directory):
            m = self._RE.match(name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, tree: Any) -> str:
        path = self._path(step)
        save_pytree(path, tree)
        for old in self.steps()[: -self.keep]:
            try:
                os.remove(self._path(old))
            except FileNotFoundError:
                pass  # a concurrent writer's retention pass got there first
        return path

    def restore(self, like: Any, step: int | None = None) -> tuple[Any, int]:
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        return load_pytree(self._path(step), like), step

    # Serving-facing aliases: the train loop *publishes* rounds, the
    # service reads back the *latest* — see serving/service.ScoringService.
    def publish(self, step: int, tree: Any) -> str:
        return self.save(step, tree)

    def latest(self, like: Any) -> tuple[Any, int]:
        return self.restore(like)
