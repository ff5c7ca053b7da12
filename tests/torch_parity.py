"""Shared pieces of the port's CPU parity tests (``tests/test_torch_*.py``).
pytest does not collect this module: its name does not match ``test_*.py``.

- :func:`one_intra_op_thread`: a port test file imports it, and pytest
  takes the autouse fixture from the module's globals.  Most of the port's
  CPU work is thousands of small eager ops; beside the other workers of a
  parallel run, torch's intra-op threads only wait for cores.
- :func:`reference_rounds`: the reference's round step compiled once per
  (loss, dataset, config).  ``repro.core.hfl.train(..., store=)`` builds
  and jits a new round closure on every call, so calling it for every key
  of one config compiles the same round for each.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hfl as jhfl


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """One PyTorch intra-op thread for the module, the old count after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class ReferenceRounds:
    """``repro.core.hfl.train(key, params, loss_fn, ds, cfg, store=)``'s
    loop (``src/repro/core/hfl.py:563-587``) over one jitted round step.

    The config stays closed over as constants, as in the reference: a
    config passed as a traced argument moves the jit boundary, and with it
    XLA's contraction of products and sums into fused multiply-adds.
    ``traces`` counts the step's traces, one a compile: two a config, as
    round 1's input state (``init_state``'s) has a weakly typed battery."""

    def __init__(self, loss_fn, ds, cfg):
        assert cfg.rounds > 0, "the reference scans a 0-round train"
        round_fn = jhfl.make_round_fn(loss_fn, ds, cfg)

        def step(s):
            self.traces += 1
            return round_fn(s, None)

        self.ds, self.cfg, self.traces = ds, cfg, 0
        self.step = jax.jit(step, donate_argnums=0)

    def run(self, key, init_params):
        """(final params, stacked metrics, each round's params on the host)."""
        state = jhfl.init_state(key, init_params, self.cfg)
        # The first donated call would invalidate the caller's params.
        state = state._replace(params=jax.tree_util.tree_map(jnp.copy, state.params))
        per_round, rounds_metrics = [], []
        for _ in range(self.cfg.rounds):
            state, m = self.step(state)
            rounds_metrics.append(m)
            per_round.append(jax.tree_util.tree_map(np.array, state.params))
        metrics = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *rounds_metrics)
        return state.params, metrics, per_round


_CACHE = {}


def reference_rounds(loss_fn, ds, cfg):
    """The process's :class:`ReferenceRounds` for (``loss_fn``, ``ds``,
    ``cfg``).  The dataset is keyed by identity (the entry holds it, so the
    id stays its own), the config by value."""
    key = (loss_fn, id(ds), cfg)
    if key not in _CACHE:
        _CACHE[key] = ReferenceRounds(loss_fn, ds, cfg)
    return _CACHE[key]
