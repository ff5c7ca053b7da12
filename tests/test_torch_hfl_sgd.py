"""The paper's main method, ``hfl-selective`` with the default
``server_opt="sgd"``, round by round against the reference at the quick
size (12 sensors, 3 fogs, 3 rounds, E = 1), on four of the eight keys of
0-49 in which a fog cooperates in some round (``rounds_both`` of
``test_torch_hfl.py``: the reference's draws fed to both packages).

The two client phases are not bitwise.  The reference's jitted local SGD
takes XLA's own order of the first layer's product (not the k-order fused
multiply-adds of a PyTorch matmul) and XLA's own tanh approximation, and
no PyTorch op computes either; so an ulp enters some clients' deltas in
every round, and error feedback carries it.  Once in a while it moves a
``v / scale`` across a rounding half-step, and one int8 code of one
client lands on its neighbour: of keys 0-49, key 15 alone, in round 3
(:func:`test_key_15_parts_by_one_int8_code`).  The rounds are therefore
pinned under the settled int8 rule of the round pins
(``test_torch_drift.assert_rounds_match_up_to_code_flips``: at most two
coordinates of a round's params one quantisation step apart, the rest and
every metric at ``TOL``).
"""
import jax
import numpy as np
import pytest
import torch
from test_torch_drift import assert_rounds_match_up_to_code_flips
from test_torch_hfl import TOL, data, jax_cfg, rounds_both, torch_cfg  # noqa: F401
from torch_parity import one_intra_op_thread  # noqa: F401

from repro.core import aggregation as jagg
from repro_torch.core import aggregation as tagg
from repro_torch.core import compression as tcomp
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.models import autoencoder as tae

COOP_KEYS = (1, 12, 15, 29)   # fogs cooperate in round 1 / rounds 2-3 / round 3 / every round
FLIP_KEY = 15


@pytest.fixture(scope="module")
def recorded(data):  # noqa: F811
    """``rounds_both`` at ``FLIP_KEY`` with each round's compressor inputs
    recorded on both sides: (result, {"ref": [...], "port": [...]}), one
    (deltas, err, fog ids, weights, new_err) entry a round."""
    seen = {"ref": [], "port": []}
    ref_plain, port_plain = jagg.compress_and_accumulate, tagg.compress_and_aggregate

    def ref_recorded(deltas, err, fog_id, weights, n_fog, cfg, chunk=None):
        out = ref_plain(deltas, err, fog_id, weights, n_fog, cfg, chunk=chunk)
        jax.debug.callback(lambda *xs: seen["ref"].append([np.asarray(x) for x in xs]),
                           deltas, err, fog_id, weights, out[2])
        return out

    def port_recorded(*args, **kw):
        out = port_plain(*args, **kw)
        seen["port"].append([t.clone().numpy() for t in (*args[:4], out[2])])
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jagg, "compress_and_accumulate", ref_recorded)
        mp.setattr(tagg, "compress_and_aggregate", port_recorded)
        # Not through the compile-once cache: the patched reference must
        # compile here, and the cache's step must not record.
        both = rounds_both(data, FLIP_KEY, jax_cfg(), torch_cfg(), cached=False)
    return both, seen


@pytest.mark.parametrize("key", COOP_KEYS)
def test_sgd_rounds_match_jax(data, recorded, key):  # noqa: F811
    both = recorded[0] if key == FLIP_KEY else rounds_both(data, key, jax_cfg(), torch_cfg())
    assert_rounds_match_up_to_code_flips(both)
    assert int(np.sum(np.asarray(both[0].coop_links))) > 0      # a fog cooperates


def test_key_15_parts_by_one_int8_code(recorded):
    """Rounds 1-2 hold at ``TOL``; round 3 parts at one coordinate, where
    one client's ``v / scale`` lies within 1e-3 of a half-integer on both
    sides and the two codes are neighbours: the params move by that
    client's quantisation step times its share of the gateway's weight."""
    (_, rounds_j, _, rounds_t, _), seen = recorded
    assert len(seen["ref"]) == len(seen["port"]) == 3
    for r in (0, 1):
        np.testing.assert_allclose(tae.ravel(rounds_t[r]).numpy(),
                                   tae.ravel(rounds_j[r]).numpy(), **TOL)
    want, got = tae.ravel(rounds_j[2]).numpy(), tae.ravel(rounds_t[2]).numpy()
    (c,) = np.flatnonzero(~np.isclose(got, want, **TOL))
    (dj, ej, _, _, nj), (dt, et, fog_t, w_t, nt) = seen["ref"][2], seen["port"][2]
    (i,) = np.flatnonzero(np.abs(nj[:, c] - nt[:, c]) > 1e-6)
    k = kops.block_k(tcomp.blockwise_k_frac(dt.shape[1], 0.05))
    codes, steps = [], []
    for delta, err in ((dj, ej), (dt, et)):
        q, scale, _ = kref.compress_ref(torch.from_numpy(delta[i:i + 1].copy()),
                                        torch.from_numpy(err[i:i + 1].copy()), k)
        s = float(scale[0, c // kops.BLOCK_ELEMS])
        half = (float(delta[i, c]) + float(err[i, c])) / s
        assert abs(abs(half - np.trunc(half)) - 0.5) < 1e-3, half
        codes.append(int(q[0, c]))
        steps.append(s)
    assert abs(codes[0] - codes[1]) == 1, codes
    assert steps[0] == steps[1]
    share = float(w_t[i]) / float(np.sum(w_t))
    np.testing.assert_allclose(abs(got[c] - want[c]), steps[0] * share, rtol=1e-3)
    assert fog_t[i] >= 0
