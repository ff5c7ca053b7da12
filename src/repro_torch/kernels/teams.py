"""The teams of the selecting kernels (``csrc/block_select.cuh``):
``fused_agg``'s select, ``wire_emit``, ``compress_q8`` and ``topk_ef``.

Each (client, 8192-element block) is selected by a team sized to the
block's real width: ``SMALL_TEAM`` threads (two warps) for a block up to
``SMALL_WIDTH`` wide, which only a row's last block can be, else a block
team of ``TEAM_THREADS``.  :func:`compress_plan` lays the teams of N rows
out on the card's SMs, the same for every selecting kernel.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.kernels.ref import BLOCK_ELEMS   # kBlock in csrc/block_select.cuh

SMALL_WIDTH = 2048         # kSmallWidth in csrc/block_select.cuh: a small team's widest block
SMALL_TEAM = 64            # kNarrowTeam there: a small team's threads
SMALL_SLOTS = (8, 16, 24, 32)   # its kernels' slots a thread, SMALL_TEAM * slots held
TEAM_THREADS = 256         # kThreads: a block team, and the block of a launch

_n_sm: dict[int, int] = {}  # device index -> SM count


class TeamPlan(NamedTuple):
    """A selecting launch's teams: N * n_wide blocks of block teams, then
    narrow_grid blocks of ``teams`` small teams of ``slots`` slots a
    thread."""
    n_wide: int        # blocks of each row run by a block team (the first ones)
    slots: int         # slots a thread of a small team (SMALL_SLOTS[0] when there is none)
    teams: int         # small teams a block (1 when there is none)
    narrow_grid: int   # blocks of small teams (0: the last block is wide too)


def team_threads(width: int) -> int:
    """Threads of the team that selects a block of ``width`` real columns."""
    return SMALL_TEAM if width <= SMALL_WIDTH else TEAM_THREADS


@functools.lru_cache(maxsize=256)
def compress_plan(n: int, d: int, n_sm: int) -> TeamPlan:
    """The selection's teams for N = ``n`` rows of ``d`` on ``n_sm`` SMs.
    Only a row's last block can be narrower than ``BLOCK_ELEMS``; when it
    is at most ``SMALL_WIDTH`` wide it goes to a small team, each thread
    holding the fewest of ``SMALL_SLOTS`` slots that cover the width, and
    a launch packs as many small teams a block (a power of two up to
    ``TEAM_THREADS // SMALL_TEAM``) as keep one block per SM or more.
    Every other block goes to a block team."""
    nb = -(-d // BLOCK_ELEMS)
    tail = d - (nb - 1) * BLOCK_ELEMS
    if team_threads(tail) != SMALL_TEAM:
        return TeamPlan(nb, SMALL_SLOTS[0], 1, 0)
    slots = next(s for s in SMALL_SLOTS if SMALL_TEAM * s >= tail)
    teams = TEAM_THREADS // SMALL_TEAM
    while teams > 1 and -(-n // teams) < n_sm:
        teams //= 2
    return TeamPlan(nb - 1, slots, teams, -(-n // teams))


def sm_count(device: torch.device) -> int:
    n_sm = _n_sm.get(device.index)
    if n_sm is None:
        n_sm = torch.cuda.get_device_properties(device).multi_processor_count
        _n_sm[device.index] = n_sm
    return n_sm
