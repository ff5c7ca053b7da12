"""Hierarchical federated learning main loop (paper Algorithm 1).

A round is a Python function over tensors that stay on one device:
Gauss-Markov fog mobility, nearest-feasible-fog association, the
cooperation decision, the client phase (``optim/sgd.make_client_solver``:
the ``local_train_f32`` kernel on the card), the fault layer
(``core/faults``: crashes, Byzantine corruption, erasures), compression
and the fog reduce (``core/aggregation``): the weighted mean fused with
compression (the ``fused_agg`` kernel on the card, or ``wire_emit`` and
``wire_agg`` chunk by chunk with ``client_chunk``; with ``fused=False`` or
quantise-only ``rho_s = 1``, per client by ``compress_q8`` or ``topk_ef``,
then a dense fog sum) or the Byzantine-robust trimmed mean / median
(``robust_agg``), cooperative mixing (Eq. 15), the
gateway step (Eq. 16, optionally FedAdam) and the energy / latency /
battery accounting (Eqs. 17-21).  With the drift layer on
(``HFLConfig.drift``, ``core/drift``) the sensors ride a current after the
fog walk, the sensor->fog assignment is refreshed only every
``reassoc_every`` rounds and the training windows scale by ``1 +
covariate_shift * t``.  :func:`train` loops the round over the rounds.

Randomness is an argument: :class:`RoundDraws` holds every round's
mobility noise, minibatch index table and, with faults on, the crash and
erasure uniforms and the Byzantine noise; :func:`draw_rounds` makes them
from a ``torch.Generator`` in a fixed order, so a run on the card and one
on the CPU see identical inputs, and a test can hand both packages the
reference's own draws.  Drift draws nothing.  The client mesh is not
ported yet: ``client_mesh`` raises.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core import aggregation as agg
from repro_torch.core import association as assoc
from repro_torch.core import channel as ch
from repro_torch.core import compression as comp
from repro_torch.core import cooperation as coop
from repro_torch.core import drift as drf
from repro_torch.core import energy as en
from repro_torch.core import faults as flt
from repro_torch.core import topology as topo
from repro_torch.data.pipeline import multi_epoch_indices
from repro_torch.data.synthetic import SensorDataset
from repro_torch.models import autoencoder as ae
from repro_torch.optim import server as srv
from repro_torch.optim.sgd import LocalTrainConfig, make_client_solver

Params = Any
LossFn = Callable[[Params, torch.Tensor], torch.Tensor]

UNPORTED_MESH = "client_mesh (sharded client axis) is not ported yet (ROADMAP.md queue 1 item 15)"


@dataclasses.dataclass(frozen=True)
class HFLConfig:
    """Round-loop configuration: the reference's fields."""

    rule: coop.CoopRule = coop.CoopRule.SELECTIVE
    rounds: int = 20
    local_epochs: int = 5            # E
    batch_size: int = 32
    lr: float = 0.01                 # eta
    prox_mu: float = 0.0             # >0 => FedProx local solver
    server_opt: str = "sgd"          # "sgd" (FedAvg identity) | "adam" (FedAdam [34])
    server_lr: float = 1e-2
    local_solver: LocalTrainConfig = LocalTrainConfig()
    compressor: comp.CompressorConfig = comp.CompressorConfig()
    fog_mobility: bool = True
    compute_rate_flops: float = 1e8  # embedded-DSP local compute rate
    channel: ch.ChannelParams = ch.ChannelParams()
    energy: en.EnergyParams = en.EnergyParams()
    deployment: topo.DeploymentParams = topo.DeploymentParams()
    robust: str = "mean"             # fog reduce: mean | trimmed | median
    trim_frac: float = 0.0           # weight fraction cut per end (trimmed)
    faults: flt.FaultConfig = flt.FaultConfig()
    drift: drf.DriftConfig = drf.DriftConfig()
    # Compress and accumulate the client axis this many sensors at a time
    # (transient memory follows the chunk, not the fleet); None or >= N is
    # the one-shot path.
    client_chunk: int | None = None

    def __post_init__(self) -> None:
        if self.robust not in ("mean", "trimmed", "median"):
            raise ValueError(f"robust must be 'mean', 'trimmed' or 'median', got {self.robust!r}")
        if not 0.0 <= self.trim_frac < 0.5:
            raise ValueError("trim_frac cuts a weight fraction from EACH end and must be in "
                             f"[0, 0.5), got {self.trim_frac!r}")
        cc = self.client_chunk
        if cc is not None and (not isinstance(cc, int) or cc < 1):
            raise ValueError(f"client_chunk must be None or a positive int, got {cc!r}")

    def replace(self, **kw: Any) -> "HFLConfig":
        return dataclasses.replace(self, **kw)


class RoundMetrics(NamedTuple):
    loss: torch.Tensor
    e_s2f: torch.Tensor          # Eq. 17
    e_f2f: torch.Tensor          # Eq. 18
    e_f2g: torch.Tensor          # Eq. 19
    e_total: torch.Tensor        # Eq. 20
    latency_s: torch.Tensor      # Eq. 21
    participation: torch.Tensor
    coop_links: torch.Tensor     # number of active fog-to-fog exchanges
    battery_min: torch.Tensor
    n_nonfinite: torch.Tensor    # delivered deltas carrying NaN/Inf (zeroed)
    n_erased: torch.Tensor       # transmitted packets lost to erasure
    global_finite: torch.Tensor  # bool — global params finite after the round


class HFLState(NamedTuple):
    params: Params               # global model theta^t (views of one flat vector)
    err: torch.Tensor            # (N, d) error-feedback buffers
    battery: torch.Tensor        # (N,) residual energy
    dep: topo.Deployment
    server: srv.ServerOptState   # gateway optimiser state (FedAdam)
    prev_delta: torch.Tensor     # (d,) last global delta (adaptive colluders)
    # Drift carry (unused with drift off; round 0 always refreshes it):
    assoc_fog: torch.Tensor      # (N,) int32 frozen sensor->fog assignment
    assoc_ok: torch.Tensor       # (N,) bool, feasible at assignment time
    t: int = 0                   # round counter, on the host


class RoundDraws(NamedTuple):
    """Per-round random inputs, stacked over the rounds.  The fault
    draws are None when the fault layer is off (``byz_noise`` also unless
    ``byz_mode == "gauss"``)."""

    mobility: torch.Tensor       # (T, M, 3) f32 standard-normal Gauss-Markov noise
    batches: torch.Tensor        # (T, N, steps, bs) int32 minibatch index tables
    crash: torch.Tensor | None = None       # (T, N) f32 uniforms
    erase: torch.Tensor | None = None       # (T, N) f32 uniforms
    byz_noise: torch.Tensor | None = None   # (T, N, d) f32 standard normals

    def to(self, device: torch.device | str) -> "RoundDraws":
        return RoundDraws(*(None if t is None else t.to(device) for t in self))

    def round(self, t: int) -> tuple:
        """Round ``t``'s draws, in :func:`make_round_fn`'s argument order."""
        return tuple(None if x is None else x[t] for x in self)


def draw_rounds(
    generator: torch.Generator, cfg: HFLConfig, n_clients: int, window: int,
    d: int | None = None,
) -> RoundDraws:
    """Every round's draws from ``generator`` (CPU), in this order: per
    round t, ``randn(M, 3)`` mobility noise, the clients' index tables
    (``data/pipeline.multi_epoch_indices``), then, only with the fault
    layer on, ``rand(N)`` crash and ``rand(N)`` erasure uniforms and, for
    ``byz_mode="gauss"``, ``randn(N, d)`` Byzantine noise (``d`` = the
    flat parameter count).  With faults off a trial draws exactly what
    it drew before the fault layer existed."""
    if cfg.rounds < 1:
        raise ValueError(f"a trial needs at least one round, got {cfg.rounds}")
    faults = cfg.faults.is_active
    gauss = faults and cfg.faults.byz_mode == "gauss"
    if gauss and d is None:
        raise ValueError("byz_mode='gauss' needs the flat parameter count d")
    noise, batches, crash, erase, byz = [], [], [], [], []
    for _ in range(cfg.rounds):
        noise.append(torch.randn((cfg.deployment.n_fog, 3), generator=generator))
        batches.append(multi_epoch_indices(
            generator, n_clients, window, cfg.batch_size, cfg.local_epochs
        ))
        if faults:
            crash.append(torch.rand((n_clients,), generator=generator))
            erase.append(torch.rand((n_clients,), generator=generator))
        if gauss:
            byz.append(torch.randn((n_clients, d), generator=generator))
    return RoundDraws(*(torch.stack(xs) if xs else None
                        for xs in (noise, batches, crash, erase, byz)))


def init_state(params: Params, dep: topo.Deployment, cfg: HFLConfig) -> HFLState:
    flat = ae.ravel(params)
    n = cfg.deployment.n_sensors
    dev = flat.device
    return HFLState(
        params=ae.unravel(flat.clone(), params),
        err=torch.zeros((n, flat.shape[0]), dtype=flat.dtype, device=dev),
        battery=torch.full((n,), cfg.energy.e_init_j, dtype=torch.float32, device=dev),
        dep=dep,
        server=srv.init_state(flat.shape[0], dev),
        prev_delta=torch.zeros_like(flat),
        assoc_fog=torch.zeros((n,), dtype=torch.int32, device=dev),
        assoc_ok=torch.zeros((n,), dtype=torch.bool, device=dev),
    )


def comm_latency_s(
    l_u: float,
    l_full: float,
    active: torch.Tensor,
    sensor_dist_m: torch.Tensor,
    decision: coop.CoopDecision,
    fog_active: torch.Tensor,
    fog_gateway_dist_m: torch.Tensor,
    channel: ch.ChannelParams,
) -> torch.Tensor:
    """Eq. 21 communication term: the slowest active parallel link per
    tier (sensor->fog uplink, fog<->fog exchange, fog->gateway).  The
    fog-to-fog tier masks on ``cooperates & fog_active``, like the Eq. 18
    energy term: an empty fog has no model to exchange."""
    lat_up = torch.amax(torch.where(active, en.link_latency_s(l_u, sensor_dist_m, channel), 0.0))
    lat_ff = torch.amax(torch.where(
        decision.cooperates & fog_active,
        en.link_latency_s(l_full, decision.dist_m, channel), 0.0,
    ))
    lat_fg = torch.amax(torch.where(
        fog_active, en.link_latency_s(l_full, fog_gateway_dist_m, channel), 0.0
    ))
    return torch.maximum(torch.maximum(lat_up, lat_ff), lat_fg)


def make_round_fn(
    loss_fn: LossFn,
    ds: SensorDataset,
    cfg: HFLConfig,
    *,
    client_mesh: Any = None,
) -> Callable[[HFLState, torch.Tensor, torch.Tensor], tuple[HFLState, RoundMetrics]]:
    """Build ``round_fn(state, mobility (M, 3), batches (N, steps, bs))
    -> (state, metrics)``, one round of Algorithm 1 on ``ds``'s device;
    with the fault layer on it also takes the round's ``crash`` and
    ``erase`` uniforms (N,) and, for ``gauss``, ``byz_noise`` (N, d)."""
    if client_mesh is not None:
        raise NotImplementedError(UNPORTED_MESH)
    n_fog = cfg.deployment.n_fog
    fl = cfg.faults
    fault_on = fl.is_active          # off: exactly the fault-free round
    dr = cfg.drift
    drift_on = dr.is_active          # off: exactly the drift-free round
    cadence = np.float32(max(dr.reassoc_every, 1.0))
    adaptive = fault_on and fl.byz_mode == "adaptive"
    clients_fn = make_client_solver(
        loss_fn, batch_size=cfg.batch_size, epochs=cfg.local_epochs,
        lr=cfg.lr, prox_mu=cfg.prox_mu, solver=cfg.local_solver,
    )
    n, window, dim = ds.train.shape
    # As in the reference, the compute cost counts the paper's hidden widths.
    flops = en.autoencoder_flops(dim, (16, 8, 16), window, cfg.local_epochs)
    lat_comp = flops / cfg.compute_rate_flops
    e_comp = float(en.compute_energy_j(flops, cfg.energy))   # the f32 value, on the host

    def round_fn(state: HFLState, mobility: torch.Tensor, batches: torch.Tensor,
                 crash: torch.Tensor | None = None, erase: torch.Tensor | None = None,
                 byz_noise: torch.Tensor | None = None):
        if fault_on and (crash is None or erase is None):
            raise ValueError("the fault layer needs the round's crash and erasure uniforms")
        dep = state.dep
        if cfg.fog_mobility:
            dep = topo.gauss_markov_step(mobility, dep, cfg.deployment)
        if drift_on:
            dep = topo.current_advection_step(dep, cfg.deployment, dr.sensor_current_m_s)

        # --- 1. association + cooperation decisions (lines 1-7) ----------
        assoc_fog, assoc_ok = state.assoc_fog, state.assoc_ok
        if drift_on:
            # Stale assignment, live physics: the carried assignment is
            # refreshed every ``reassoc_every`` rounds (round 0 always), in
            # the reference's f32 arithmetic, decided on the host.
            if np.mod(np.float32(state.t), cadence) < 0.5:
                fresh = assoc.nearest_feasible_fog(dep, cfg.channel)
                assoc_fog, assoc_ok = fresh.fog_id, fresh.participates
            fa = assoc.assigned_fog_association(dep, cfg.channel, assoc_fog, assoc_ok)
        else:
            fa = assoc.nearest_feasible_fog(dep, cfg.channel)
        alive = state.battery > cfg.energy.e_min_j
        active = fa.participates & alive
        if fault_on:
            # Crashed clients drop out like a dead battery: no training, no
            # transmission, no energy this round.
            active = active & ~flt.draw_crash(crash, fl.crash_prob)
        # Cooperation sees round-active cluster sizes (battery included).
        c_active = torch.zeros((n_fog,), dtype=torch.int32, device=active.device)
        c_active.index_add_(0, fa.fog_id.long(), active.to(torch.int32))
        decision = coop.decide(cfg.rule, dep.fog_pos, c_active, cfg.channel)

        # --- 2+3. local training, fused compression + fog sums -----------
        flat0 = ae.ravel(state.params)
        d = flat0.shape[0]
        active_f = active.to(torch.float32)
        # Erasure strikes after the SNR gate: the packet was sent (energy
        # charged below, EF buffer advances), only its weight vanishes.
        if fault_on:
            erased = active & flt.draw_erasure(erase, fl.erasure_prob)
        else:
            erased = torch.zeros_like(active)
        delivered = active & ~erased
        weights = ds.n_samples * delivered.to(torch.float32)
        deltas, losses = clients_fn(state.params, train_windows(ds, cfg, state.t), batches)
        if fault_on:
            deltas = flt.corrupt_deltas(deltas, fl, prev_delta=state.prev_delta, noise=byz_noise)
        n_nonfinite = torch.sum(delivered & flt.nonfinite_rows(deltas))
        if cfg.robust == "mean":
            fog_sum, fog_weight, new_err = agg.compress_and_accumulate(
                deltas, state.err, fa.fog_id, weights, n_fog, cfg.compressor,
                chunk=cfg.client_chunk,
            )
            fog_delta = fog_sum / torch.clamp_min(fog_weight, 1e-12)[:, None]
        else:
            fog_delta, fog_weight, new_err = agg.robust_compress_and_aggregate(
                deltas, state.err, fa.fog_id, weights, n_fog, cfg.compressor,
                cfg.trim_frac, cfg.robust, chunk=cfg.client_chunk,
            )
        # Non-participants keep their error buffer and contribute nothing.
        new_err = torch.where(active[:, None], new_err, state.err)

        fog_model = fog_delta + flat0[None, :]                 # theta_m^{t+1/2}
        mixed = agg.cooperative_mix(fog_model, decision)       # Eq. 15

        # --- 4. global aggregation (Eq. 16, lines 19-21) -----------------
        new_flat = agg.global_aggregate(mixed, fog_weight, prev=flat0)
        server = state.server
        if cfg.server_opt == "adam":
            incr, server = srv.adam_update(new_flat - flat0, state.server, lr=cfg.server_lr)
            new_flat = flat0 + incr
        new_params = ae.unravel(new_flat, state.params)

        # --- 5. energy / latency / battery accounting --------------------
        l_u = comp.payload_bits(d, cfg.compressor)           # sensor uplink bits
        l_full = 32.0 * d                                    # fog exchanges, dense
        e_up = torch.where(active, en.tx_energy_j(l_u, fa.dist_m, cfg.channel, cfg.energy), 0.0)
        e_s2f = torch.sum(e_up)
        fog_active = fog_weight > 0
        e_ff = en.tx_energy_j(l_full, decision.dist_m, cfg.channel, cfg.energy)
        e_f2f = torch.sum(torch.where(decision.cooperates & fog_active, e_ff, 0.0))
        e_fg = en.tx_energy_j(l_full, fa.fog_gateway_dist_m, cfg.channel, cfg.energy)
        e_f2g = torch.sum(torch.where(fog_active & fa.fog_gateway_feasible, e_fg, 0.0))
        lat_comm = comm_latency_s(
            l_u, l_full, active, fa.dist_m, decision, fog_active,
            fa.fog_gateway_dist_m, cfg.channel,
        )
        spent = e_up + torch.where(active, e_comp, 0.0)
        battery, _ = en.battery_step(state.battery, spent, cfg.energy)

        metrics = RoundMetrics(
            loss=torch.sum(losses * active_f) / torch.clamp_min(torch.sum(active_f), 1.0),
            e_s2f=e_s2f,
            e_f2f=e_f2f,
            e_f2g=e_f2g,
            e_total=e_s2f + e_f2f + e_f2g,
            latency_s=lat_comm + lat_comp,
            participation=torch.mean(active_f),
            coop_links=torch.sum(decision.cooperates.to(torch.int32)),
            battery_min=torch.amin(battery),
            n_nonfinite=n_nonfinite.to(torch.int32),
            n_erased=torch.sum(erased.to(torch.int32)),
            global_finite=torch.all(torch.isfinite(new_flat)),
        )
        # Adaptive colluders observe the realised global movement.
        prev_delta = new_flat - flat0 if adaptive else state.prev_delta
        return HFLState(new_params, new_err, battery, dep, server, prev_delta,
                        assoc_fog, assoc_ok, state.t + 1), metrics

    return round_fn


def train_windows(ds: SensorDataset, cfg: HFLConfig, t: int) -> torch.Tensor:
    """Round ``t``'s client windows: with the drift layer on, scaled by the
    covariate shift ``1 + covariate_shift * t`` in f32 as the reference
    computes it (a factor of exactly 1 leaves them as they are)."""
    if not cfg.drift.is_active:
        return ds.train
    scale = np.float32(1.0) + np.float32(cfg.drift.covariate_shift) * np.float32(t)
    return ds.train if scale == 1.0 else ds.train * float(scale)


def start(init_params: Params, ds: SensorDataset, cfg: HFLConfig, dep: topo.Deployment,
          draws: RoundDraws) -> tuple[HFLState, RoundDraws]:
    """Check ``draws`` against ``cfg`` and move a trial onto ``ds``'s
    device: (the initial state, the draws there)."""
    if not 1 <= cfg.rounds <= draws.mobility.shape[0]:
        raise ValueError(f"draws cover {draws.mobility.shape[0]} rounds, cfg.rounds={cfg.rounds}")
    if cfg.faults.is_active and (draws.crash is None or draws.erase is None or (
            cfg.faults.byz_mode == "gauss" and draws.byz_noise is None)):
        raise ValueError("the fault layer is on but the draws lack its uniforms or noise "
                         "(draw them with draw_rounds(..., d=...) under the same config)")
    dev = ds.train.device
    params = [{k: v.to(dev) for k, v in layer.items()} for layer in init_params]
    return init_state(params, dep.to(dev), cfg), draws.to(dev)


def stack_metrics(per_round: list[RoundMetrics]) -> RoundMetrics:
    """Per-round metrics stacked over the rounds."""
    return RoundMetrics(*(torch.stack(v) for v in zip(*per_round)))


def train(
    init_params: Params,
    loss_fn: LossFn,
    ds: SensorDataset,
    cfg: HFLConfig,
    dep: topo.Deployment,
    draws: RoundDraws,
    *,
    client_mesh: Any = None,
    store: Any | None = None,
    publish_every: int = 1,
    publish_offset: int = 0,
) -> tuple[Params, RoundMetrics]:
    """Run T federated rounds; returns (final params, metrics stacked over
    rounds).  Everything runs on the device of ``ds``; ``dep`` and
    ``draws`` (see :func:`draw_rounds`) are moved there once.

    With ``store`` (a ``checkpoint.CheckpointStore``) the loop publishes
    the global params every ``publish_every`` rounds (step = round index +
    ``publish_offset``; the final round always publishes), which is what
    the serving hot-swap watches.
    """
    state, draws = start(init_params, ds, cfg, dep, draws)
    round_fn = make_round_fn(loss_fn, ds, cfg, client_mesh=client_mesh)
    per_round = []
    for t in range(cfg.rounds):
        state, m = round_fn(state, *draws.round(t))
        per_round.append(m)
        if store is not None and ((t + 1) % publish_every == 0 or t + 1 == cfg.rounds):
            store.publish(publish_offset + t + 1, state.params)
    return state.params, stack_metrics(per_round)
