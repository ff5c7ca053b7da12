"""Event-driven asynchronous federated rounds with staleness-aware merging.

The fourth round-loop family next to ``core/hfl.py`` (synchronous
hierarchical) and ``core/flat_fl.py`` (star topology).  Eq. 21 latency
spreads widely across acoustic links, so a synchronous round is paced by
the slowest feasible path; here each client's update travels for its own
path latency, a bounded buffer triggers the global merge when
``buffer_k`` updates have landed (or ``timeout_s`` passes), and late
updates merge with the staleness weight ``w(tau) = (1 + tau)^(-alpha)``,
``tau`` the global versions the update missed.

An event (one fog tick, :func:`make_event_fn`) runs, in order:

* **Launch**: an idle, active client pulls the current global params,
  trains (``optim/sgd.make_client_solver``: ``local_train_f32`` on the
  card) and compresses with one identity segment per client
  (``aggregation.client_compress``: ``fused_agg``, or the per-client
  compressor), so its reconstruction stays addressable on the wire.  It
  lands ``compute + uplink latency`` simulated seconds later (or after the
  replayed ``arrival_delay_s``); uplink and compute energy are charged at
  launch.
* **Fog tick**: the clock moves to the ``fog_k``-th arrival in flight (a
  sort and a gather), or the fog timeout; arrivals (less the erased ones)
  fold into per-fog buffers with their staleness weight
  (``kernels/ref.segment_sum``), and, for a robust reduce, into per-client
  buffers.
* **Global merge**: when ``buffer_k`` updates are buffered (clamped to
  what can still arrive) or ``timeout_s`` passes, the fog means (or the
  trimmed mean / median of the per-client means, ``robust_agg``) mix
  cooperatively (Eq. 15) and aggregate at the gateway (Eq. 16, FedAdam
  optional); the buffers drain and the version moves if any weight was
  buffered.

The merge is computed every event and selected per trial with
``torch.where``, and the event reads no device value on the host: every
event makes the same launches (one ``local_train_f32``, one
``fused_agg`` call, and one ``robust_agg`` with a robust reduce).  With
``fog_k = buffer_k = N``, ``alpha = 0`` and no timeouts every event is one
round of Algorithm 1 (:func:`sync_limit`, pinned against ``hfl.train``).

B trials run at once as in ``hfl.make_round_fn``: with ``ds`` stacked
(``hfl.stack_datasets``) every state tensor leads with B, the B * N
clients fold into one ``local_train_f32`` launch and one
``client_compress``, and trial b's fogs are b * M .. b * M + M - 1 of the
folded fog axis.  Randomness is an argument: an event takes one
``hfl.RoundDraws`` row (``hfl.draw_rounds`` under :func:`draw_config`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core import aggregation as agg
from repro_torch.core import association as assoc
from repro_torch.core import channel as ch
from repro_torch.core import compression as comp
from repro_torch.core import cooperation as coop
from repro_torch.core import energy as en
from repro_torch.core import faults as flt
from repro_torch.core import hfl
from repro_torch.core import topology as topo
from repro_torch.data.synthetic import SensorDataset
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import segment_sum
from repro_torch.models import autoencoder as ae
from repro_torch.optim import server as srv
from repro_torch.optim.sgd import make_client_solver

Params = Any
LossFn = hfl.LossFn

# "Never" for the timeout knobs: a finite sentinel keeps every arithmetic
# path inf-free while exceeding any simulated time a run can reach.
NEVER_S = 1e30


@dataclasses.dataclass(frozen=True)
class AsyncFLConfig:
    """Async round-family configuration: the reference's fields.

    ``base.rounds`` is ignored; ``n_events`` fog ticks are simulated (in
    the sync limit one tick is one round).  Updates are discounted by
    ``(1 + tau)^(-alpha)`` and dropped (weight 0) beyond ``tau_max``
    versions.  ``arrival_delay_s``: a float adds seconds to the physics
    clock (compute + Eq. 21 uplink latency); an (N,) tensor REPLACES it
    with replayed per-client launch-to-arrival delays (energy stays
    physics-based).

    In a config sweep (``Engine.sweep``) ``buffer_k``, ``fog_k``,
    ``alpha``, the timeouts and ``tau_max`` may be (B,) tensors of
    per-trial values (besides the base config's knobs), and a replayed
    ``arrival_delay_s`` a (B, N) tensor, trial b's delays in row b."""

    base: hfl.HFLConfig = hfl.HFLConfig()
    n_events: int = 40                   # fog ticks to simulate
    buffer_k: float = 8.0                # global merge after this many updates
    fog_k: float = 1.0                   # fog tick fires when this many land
    alpha: float = 0.5                   # staleness exponent in (1+tau)^(-alpha)
    timeout_s: float = NEVER_S           # global merge timeout (sim seconds)
    fog_timeout_s: float = NEVER_S       # fog tick timeout (sim seconds)
    tau_max: float = NEVER_S             # drop updates staler than this
    arrival_delay_s: float | torch.Tensor = 0.0

    def replace(self, **kw: Any) -> "AsyncFLConfig":
        return dataclasses.replace(self, **kw)


def sync_limit(base: hfl.HFLConfig, n_events: int | None = None) -> AsyncFLConfig:
    """The synchronous limiting case: fog tick and merge buffer wait for
    the whole fleet, no staleness discount, no timeouts, so every event is
    one round of Algorithm 1."""
    n = float(base.deployment.n_sensors)
    return AsyncFLConfig(
        base=base, n_events=base.rounds if n_events is None else n_events,
        buffer_k=n, fog_k=n, alpha=0.0, timeout_s=NEVER_S, fog_timeout_s=NEVER_S,
    )


def draw_config(acfg: AsyncFLConfig) -> hfl.HFLConfig:
    """The config whose rounds are the events: ``hfl.draw_rounds`` under it
    draws a trial's events, one ``RoundDraws`` row each."""
    return acfg.base.replace(rounds=acfg.n_events)


class AsyncEventMetrics(NamedTuple):
    """Per-fog-tick record.  The first block mirrors ``hfl.RoundMetrics``
    (term for term in the sync limit); the second is async-specific."""

    loss: torch.Tensor           # mean loss over this tick's launches
    e_s2f: torch.Tensor          # Eq. 17, charged at launch
    e_f2f: torch.Tensor          # Eq. 18, charged at merge
    e_f2g: torch.Tensor          # Eq. 19, charged at merge
    e_total: torch.Tensor        # Eq. 20
    latency_s: torch.Tensor      # Eq. 21-style per-tick latency
    participation: torch.Tensor
    coop_links: torch.Tensor     # active fog-to-fog exchanges (merge ticks)
    battery_min: torch.Tensor
    n_nonfinite: torch.Tensor    # launched deltas carrying NaN/Inf (zeroed)
    n_erased: torch.Tensor       # arrivals lost to packet erasure
    global_finite: torch.Tensor  # bool, global params finite after this tick
    # --- async-specific ---
    merged: torch.Tensor         # bool, did the gateway merge this tick
    n_launched: torch.Tensor     # clients that started a job this tick
    n_arrived: torch.Tensor      # updates that landed this tick
    staleness: torch.Tensor      # mean tau over this tick's arrivals
    event_s: torch.Tensor        # simulated duration of this tick
    t_sim: torch.Tensor          # simulated clock after this tick


class AsyncState(NamedTuple):
    """The event state of one trial, or of B trials run together (every
    tensor then leads with B)."""

    # Shared with the synchronous families:
    params: Params               # global model theta^(v)
    err: torch.Tensor            # (N, d) error-feedback buffers
    battery: torch.Tensor        # (N,) residual energy
    dep: topo.Deployment
    server: srv.ServerOptState   # FedAdam state; its step () per trial, advanced on merges
    # Event-driven extensions:
    version: torch.Tensor        # () int32 global model version v
    t_now: torch.Tensor          # () f32 simulated clock
    t_last_merge: torch.Tensor   # () f32
    pending: torch.Tensor        # () int32 updates buffered since the last merge
    busy: torch.Tensor           # (N,) bool update in flight
    inflight: torch.Tensor       # (N, d) compressed reconstruction on the wire
    arrive_t: torch.Tensor       # (N,) f32 absolute arrival time (NEVER_S idle)
    base_version: torch.Tensor   # (N,) int32 version the job trained from
    uplink_lat: torch.Tensor     # (N,) f32 uplink latency at launch
    launch_fog: torch.Tensor     # (N,) int32 fog the update was sent to
    fog_sum: torch.Tensor        # (M, d) staleness-weighted delta sums
    fog_w: torch.Tensor          # (M,) buffered weight per fog
    fog_n: torch.Tensor          # (M,) int32 buffered update count per fog
    # Per-client buffers of the robust reduce ((N, 0) with the mean):
    cli_sum: torch.Tensor        # (N, d) weighted arrival sums
    cli_w: torch.Tensor          # (N,) accumulated arrival weight
    cli_fog: torch.Tensor        # (N,) int32 fog of the latest arrival
    # Dynamic-world carry (unused with drift and the adaptive attack off):
    assoc_fog: torch.Tensor      # (N,) int32 frozen sensor->fog assignment
    assoc_ok: torch.Tensor       # (N,) bool, feasible at assignment time
    prev_delta: torch.Tensor     # (d,) last global delta (adaptive colluders)
    tick: int = 0                # fog-tick counter, on the host (shared by the trials)


def init_state(params: Params, dep: topo.Deployment, acfg: AsyncFLConfig) -> AsyncState:
    """The first state of one trial, or of B trials from their stacked
    params (layers leading with B) and deployments."""
    cfg = acfg.base
    flat = ae.ravel(params)
    lead, d, dev = tuple(flat.shape[:-1]), flat.shape[-1], flat.device
    n, m = cfg.deployment.n_sensors, cfg.deployment.n_fog

    def zeros(shape, dtype=torch.float32):
        return torch.zeros(lead + shape, dtype=dtype, device=dev)

    server = srv.init_state(tuple(flat.shape), dev)
    return AsyncState(
        params=ae.unravel(flat.clone(), params),
        err=zeros((n, d)),
        battery=hfl.per_client(cfg.energy.e_init_j, lead, n, dev),
        dep=dep,
        server=server._replace(step=zeros((), torch.int32)),
        version=zeros((), torch.int32),
        t_now=zeros(()),
        t_last_merge=zeros(()),
        pending=zeros((), torch.int32),
        busy=zeros((n,), torch.bool),
        inflight=zeros((n, d)),
        arrive_t=torch.full(lead + (n,), NEVER_S, dtype=torch.float32, device=dev),
        base_version=zeros((n,), torch.int32),
        uplink_lat=zeros((n,)),
        launch_fog=zeros((n,), torch.int32),
        fog_sum=zeros((m, d)),
        fog_w=zeros((m,)),
        fog_n=zeros((m,), torch.int32),
        cli_sum=zeros((n, d if cfg.robust != "mean" else 0)),
        cli_w=zeros((n,)),
        cli_fog=zeros((n,), torch.int32),
        assoc_fog=zeros((n,), torch.int32),
        assoc_ok=zeros((n,), torch.bool),
        prev_delta=torch.zeros_like(flat),
    )


def _f32(v: Any) -> Any:
    """A config float as the f32 value the reference computes with; a
    (B,) tensor of per-trial values (f32 already) as it is."""
    return v if isinstance(v, torch.Tensor) else float(np.float32(v))


def make_event_fn(
    loss_fn: LossFn,
    ds: SensorDataset,
    acfg: AsyncFLConfig,
) -> Callable[..., tuple[AsyncState, AsyncEventMetrics]]:
    """Build ``event_fn(state, mobility (M, 3), batches (N, steps, bs),
    crash=None, erase=None, byz_noise=None) -> (state, metrics)``, one fog
    tick on ``ds``'s device, with ``hfl.make_round_fn``'s arguments (the
    fault draws with the fault layer on).  With ``ds`` stacked for B
    trials every argument and metric leads with B, and ``acfg`` may carry
    (B,) knobs (:class:`AsyncFLConfig`), copied to the device once here."""
    dev = ds.train.device
    host = acfg.base                                         # the knobs' host values
    schedule = hfl.reassoc_schedule(host.drift, acfg.n_events, dev)
    acfg = hfl.knobs_to(acfg, dev)
    cfg = acfg.base
    n_fog = cfg.deployment.n_fog
    fl = cfg.faults
    fault_on = fl.is_active
    dr = cfg.drift
    drift_on = dr.is_active
    cadence = None if schedule is not None else np.float32(max(dr.reassoc_every, 1.0))
    adaptive = fault_on and fl.byz_mode == "adaptive"
    robust = cfg.robust != "mean"
    clients_fn = make_client_solver(
        loss_fn, batch_size=cfg.batch_size, epochs=cfg.local_epochs,
        lr=cfg.lr, prox_mu=cfg.prox_mu, solver=cfg.local_solver,
    )
    lead = tuple(ds.train.shape[:-3])                        # () or (B,)
    b_n, (n, window, dim) = math.prod(lead), ds.train.shape[-3:]
    fog_base = torch.arange(b_n, dtype=torch.int32, device=dev)[:, None] * n_fog
    flops = en.autoencoder_flops(dim, (16, 8, 16), window, cfg.local_epochs)
    # The reference's f32 quotient; every clock sum below is in f32, in its order.
    rate = host.compute_rate_flops
    if isinstance(rate, torch.Tensor):
        lat_comp = (torch.tensor(np.float32(flops)) / rate.detach().cpu()).to(dev)
    else:
        lat_comp = _f32(np.float32(flops) / np.float32(rate))
    _, e_comp = hfl.compute_cost(host, flops, dev)
    compressor = comp.per_row(cfg.compressor, n)            # a global rho_s per folded row
    # A float adds to the physics clock; an (N,) or (B, N) tensor replays
    # the whole launch-to-arrival time.
    delay = torch.as_tensor(acfg.arrival_delay_s, dtype=torch.float32)
    replay = delay.dim() > 0
    delay = delay.to(dev) if replay else _f32(delay)
    fog_k = (torch.clamp_min(acfg.fog_k, 1.0) if isinstance(acfg.fog_k, torch.Tensor)
             else max(_f32(acfg.fog_k), 1.0))
    buffer_k, alpha = _f32(acfg.buffer_k), _f32(acfg.alpha)
    timeout_s, fog_timeout_s, tau_max = (_f32(acfg.timeout_s), _f32(acfg.fog_timeout_s),
                                         _f32(acfg.tau_max))

    def upto(x: torch.Tensor, cap: Any) -> torch.Tensor:
        """``x`` clamped from above by a number or a (B,) knob."""
        return torch.minimum(x, cap) if isinstance(cap, torch.Tensor) else torch.clamp(x, max=cap)

    def folded(ids: torch.Tensor) -> torch.Tensor:
        """Fog ids (..., N) on the folded fog axis of B * M fogs, flat."""
        return (ids + fog_base if b_n > 1 else ids).reshape(-1)

    def fold(x: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """Per-fog sums of the per-client rows x (..., N, ...) of every
        trial: (..., M, ...)."""
        rest = tuple(x.shape[len(lead) + 1:])
        out = segment_sum(x.reshape((b_n * n,) + rest), folded(ids), b_n * n_fog)
        return out.view(lead + (n_fog,) + rest)

    def event_fn(state: AsyncState, mobility: torch.Tensor, batches: torch.Tensor,
                 crash: torch.Tensor | None = None, erase: torch.Tensor | None = None,
                 byz_noise: torch.Tensor | None = None):
        if fault_on and (crash is None or erase is None):
            raise ValueError("the fault layer needs the event's crash and erasure uniforms")
        dep = state.dep
        if cfg.fog_mobility:
            dep = topo.gauss_markov_step(mobility, dep, cfg.deployment)
        if drift_on:
            dep = topo.current_advection_step(dep, cfg.deployment, dr.sensor_current_m_s)

        # --- association: who could launch / deliver this tick -----------
        assoc_fog, assoc_ok = state.assoc_fog, state.assoc_ok
        if drift_on:
            # The re-association cadence counts fog ticks (tick 0 always
            # refreshes), decided on the host in the reference's f32.
            assoc_fog, assoc_ok = hfl.refresh_assoc(dep, cfg.channel, schedule, cadence,
                                                    state.tick, assoc_fog, assoc_ok)
            fa = assoc.assigned_fog_association(dep, cfg.channel, assoc_fog, assoc_ok)
        else:
            fa = assoc.nearest_feasible_fog(dep, cfg.channel)
        alive = state.battery > ch.per_trial(cfg.energy.e_min_j, state.battery)
        active = fa.participates & alive
        if fault_on:
            # A crashed client cannot launch; what it already sent travels on.
            active = active & ~flt.draw_crash(crash, fl.crash_prob)
        active_f = active.to(torch.float32)
        flat0 = ae.ravel(state.params)                          # (..., d)
        d = flat0.shape[-1]

        # --- launch: idle active clients pull theta^(v) and train --------
        # Every client trains and compresses (fixed shapes); non-launchers
        # are masked out below.
        launch = active & ~state.busy
        launch_f = launch.to(torch.float32)
        x = hfl.train_windows(ds, cfg, state.tick)
        deltas, losses = clients_fn(state.params, x.reshape(b_n * n, window, dim),
                                    batches.reshape((b_n * n,) + tuple(batches.shape[-2:])),
                                    stacked=bool(lead))
        deltas, losses = deltas.view(lead + (n, d)), losses.view(lead + (n,))
        if fault_on:
            deltas = flt.corrupt_deltas(deltas, fl, prev_delta=state.prev_delta, noise=byz_noise)
        n_nonfinite = torch.sum(launch & flt.nonfinite_rows(deltas), dim=-1, dtype=torch.int32)
        recon, new_err = agg.client_compress(deltas.reshape(b_n * n, d),
                                             state.err.reshape(b_n * n, d), compressor,
                                             chunk=cfg.client_chunk)
        new_err = torch.where(launch[..., None], new_err.view(lead + (n, d)), state.err)
        inflight = torch.where(launch[..., None], recon.view(lead + (n, d)), state.inflight)

        # Transmission: the update lands after compute + uplink latency.
        l_u = comp.payload_bits(d, cfg.compressor)
        l_full = 32.0 * d
        up_lat = en.link_latency_s(l_u, fa.dist_m, cfg.channel)
        if replay:
            # The recorded delay is the whole launch-to-arrival time.
            up_eff = torch.broadcast_to(delay, up_lat.shape)
            arr_t_new = state.t_now[..., None] + up_eff
        else:
            up_eff = up_lat
            arr_t_new = ((state.t_now + lat_comp)[..., None] + up_lat
                         + ch.per_trial(delay, up_lat))
        arrive_t = torch.where(launch, arr_t_new, state.arrive_t)
        uplink_lat = torch.where(launch, up_eff, state.uplink_lat)
        base_version = torch.where(launch, state.version[..., None], state.base_version)
        launch_fog = torch.where(launch, fa.fog_id, state.launch_fog)
        busy = state.busy | launch

        # Uplink + compute energy are spent at launch.
        e_up = torch.where(launch, en.tx_energy_j(l_u, fa.dist_m, cfg.channel, cfg.energy), 0.0)
        spent = e_up + torch.where(launch, ch.per_trial(e_comp, launch), 0.0)
        battery, _ = en.battery_step(state.battery, spent, cfg.energy)

        # --- fog tick: the fog_k-th arrival in flight or the timeout -----
        busy_t = torch.where(busy, arrive_t, NEVER_S)
        n_busy = torch.sum(busy, dim=-1)
        k_fog = upto(torch.clamp_min(n_busy, 1).to(torch.float32), fog_k).long()
        t_kth = torch.gather(torch.sort(busy_t, dim=-1).values, -1, (k_fog - 1)[..., None])[..., 0]
        t_tick = torch.minimum(t_kth, state.t_now + fog_timeout_s)
        # Nothing in flight: the clock holds; and it never runs backwards
        # (a merge's propagation may have passed a pending arrival).
        t_tick = torch.where(n_busy > 0, t_tick, state.t_now)
        t_tick = torch.maximum(t_tick, state.t_now)

        arrived = busy & (arrive_t <= t_tick[..., None])
        # Erasure strikes at delivery: energy and the EF step were spent,
        # the slot frees up, nothing folds in.
        if fault_on:
            lost = arrived & flt.draw_erasure(erase, fl.erasure_prob)
        else:
            lost = torch.zeros_like(arrived)
        ok = arrived & ~lost
        ok_f = ok.to(torch.float32)
        n_arrived = torch.sum(ok, dim=-1, dtype=torch.int32)

        # --- fold arrivals into the fog buffers --------------------------
        tau = (state.version[..., None] - base_version).to(torch.float32)
        w_tau = torch.pow(1.0 + tau, ch.per_trial(-alpha, tau))
        w_tau = torch.where(tau <= ch.per_trial(tau_max, tau), w_tau, 0.0)
        w = ds.n_samples * w_tau * ok_f
        fog_sum = state.fog_sum + fold(inflight * w[..., None], launch_fog)
        fog_w = state.fog_w + fold(w, launch_fog)
        fog_n = state.fog_n + fold(ok.to(torch.int32), launch_fog)
        if robust:
            # Per-client sums (w is 0 off the arrivals): over a fog they
            # give fog_sum, so trim 0 is the weighted mean.
            cli_sum = state.cli_sum + inflight * w[..., None]
            cli_w = state.cli_w + w
            cli_fog = torch.where(ok, launch_fog, state.cli_fog)
        else:
            cli_sum, cli_w, cli_fog = state.cli_sum, state.cli_w, state.cli_fog
        pending = state.pending + n_arrived
        busy = busy & ~arrived
        arrive_t = torch.where(arrived, NEVER_S, arrive_t)

        # --- global merge trigger ----------------------------------------
        # buffer_k clamps to what can still arrive.
        reachable = pending + torch.sum(busy, dim=-1, dtype=torch.int32)
        k_glob = upto(torch.clamp_min(reachable, 1).to(torch.float32), buffer_k)
        merge = ((pending.to(torch.float32) >= k_glob)
                 | (t_tick - state.t_last_merge >= timeout_s))

        # --- merge: fog means -> cooperative mix -> gateway (Eqs. 15-16) -
        # The cooperation decision sees the buffered update counts.
        decision = coop.decide(cfg.rule, dep.fog_pos, fog_n, cfg.channel)
        fog_has = fog_w > 0
        if robust:
            # Each client's buffered arrivals collapse to their weighted
            # mean, then the trimmed mean / median per fog.
            v_cli = cli_sum / torch.clamp_min(cli_w, 1e-12)[..., None]
            fog_delta, merge_w = kops.robust_aggregate(
                v_cli.reshape(b_n * n, d), folded(cli_fog), cli_w.reshape(-1), b_n * n_fog,
                cfg.trim_frac, cfg.robust)
            fog_delta, merge_w = fog_delta.view(lead + (n_fog, d)), merge_w.view(lead + (n_fog,))
        else:
            fog_delta = fog_sum / torch.clamp_min(fog_w, 1e-12)[..., None]
            merge_w = fog_w
        mixed = agg.cooperative_mix(fog_delta + flat0[..., None, :], decision)
        merged_flat = agg.global_aggregate(mixed, merge_w, prev=flat0)
        server = state.server
        if cfg.server_opt == "adam":
            # FedAdam at the gateway; its state advances only on merges.
            incr, moved = srv.adam_update(merged_flat - flat0,
                                          server._replace(step=server.step[..., None]),
                                          lr=cfg.server_lr)
            merged_flat = flat0 + incr
            server = srv.ServerOptState(torch.where(merge[..., None], moved.m, server.m),
                                        torch.where(merge[..., None], moved.v, server.v),
                                        torch.where(merge, moved.step[..., 0], server.step))
        new_flat = torch.where(merge[..., None], merged_flat, flat0)
        # The version moves only with the model: a timeout merge over an
        # empty buffer holds theta.
        did_move = merge & (torch.sum(fog_w, dim=-1) > 0)
        version = state.version + did_move.to(torch.int32)

        # --- merge-side energy / latency (Eqs. 18, 19, 21) ---------------
        e_ff = en.tx_energy_j(l_full, decision.dist_m, cfg.channel, cfg.energy)
        e_f2f = torch.where(merge, torch.sum(torch.where(
            decision.cooperates & fog_has, e_ff, 0.0), dim=-1), 0.0)
        e_fg = en.tx_energy_j(l_full, fa.fog_gateway_dist_m, cfg.channel, cfg.energy)
        e_f2g = torch.where(merge, torch.sum(torch.where(
            fog_has & fa.fog_gateway_feasible, e_fg, 0.0), dim=-1), 0.0)
        lat_up = torch.amax(torch.where(arrived, uplink_lat, 0.0), dim=-1)
        lat_ff = torch.amax(torch.where(
            decision.cooperates & fog_has,
            en.link_latency_s(l_full, decision.dist_m, cfg.channel), 0.0), dim=-1)
        lat_fg = torch.amax(torch.where(
            fog_has, en.link_latency_s(l_full, fa.fog_gateway_dist_m, cfg.channel), 0.0), dim=-1)
        merge_lat = torch.where(merge, torch.maximum(lat_ff, lat_fg), 0.0)
        # The slowest link that carried a payload this tick, plus compute
        # (hfl.comm_latency_s + compute in the sync limit).
        latency = torch.maximum(lat_up, merge_lat) + lat_comp
        # The clock moves to the trigger plus the merge's propagation.
        t_next = t_tick + merge_lat

        # --- drain the buffers on merge ----------------------------------
        fog_sum = torch.where(merge[..., None, None], 0.0, fog_sum)
        fog_w = torch.where(merge[..., None], 0.0, fog_w)
        fog_n = torch.where(merge[..., None], 0, fog_n)
        if robust:
            cli_sum = torch.where(merge[..., None, None], 0.0, cli_sum)
            cli_w = torch.where(merge[..., None], 0.0, cli_w)
        t_last_merge = torch.where(merge, t_tick, state.t_last_merge)
        pending = torch.where(merge, 0, pending)

        e_s2f = torch.sum(e_up, dim=-1)
        metrics = AsyncEventMetrics(
            loss=(torch.sum(losses * launch_f, dim=-1)
                  / torch.clamp_min(torch.sum(launch_f, dim=-1), 1.0)),
            e_s2f=e_s2f,
            e_f2f=e_f2f,
            e_f2g=e_f2g,
            e_total=e_s2f + e_f2f + e_f2g,
            latency_s=latency,
            participation=torch.mean(active_f, dim=-1),
            coop_links=torch.where(merge, torch.sum(decision.cooperates, dim=-1,
                                                    dtype=torch.int32), 0),
            battery_min=torch.amin(battery, dim=-1),
            n_nonfinite=n_nonfinite,
            n_erased=torch.sum(lost, dim=-1, dtype=torch.int32),
            global_finite=torch.all(torch.isfinite(new_flat), dim=-1),
            merged=merge,
            n_launched=torch.sum(launch, dim=-1, dtype=torch.int32),
            n_arrived=n_arrived,
            staleness=(torch.sum(tau * ok_f, dim=-1)
                       / torch.clamp_min(n_arrived.to(torch.float32), 1.0)),
            event_s=t_next - state.t_now,
            t_sim=t_next,
        )
        # Adaptive colluders observe the realised global movement.
        prev_delta = (torch.where(merge[..., None], new_flat - flat0, state.prev_delta)
                      if adaptive else state.prev_delta)
        return AsyncState(
            ae.unravel(new_flat, state.params), new_err, battery, dep, server, version, t_next,
            t_last_merge, pending, busy, inflight, arrive_t, base_version, uplink_lat,
            launch_fog, fog_sum, fog_w, fog_n, cli_sum, cli_w, cli_fog, assoc_fog, assoc_ok,
            prev_delta, state.tick + 1,
        ), metrics

    return event_fn


def train_trials(
    init_params: Sequence[Params],
    loss_fn: LossFn,
    ds: SensorDataset,
    acfg: AsyncFLConfig,
    deps: Sequence[topo.Deployment],
    draws: Sequence[hfl.RoundDraws],
) -> tuple[Params, AsyncEventMetrics]:
    """``n_events`` fog ticks of B trials at once on the device of ``ds``
    (stacked, ``hfl.stack_datasets``), trial b from ``init_params[b]``,
    ``deps[b]`` and ``draws[b]``: (final params, layers leading with B,
    and metrics (T, B))."""
    for one in draws:
        hfl.check_draws(draw_config(acfg), one)
    params, dep, draws_dev = hfl.place_trials(init_params, deps, draws, ds.train.device)
    event_fn = make_event_fn(loss_fn, ds, acfg)
    # No name holds the first state: the loop frees each state as it goes.
    return hfl.run_rounds(event_fn, init_state(params, dep, acfg), draws_dev, acfg.n_events)


def train(
    init_params: Params,
    loss_fn: LossFn,
    ds: SensorDataset,
    acfg: AsyncFLConfig,
    dep: topo.Deployment,
    draws: hfl.RoundDraws,
) -> tuple[Params, AsyncEventMetrics]:
    """Simulate ``acfg.n_events`` fog ticks of one trial on the device of
    ``ds`` (``dep`` and ``draws``, see :func:`draw_config`, are moved
    there once): (final params, per-tick metrics stacked (T, ...))."""
    hfl.check_draws(draw_config(acfg), draws)
    params, dep, draws_dev = hfl.place(init_params, dep, draws, ds.train.device)
    event_fn = make_event_fn(loss_fn, ds, acfg)
    return hfl.run_rounds(event_fn, init_state(params, dep, acfg), draws_dev, acfg.n_events)
