"""Flat (star-topology) FL baselines: FedAvg, FedProx, FedAdam, SCAFFOLD and
the centralised oracle (paper Sec. VI-B).

Flat methods are participation-limited: only sensors with a feasible
*direct* sensor->gateway acoustic link upload updates (Sec. IV-E).  The
gateway is one cluster (every fog id 0), so a FedAvg / FedProx / FedAdam
round runs the hierarchical round's operators with ``n_fog = 1``: the
client solver (``optim/sgd.make_client_solver``: ``local_train_f32`` on
the card, FedProx's ``prox_mu`` inside it), the fault layer, and the
compressed weighted mean (``fused_agg``, or ``wire_emit`` / ``wire_agg``
chunk by chunk with ``client_chunk``, or per client with ``fused=False``)
or the robust reduce (``robust_agg``).  SCAFFOLD averages its raw deltas
without the compressor (its fault path through ``ops.robust_aggregate``
with one fog).  The centralised oracle pools raw data at the gateway —
underwater-infeasible, kept as a reference; its energy is the raw-data
upload through each sensor's cheapest feasible path (direct if feasible,
else the 2-hop sensor->fog->gateway relay).

Randomness is injected as in ``core/hfl``: the flat and SCAFFOLD rounds
take ``hfl.RoundDraws`` (the reference splits its key per round exactly
as its hierarchical round does), the centralised oracle its per-epoch
index tables over the pooled rows.  The rounds loop in Python.  The
FedAvg / FedProx / FedAdam round runs B trials at once
(:func:`train_flat_trials`): trial b's gateway is fog b of B, so the
trials share one round's launches; it takes ``client_mesh`` as the
hierarchical round does (``core/hfl``: each rank trains and compresses
its slice of the clients, the gateway sums are summed over the mesh).
SCAFFOLD and the oracle run no kernel, take one trial at a time and no
mesh, as in the reference.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core import aggregation as agg
from repro_torch.core import association as assoc
from repro_torch.core import channel as ch
from repro_torch.core import compression as comp
from repro_torch.core import energy as en
from repro_torch.core import faults as flt
from repro_torch.core import topology as topo
from repro_torch.core.hfl import (
    HFLConfig, HFLState, RoundDraws, RoundMetrics, check_draws, check_mesh, client_rows,
    compute_cost, init_state, knobs_to, reassoc_schedule, run_rounds, stack_metrics, start,
    start_trials, train_windows,
)
from repro_torch.data.synthetic import SensorDataset
from repro_torch.kernels import ops as kops
from repro_torch.models import autoencoder as ae
from repro_torch.optim import scaffold as scf
from repro_torch.optim import server as srv
from repro_torch.optim.sgd import local_sgd, make_client_solver

Params = Any
LossFn = Callable[[Params, torch.Tensor], torch.Tensor]


def _gateway_round(cfg: HFLConfig, dep, assoc_ok, battery, t: int, mobility: torch.Tensor,
                   crash: torch.Tensor | None, schedule: torch.Tensor | None = None):
    """What every flat round does first: the fog walk, the sensors' drift,
    the direct-link association (refreshed every ``reassoc_every`` rounds
    with drift on, as ``core/hfl`` does: per trial by ``schedule``
    (``hfl.reassoc_schedule``) for a (B,) cadence) and the round's active
    set, for one trial or with leading trial axes.  Returns (dep,
    association, assoc_ok, active)."""
    if cfg.fog_mobility:
        dep = topo.gauss_markov_step(mobility, dep, cfg.deployment)
    dr = cfg.drift
    if dr.is_active:
        dep = topo.current_advection_step(dep, cfg.deployment, dr.sensor_current_m_s)
        # Frozen round membership, live gateway physics, decided on the
        # host in the reference's f32 arithmetic (round 0 always refreshes).
        if schedule is not None:
            fresh = assoc.flat_association(dep, cfg.channel).participates
            assoc_ok = torch.where(schedule[t][:, None], fresh, assoc_ok)
        elif np.mod(np.float32(t), np.float32(max(dr.reassoc_every, 1.0))) < 0.5:
            assoc_ok = assoc.flat_association(dep, cfg.channel).participates
        fa = assoc.assigned_flat_association(dep, cfg.channel, assoc_ok)
    else:
        fa = assoc.flat_association(dep, cfg.channel)
    active = fa.participates & (battery > ch.per_trial(cfg.energy.e_min_j, battery))
    if cfg.faults.is_active:
        # Crashed clients drop out like a dead battery.
        active = active & ~flt.draw_crash(crash, cfg.faults.crash_prob)
    return dep, fa, assoc_ok, active


def _check_fault_draws(cfg: HFLConfig, crash, erase) -> None:
    if cfg.faults.is_active and (crash is None or erase is None):
        raise ValueError("the fault layer needs the round's crash and erasure uniforms")


def make_flat_round_fn(
    loss_fn: LossFn,
    ds: SensorDataset,
    cfg: HFLConfig,
    *,
    client_mesh: Any = None,
) -> Callable[..., tuple[HFLState, RoundMetrics]]:
    """FedAvg (``prox_mu = 0``) / FedProx (``prox_mu > 0``) / FedAdam
    (``server_opt = "adam"``) direct-to-gateway round:
    ``round_fn(state, mobility, batches, crash=None, erase=None,
    byz_noise=None) -> (state, metrics)``, the arguments of
    ``core/hfl.make_round_fn``'s round, for one trial or the B trials of a
    stacked ``ds`` (``hfl.stack_datasets``).  The gateway is a single
    cluster: compression and the weighted mean (or the robust reduce) run
    with one fog a trial, the B * N folded clients into B fogs, trial b's
    gateway fog b.  ``client_mesh`` slices the clients as in
    ``core/hfl.make_round_fn``, with its refusals, and the (B,) knobs
    of a swept config likewise."""
    check_mesh(cfg, ds.train.shape[-3], client_mesh)
    host = cfg                                               # the knobs' host values
    schedule = reassoc_schedule(host.drift, host.rounds, ds.train.device)
    cfg = knobs_to(cfg, ds.train.device)
    fl = cfg.faults
    fault_on = fl.is_active
    adaptive = fault_on and fl.byz_mode == "adaptive"
    clients_fn = make_client_solver(
        loss_fn, batch_size=cfg.batch_size, epochs=cfg.local_epochs,
        lr=cfg.lr, prox_mu=cfg.prox_mu, solver=cfg.local_solver,
    )
    lead = tuple(ds.train.shape[:-3])                        # () or (B,)
    b_n, (n, window, dim) = math.prod(lead), ds.train.shape[-3:]
    rows = client_rows(client_mesh, n)                       # this rank's clients
    n_loc = rows.stop - rows.start
    gateway_id = torch.arange(b_n * n_loc, dtype=torch.int32, device=ds.train.device) // n_loc
    flops = en.autoencoder_flops(dim, (16, 8, 16), window, cfg.local_epochs)
    lat_comp, e_comp = compute_cost(host, flops, ds.train.device)
    compressor = comp.per_row(cfg.compressor, n_loc)        # a global rho_s per folded row

    def round_fn(state: HFLState, mobility: torch.Tensor, batches: torch.Tensor,
                 crash: torch.Tensor | None = None, erase: torch.Tensor | None = None,
                 byz_noise: torch.Tensor | None = None):
        _check_fault_draws(cfg, crash, erase)
        dep, fa, assoc_ok, active = _gateway_round(cfg, state.dep, state.assoc_ok, state.battery,
                                                   state.t, mobility, crash, schedule)
        flat0 = ae.ravel(state.params)                          # (..., d)
        d = flat0.shape[-1]
        active_f = active.to(torch.float32)
        # Erasure after feasibility: energy charged, EF advanced, weight 0.
        erased = active & flt.draw_erasure(erase, fl.erasure_prob) if fault_on else (
            torch.zeros_like(active))
        delivered = active & ~erased
        weights = ds.n_samples * delivered.to(torch.float32)

        x = train_windows(ds, cfg, state.t)[..., rows, :, :]
        deltas, losses = clients_fn(
            state.params, x.reshape(b_n * n_loc, window, dim),
            batches[..., rows, :, :].reshape((b_n * n_loc,) + tuple(batches.shape[-2:])),
            stacked=bool(lead))
        deltas, losses = deltas.view(lead + (n_loc, d)), losses.view(lead + (n_loc,))
        if fault_on:
            deltas = flt.corrupt_deltas(deltas, fl, prev_delta=state.prev_delta, noise=byz_noise)
        if client_mesh is None:
            n_nonfinite = torch.sum(delivered & flt.nonfinite_rows(deltas), dim=-1)
        else:
            n_nonfinite = torch.zeros(lead, dtype=torch.int32, device=deltas.device)
            losses = client_mesh.gather_rows(losses, n)
        folded = (deltas.reshape(b_n * n_loc, d), state.err.reshape(b_n * n_loc, d), gateway_id,
                  weights[..., rows].reshape(-1), b_n, compressor)
        if cfg.robust == "mean":
            mean_delta, _, new_err = agg.compress_and_aggregate(
                *folded, axis=client_mesh, chunk=cfg.client_chunk)
        else:
            mean_delta, _, new_err = agg.robust_compress_and_aggregate(
                *folded, cfg.trim_frac, cfg.robust, chunk=cfg.client_chunk)
        mean_delta = mean_delta.view(lead + (d,))
        new_err = torch.where(active[..., rows, None], new_err.view(lead + (n_loc, d)),
                              state.err)
        server = state.server
        if cfg.server_opt == "adam":
            # FedAdam [34] at the gateway: the mean delta is the pseudo-gradient.
            incr, server = srv.adam_update(mean_delta, state.server, lr=cfg.server_lr)
        else:
            incr = mean_delta
        new_flat = flat0 + incr

        l_u = comp.payload_bits(d, cfg.compressor)
        e_up = torch.where(active, en.tx_energy_j(l_u, fa.dist_m, cfg.channel, cfg.energy), 0.0)
        e_total = torch.sum(e_up, dim=-1)
        lat_up = torch.amax(torch.where(
            active, en.link_latency_s(l_u, fa.dist_m, cfg.channel), 0.0), dim=-1)
        battery, _ = en.battery_step(
            state.battery, e_up + torch.where(active, ch.per_trial(e_comp, active), 0.0),
            cfg.energy)
        zero = torch.zeros(lead, dtype=torch.float32, device=active.device)
        metrics = RoundMetrics(
            loss=(torch.sum(losses * active_f, dim=-1)
                  / torch.clamp_min(torch.sum(active_f, dim=-1), 1.0)),
            e_s2f=e_total,
            e_f2f=zero,
            e_f2g=zero,
            e_total=e_total,
            latency_s=lat_up + lat_comp,
            participation=torch.mean(active_f, dim=-1),
            coop_links=torch.zeros(lead, dtype=torch.int32, device=active.device),
            battery_min=torch.amin(battery, dim=-1),
            n_nonfinite=n_nonfinite.to(torch.int32),
            n_erased=torch.sum(erased.to(torch.int32), dim=-1),
            global_finite=torch.all(torch.isfinite(new_flat), dim=-1),
        )
        prev_delta = incr if adaptive else state.prev_delta
        return HFLState(ae.unravel(new_flat, state.params), new_err, battery, dep, server,
                        prev_delta, state.assoc_fog, assoc_ok, state.t + 1), metrics

    return round_fn


def train_flat_trials(
    init_params: Sequence[Params],
    loss_fn: LossFn,
    ds: SensorDataset,
    cfg: HFLConfig,
    deps: Sequence[topo.Deployment],
    draws: Sequence[RoundDraws],
    *,
    client_mesh: Any = None,
) -> tuple[Params, RoundMetrics]:
    """T flat rounds of B trials at once on the device of ``ds`` (stacked),
    trial b from ``init_params[b]``, ``deps[b]`` and ``draws[b]``; returns
    (final params, layers leading with B, and metrics (T, B))."""
    round_fn = make_flat_round_fn(loss_fn, ds, cfg, client_mesh=client_mesh)
    return run_rounds(round_fn, *start_trials(init_params, ds, cfg, deps, draws, client_mesh),
                      cfg.rounds)


def train_flat(
    init_params: Params,
    loss_fn: LossFn,
    ds: SensorDataset,
    cfg: HFLConfig,
    dep: topo.Deployment,
    draws: RoundDraws,
    *,
    client_mesh: Any = None,
) -> tuple[Params, RoundMetrics]:
    """T flat rounds on ``ds``'s device from the injected ``dep`` and
    ``draws`` (``core/hfl.draw_rounds``); returns (final params, metrics
    stacked over rounds)."""
    round_fn = make_flat_round_fn(loss_fn, ds, cfg, client_mesh=client_mesh)
    return run_rounds(round_fn, *start(init_params, ds, cfg, dep, draws, client_mesh),
                      cfg.rounds)


class ScaffoldTrainState(NamedTuple):
    """SCAFFOLD's round state: the hierarchical round's state (its params,
    battery, deployment, drift carry and the adaptive colluders' last
    delta; ``err`` and ``server`` unused) and the control variates."""

    fl: HFLState
    ctrl: scf.ScaffoldState


def train_scaffold(
    init_params: Params,
    loss_fn: LossFn,
    ds: SensorDataset,
    cfg: HFLConfig,
    dep: topo.Deployment,
    draws: RoundDraws,
) -> tuple[Params, RoundMetrics]:
    """SCAFFOLD over feasible direct links (option II; the released-trace
    baseline).  Deltas are averaged without the compressor.  With the
    fault layer on or a robust reduce, the flat deltas take Byzantine
    corruption, the isfinite guard and ``ops.robust_aggregate`` with one
    fog (the fault path); otherwise their plain weighted mean.  The server
    control variate moves by the delivered clients' mean change times
    their share of the fleet; active clients keep their new c_i."""
    fl = cfg.faults
    fault_on = fl.is_active
    fault_path = fault_on or cfg.robust != "mean"
    adaptive = fault_on and fl.byz_mode == "adaptive"
    check_draws(cfg, draws)
    dev = ds.train.device
    n = ds.train.shape[0]
    params = [{k: v.to(dev) for k, v in layer.items()} for layer in init_params]
    dep, draws = dep.to(dev), draws.to(dev)
    state = ScaffoldTrainState(fl=init_state(params, dep, cfg), ctrl=scf.init_state(params, n))
    steps = cfg.local_epochs * (ds.train.shape[1] // cfg.batch_size)
    per_round = []
    for t in range(cfg.rounds):
        st, ctrl = state
        mobility, batches, crash, erase, byz_noise = draws.round(t)
        _check_fault_draws(cfg, crash, erase)
        if tuple(batches.shape) != (n, steps, cfg.batch_size):
            raise ValueError(f"index table {tuple(batches.shape)} does not match {n} clients, "
                             f"{steps} steps of {cfg.batch_size} rows")
        dep, fa, assoc_ok, active = _gateway_round(cfg, st.dep, st.assoc_ok, st.battery, t,
                                                   mobility, crash)
        active_f = active.to(torch.float32)
        flat0 = ae.ravel(st.params)
        theta, new_ci, losses = scf.scaffold_clients(
            loss_fn, st.params, train_windows(ds, cfg, t), batches, cfg.lr,
            ctrl.c_global, ctrl.c_local)
        deltas = theta - flat0
        dcs = new_ci - ctrl.c_local
        erased = active & flt.draw_erasure(erase, fl.erasure_prob) if fault_on else (
            torch.zeros_like(active))
        delivered = active & ~erased
        delivered_f = delivered.to(torch.float32)
        weights = ds.n_samples * delivered_f
        if fault_path:
            if fault_on:
                deltas = flt.corrupt_deltas(deltas, fl, prev_delta=st.prev_delta,
                                            noise=byz_noise)
            finite = ~flt.nonfinite_rows(deltas)
            n_nonfinite = torch.sum(delivered & ~finite).to(torch.int32)
            w_del = weights * finite.to(torch.float32)
            safe = torch.where(finite[:, None], deltas, 0.0)
            if cfg.robust == "mean":
                mean_delta = agg.weighted_mean(safe, w_del)
            else:
                fog_out, _ = kops.robust_aggregate(
                    safe, torch.zeros((n,), dtype=torch.int32, device=safe.device), w_del, 1,
                    cfg.trim_frac, cfg.robust)
                mean_delta = fog_out[0]
        else:
            n_nonfinite = torch.zeros((), dtype=torch.int32, device=active.device)
            mean_delta = agg.weighted_mean(deltas, weights)
        new_flat = flat0 + mean_delta
        # c <- c + (1/N) sum over the delivered of dc (all active ones with faults off)
        frac = torch.sum(delivered_f) / n
        new_cg = ctrl.c_global + frac * agg.weighted_mean(dcs, delivered_f)
        ctrl = scf.ScaffoldState(new_cg, torch.where(active[:, None], new_ci, ctrl.c_local))

        l_u = comp.payload_bits(flat0.shape[0], cfg.compressor)
        e_up = torch.where(active, en.tx_energy_j(l_u, fa.dist_m, cfg.channel, cfg.energy), 0.0)
        battery, _ = en.battery_step(st.battery, e_up, cfg.energy)
        zero = torch.zeros((), dtype=torch.float32, device=active.device)
        per_round.append(RoundMetrics(
            loss=torch.sum(losses * active_f) / torch.clamp_min(torch.sum(active_f), 1.0),
            e_s2f=torch.sum(e_up),
            e_f2f=zero,
            e_f2g=zero,
            e_total=torch.sum(e_up),
            latency_s=zero,
            participation=torch.mean(active_f),
            coop_links=torch.zeros((), dtype=torch.int32, device=active.device),
            battery_min=torch.amin(battery),
            n_nonfinite=n_nonfinite,
            n_erased=torch.sum(erased.to(torch.int32)),
            global_finite=torch.all(torch.isfinite(new_flat)),
        ))
        # Adaptive colluders observe the realised global movement.
        state = ScaffoldTrainState(
            fl=st._replace(params=ae.unravel(new_flat, st.params), battery=battery, dep=dep,
                           assoc_ok=assoc_ok,
                           prev_delta=mean_delta if adaptive else st.prev_delta, t=t + 1),
            ctrl=ctrl)
    return state.fl.params, stack_metrics(per_round)


def train_centralised(
    init_params: Params,
    loss_fn: LossFn,
    ds: SensorDataset,
    cfg: HFLConfig,
    dep: topo.Deployment,
    pooled_batches: torch.Tensor,   # (epochs, n * window // bs, bs) row indices into the pool
) -> tuple[Params, torch.Tensor, torch.Tensor]:
    """All-data oracle at the gateway: ``local_sgd`` over the pooled
    (N * window, D) rows, one epoch per row of ``pooled_batches`` (the
    reference runs ``rounds * local_epochs`` of them).  Returns (params,
    losses (epochs,), upload_energy_j scalar), on ``ds``'s device."""
    dev = ds.train.device
    dep = dep.to(dev)
    # Each sensor's window (window x D f32 values) through its cheapest
    # feasible path, direct or over its nearest feasible fog; a sensor
    # with neither adds 0.
    raw_bits = ds.train.shape[1] * ds.train.shape[2] * 32.0
    flat = assoc.flat_association(dep, cfg.channel)
    fog = assoc.nearest_feasible_fog(dep, cfg.channel)
    e_direct = en.tx_energy_j(raw_bits, flat.dist_m, cfg.channel, cfg.energy)
    e_relay = en.tx_energy_j(raw_bits, fog.dist_m, cfg.channel, cfg.energy) + en.tx_energy_j(
        raw_bits, fog.fog_gateway_dist_m[fog.fog_id.long()], cfg.channel, cfg.energy)
    e_path = torch.minimum(torch.where(flat.participates, e_direct, torch.inf),
                           torch.where(fog.participates, e_relay, torch.inf))
    upload = torch.sum(torch.where(torch.isfinite(e_path), e_path, 0.0))
    pooled = ds.train.reshape(-1, ds.train.shape[-1])
    params = [{k: v.to(dev) for k, v in layer.items()} for layer in init_params]
    losses = []
    for idx in pooled_batches.to(dev):
        params, loss = local_sgd(loss_fn, params, pooled[idx.long()], cfg.lr)
        losses.append(loss)
    return params, torch.stack(losses), upload
