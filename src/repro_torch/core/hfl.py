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

The round also runs B independent trials at once (:func:`train_trials`,
what the batched ``Engine`` calls): every state tensor then leads with the
trial axis, and the trials fold into the kernels' client and fog axes, so
B trials make one trial's launches (with ``client_chunk`` the wire pair
walks the B * N clients in chunks, about B times one trial's).  :func:`train` runs the same round
on one trial's tensors, without a trial axis.

Randomness is an argument: :class:`RoundDraws` holds every round's
mobility noise, minibatch index table and, with faults on, the crash and
erasure uniforms and the Byzantine noise; :func:`draw_rounds` makes them
from a ``torch.Generator`` in a fixed order, so a run on the card and one
on the CPU see identical inputs, and a test can hand both packages the
reference's own draws.  Drift draws nothing.

With ``client_mesh`` (``launch/sharding.ClientMesh``, a
``torch.distributed`` process group, one process per card) the round is
SPMD, as the reference's ``shard_map``: every rank runs the physics,
mixing and gateway step on replicated state, and only the client phase is
sliced.  Rank r trains and compresses clients ``[r * N / W, (r + 1) * N /
W)`` (of every trial, folded as above into one ``local_train_f32`` launch
and one ``fused_agg`` call, or the wire pair chunk by chunk within the
slice), then the partial fog sums and weights are summed over the group
and the per-client losses put back together by a zero-filled
``all_reduce``.  Each rank keeps only its (..., N / W, d) slice of the
error-feedback buffers, which is the memory that sharding saves.  The
draws are the same on every rank, which slices its rows of the minibatch
tables, so a client sees what it sees unsharded.
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


@dataclasses.dataclass(frozen=True)
class HFLConfig:
    """Round-loop configuration: the reference's fields.

    A config sweep (``Engine.sweep``) runs the cells of one shape class as
    B trials of one config whose swept knobs (the reference's pytree
    leaves: ``lr``, ``prox_mu``, ``server_lr``, ``compute_rate_flops``,
    ``trim_frac``, a global compressor's ``rho_s`` and the ``channel``,
    ``energy``, ``faults`` and ``drift`` numbers) are (B,) f32 tensors of
    per-trial values, on the host: :func:`make_round_fn` and its siblings
    copy them to the device once (:func:`knobs_to`).  A one-trial config
    keeps its floats."""

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
        if isinstance(self.trim_frac, (int, float)) and not 0.0 <= self.trim_frac < 0.5:
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
    """The round state of one trial, or of B trials run together: then
    every tensor leads with the trial axis B."""

    params: Params               # global model theta^t (views of one flat (d,) / (B, d) vector)
    err: torch.Tensor            # (N, d) error-feedback buffers (a mesh rank's (N / W, d) slice)
    battery: torch.Tensor        # (N,) residual energy
    dep: topo.Deployment
    server: srv.ServerOptState   # gateway optimiser state (FedAdam)
    prev_delta: torch.Tensor     # (d,) last global delta (adaptive colluders)
    # Drift carry (unused with drift off; round 0 always refreshes it):
    assoc_fog: torch.Tensor      # (N,) int32 frozen sensor->fog assignment
    assoc_ok: torch.Tensor       # (N,) bool, feasible at assignment time
    t: int = 0                   # round counter, on the host (shared by the trials)


class RoundDraws(NamedTuple):
    """Per-round random inputs, stacked over the rounds.  The fault
    draws are None when the fault layer is off (``byz_noise`` also unless
    ``byz_mode == "gauss"``).  A batch of trials stacks them on a trial
    axis after the rounds' (:meth:`stack`): (T, B, ...)."""

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

    @staticmethod
    def stack(draws: "Sequence[RoundDraws]") -> "RoundDraws":
        """Trials' draws stacked on a trial axis after the rounds' (one
        trial's as a view: no copy of its index tables)."""
        if len(draws) == 1:
            return RoundDraws(*(None if x is None else x.unsqueeze(1) for x in draws[0]))
        return RoundDraws(*(None if xs[0] is None else torch.stack(xs, dim=1)
                            for xs in zip(*draws)))


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


def knobs_to(cfg: Any, device: torch.device | str) -> Any:
    """``cfg`` (any config dataclass, nested ones included) with every
    tensor knob on ``device``; ``cfg`` itself when nothing moves."""
    changes = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if isinstance(v, torch.Tensor):
            w = v.to(device)
        elif dataclasses.is_dataclass(v) and not isinstance(v, type):
            w = knobs_to(v, device)
        else:
            continue
        if w is not v:
            changes[f.name] = w
    return dataclasses.replace(cfg, **changes) if changes else cfg


def select_trials(cfg: Any, idx: torch.Tensor) -> Any:
    """``cfg`` for the trials ``idx`` of a swept config: every tensor knob
    indexed on its leading trial axis."""
    changes = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if isinstance(v, torch.Tensor):
            changes[f.name] = v[idx.to(v.device)]
        elif dataclasses.is_dataclass(v) and not isinstance(v, type):
            changes[f.name] = select_trials(v, idx)
    return dataclasses.replace(cfg, **changes) if changes else cfg


def per_client(value: Any, lead: tuple[int, ...], n: int, device: torch.device) -> torch.Tensor:
    """A (lead + (n,)) f32 tensor of ``value``: a number everywhere, or a
    (B,) tensor's trial b in row b."""
    if isinstance(value, torch.Tensor):
        v = value.to(device=device, dtype=torch.float32)
        return v.view(-1, 1).expand(lead + (n,)).contiguous()
    return torch.full(lead + (n,), value, dtype=torch.float32, device=device)


def compute_cost(cfg: HFLConfig, flops: int, device: torch.device) -> tuple[Any, Any]:
    """(compute latency, compute energy) of a client's local training:
    Python floats for a one-trial config, as before; with per-trial
    ``compute_rate_flops`` / ``eps_op_j`` knobs (B,) f32 tensors on
    ``device``, each trial's the value its one-trial config gives (the
    latency divided in f64 on the host, then rounded to f32).  ``cfg``'s
    knobs are the host copies (a card copy would be read back)."""
    rate, eps = cfg.compute_rate_flops, cfg.energy.eps_op_j
    if isinstance(rate, torch.Tensor):
        lat = (flops / rate.detach().cpu().to(torch.float64)).to(torch.float32).to(device)
    else:
        lat = flops / rate
    if isinstance(eps, torch.Tensor):
        e = en.compute_energy_j(flops, en.EnergyParams(eps_op_j=eps.to(device)))
    else:
        e = float(en.compute_energy_j(flops, cfg.energy))    # the f32 value, on the host
    return lat, e


def reassoc_schedule(drift: drf.DriftConfig, steps: int, device: torch.device):
    """The drift layer's re-association refreshes of ``steps`` rounds as a
    (steps, B) bool tensor on ``device`` when ``reassoc_every`` is a (B,)
    knob, built on the host from its values in the reference's f32
    arithmetic (``t mod max(k, 1) < 0.5``); None for a number, which the
    round decides on the host as before."""
    k = drift.reassoc_every
    if not isinstance(k, torch.Tensor):
        return None
    cad = np.maximum(k.detach().cpu().numpy().astype(np.float32), np.float32(1.0))
    t = np.arange(steps, dtype=np.float32)[:, None]
    return torch.from_numpy(np.mod(t, cad[None, :]) < 0.5).to(device)


def client_rows(client_mesh: Any, n: int) -> slice:
    """The clients of ``n`` this process trains: all of them, or its rank's
    slice of a client mesh (which raises unless the mesh size divides
    ``n``)."""
    return slice(0, n) if client_mesh is None else client_mesh.rows(n)


def check_mesh(cfg: HFLConfig, n: int, client_mesh: Any) -> None:
    """The reference's refusals of a client mesh, in its order: fault
    injection or a robust reduce, then drift, then a sensor count the mesh
    size does not divide."""
    if client_mesh is None:
        return
    if cfg.faults.is_active or cfg.robust != "mean":
        raise ValueError("client-sharded rounds do not support fault injection or robust "
                         "aggregation (the per-client reconstructions never leave their shard)")
    if cfg.drift.is_active:
        raise ValueError("client-sharded rounds do not support the drift layer yet")
    if n % client_mesh.size != 0:
        raise ValueError(f"client axis ({n} sensors) must divide the ({client_mesh.size})-device "
                         "client mesh")


def init_state(params: Params, dep: topo.Deployment, cfg: HFLConfig,
               client_mesh: Any = None) -> HFLState:
    """The first state of one trial, or of B trials from their stacked
    params (layers leading with B) and deployments; with ``client_mesh``
    the error-feedback buffers are this rank's clients' only."""
    flat = ae.ravel(params)
    lead, n = tuple(flat.shape[:-1]), cfg.deployment.n_sensors
    rows = client_rows(client_mesh, n)
    dev = flat.device
    return HFLState(
        params=ae.unravel(flat.clone(), params),
        err=torch.zeros(lead + (rows.stop - rows.start, flat.shape[-1]), dtype=flat.dtype,
                        device=dev),
        battery=per_client(cfg.energy.e_init_j, lead, n, dev),
        dep=dep,
        server=srv.init_state(tuple(flat.shape), dev),
        prev_delta=torch.zeros_like(flat),
        assoc_fog=torch.zeros(lead + (n,), dtype=torch.int32, device=dev),
        assoc_ok=torch.zeros(lead + (n,), dtype=torch.bool, device=dev),
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
    energy term: an empty fog has no model to exchange.  Per trial of the
    leading axes."""
    lat_up = torch.amax(torch.where(
        active, en.link_latency_s(l_u, sensor_dist_m, channel), 0.0), dim=-1)
    lat_ff = torch.amax(torch.where(
        decision.cooperates & fog_active,
        en.link_latency_s(l_full, decision.dist_m, channel), 0.0,
    ), dim=-1)
    lat_fg = torch.amax(torch.where(
        fog_active, en.link_latency_s(l_full, fog_gateway_dist_m, channel), 0.0
    ), dim=-1)
    return torch.maximum(torch.maximum(lat_up, lat_ff), lat_fg)


def make_round_fn(
    loss_fn: LossFn,
    ds: SensorDataset,
    cfg: HFLConfig,
    *,
    client_mesh: Any = None,
) -> Callable[..., tuple[HFLState, RoundMetrics]]:
    """Build ``round_fn(state, mobility (M, 3), batches (N, steps, bs))
    -> (state, metrics)``, one round of Algorithm 1 on ``ds``'s device;
    with the fault layer on it also takes the round's ``crash`` and
    ``erase`` uniforms (N,) and, for ``gauss``, ``byz_noise`` (N, d).

    With ``ds`` stacked for B trials (train (B, N, window, D),
    :func:`stack_datasets`) every argument and metric leads with B, and
    the trials share the kernels' launches: the clients fold into one client axis
    of B * N (``local_train_f32`` takes each trial's own start vector),
    trial b's fog ids are offset by b * M into B * M fogs for the
    compressed fog reduce (``fused_agg``, the wire pair or ``robust_agg``:
    a fog's members are all of one trial, summed in client order), and
    the physics, mixing and gateway step run with the trial axis leading.
    So a round of B trials makes one trial's launches, except the chunked
    wire pair (``client_chunk``), which walks the B * N clients a chunk at
    a time: ceil(B * N / chunk) launches of each a round.

    ``client_mesh`` (``launch/sharding.ClientMesh``) slices the client
    phase over its ranks (see the module docstring): this rank's B * N / W
    clients make the launches, the fog sums are summed over the mesh.
    Fault injection, a robust reduce, the drift layer and a sensor count
    the mesh size does not divide raise ``ValueError``, as in the
    reference; ``n_nonfinite`` is 0 under a mesh (the isfinite guard in
    ``compress_and_accumulate`` still zeroes such rows).

    ``cfg`` may carry (B,) knobs (:class:`HFLConfig`), trial b's values
    for trial b: they go to the device once here, and the rounds read them
    per trial with no read back from the card."""
    check_mesh(cfg, ds.train.shape[-3], client_mesh)
    dev = ds.train.device
    host = cfg                                               # the knobs' host values
    schedule = reassoc_schedule(host.drift, host.rounds, dev)
    cfg = knobs_to(cfg, dev)
    n_fog = cfg.deployment.n_fog
    fl = cfg.faults
    fault_on = fl.is_active          # off: exactly the fault-free round
    dr = cfg.drift
    drift_on = dr.is_active          # off: exactly the drift-free round
    cadence = None if schedule is not None else np.float32(max(dr.reassoc_every, 1.0))
    adaptive = fault_on and fl.byz_mode == "adaptive"
    clients_fn = make_client_solver(
        loss_fn, batch_size=cfg.batch_size, epochs=cfg.local_epochs,
        lr=cfg.lr, prox_mu=cfg.prox_mu, solver=cfg.local_solver,
    )
    lead = tuple(ds.train.shape[:-3])                        # () or (B,)
    b_n, (n, window, dim) = math.prod(lead), ds.train.shape[-3:]
    rows = client_rows(client_mesh, n)                       # this rank's clients
    n_loc = rows.stop - rows.start
    # Trial b's fogs are b * M .. b * M + M - 1 of the folded fog axis.
    fog_base = torch.arange(b_n, dtype=torch.int32, device=ds.train.device)[:, None] * n_fog
    # As in the reference, the compute cost counts the paper's hidden widths.
    flops = en.autoencoder_flops(dim, (16, 8, 16), window, cfg.local_epochs)
    lat_comp, e_comp = compute_cost(host, flops, dev)
    compressor = comp.per_row(cfg.compressor, n_loc)        # a global rho_s per folded row

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
            assoc_fog, assoc_ok = refresh_assoc(dep, cfg.channel, schedule, cadence, state.t,
                                                assoc_fog, assoc_ok)
            fa = assoc.assigned_fog_association(dep, cfg.channel, assoc_fog, assoc_ok)
        else:
            fa = assoc.nearest_feasible_fog(dep, cfg.channel)
        alive = state.battery > ch.per_trial(cfg.energy.e_min_j, state.battery)
        active = fa.participates & alive
        if fault_on:
            # Crashed clients drop out like a dead battery: no training, no
            # transmission, no energy this round.
            active = active & ~flt.draw_crash(crash, fl.crash_prob)
        # Cooperation sees round-active cluster sizes (battery included).
        c_active = assoc.cluster_sizes(fa.fog_id, active, n_fog)
        decision = coop.decide(cfg.rule, dep.fog_pos, c_active, cfg.channel)

        # --- 2+3. local training, fused compression + fog sums -----------
        flat0 = ae.ravel(state.params)                          # (..., d)
        d = flat0.shape[-1]
        active_f = active.to(torch.float32)
        # Erasure strikes after the SNR gate: the packet was sent (energy
        # charged below, EF buffer advances), only its weight vanishes.
        if fault_on:
            erased = active & flt.draw_erasure(erase, fl.erasure_prob)
        else:
            erased = torch.zeros_like(active)
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
            # The deltas never leave their rank: only the counter is lost.
            n_nonfinite = torch.zeros(lead, dtype=torch.int32, device=deltas.device)
            losses = client_mesh.gather_rows(losses, n)
        fog_id = fa.fog_id[..., rows] if b_n == 1 else fa.fog_id[..., rows] + fog_base
        folded = (deltas.reshape(b_n * n_loc, d), state.err.reshape(b_n * n_loc, d),
                  fog_id.reshape(-1), weights[..., rows].reshape(-1), b_n * n_fog, compressor)
        if cfg.robust == "mean":
            fog_delta, fog_weight, new_err = agg.compress_and_aggregate(
                *folded, axis=client_mesh, chunk=cfg.client_chunk)
        else:
            fog_delta, fog_weight, new_err = agg.robust_compress_and_aggregate(
                *folded, cfg.trim_frac, cfg.robust, chunk=cfg.client_chunk)
        fog_delta, fog_weight = fog_delta.view(lead + (n_fog, d)), fog_weight.view(lead + (n_fog,))
        # Non-participants keep their error buffer and contribute nothing.
        new_err = torch.where(active[..., rows, None], new_err.view(lead + (n_loc, d)), state.err)

        fog_model = fog_delta + flat0[..., None, :]             # theta_m^{t+1/2}
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
        e_s2f = torch.sum(e_up, dim=-1)
        fog_active = fog_weight > 0
        e_ff = en.tx_energy_j(l_full, decision.dist_m, cfg.channel, cfg.energy)
        e_f2f = torch.sum(torch.where(decision.cooperates & fog_active, e_ff, 0.0), dim=-1)
        e_fg = en.tx_energy_j(l_full, fa.fog_gateway_dist_m, cfg.channel, cfg.energy)
        e_f2g = torch.sum(torch.where(fog_active & fa.fog_gateway_feasible, e_fg, 0.0), dim=-1)
        lat_comm = comm_latency_s(
            l_u, l_full, active, fa.dist_m, decision, fog_active,
            fa.fog_gateway_dist_m, cfg.channel,
        )
        spent = e_up + torch.where(active, ch.per_trial(e_comp, active), 0.0)
        battery, _ = en.battery_step(state.battery, spent, cfg.energy)

        metrics = RoundMetrics(
            loss=(torch.sum(losses * active_f, dim=-1)
                  / torch.clamp_min(torch.sum(active_f, dim=-1), 1.0)),
            e_s2f=e_s2f,
            e_f2f=e_f2f,
            e_f2g=e_f2g,
            e_total=e_s2f + e_f2f + e_f2g,
            latency_s=lat_comm + lat_comp,
            participation=torch.mean(active_f, dim=-1),
            coop_links=torch.sum(decision.cooperates.to(torch.int32), dim=-1),
            battery_min=torch.amin(battery, dim=-1),
            n_nonfinite=n_nonfinite.to(torch.int32),
            n_erased=torch.sum(erased.to(torch.int32), dim=-1),
            global_finite=torch.all(torch.isfinite(new_flat), dim=-1),
        )
        # Adaptive colluders observe the realised global movement.
        prev_delta = new_flat - flat0 if adaptive else state.prev_delta
        return HFLState(new_params, new_err, battery, dep, server, prev_delta,
                        assoc_fog, assoc_ok, state.t + 1), metrics

    return round_fn


def refresh_assoc(dep: topo.Deployment, channel: ch.ChannelParams, schedule, cadence,
                  t: int, assoc_fog: torch.Tensor, assoc_ok: torch.Tensor):
    """The drift layer's carried assignment after round ``t``'s refresh:
    with a (B,) cadence each trial takes the fresh nearest-feasible-fog
    assignment where its ``schedule`` row says so (:func:`reassoc_schedule`),
    else the host decides for every trial, as it did before."""
    if schedule is not None:
        fresh = assoc.nearest_feasible_fog(dep, channel)
        now = schedule[t][:, None]
        return (torch.where(now, fresh.fog_id, assoc_fog),
                torch.where(now, fresh.participates, assoc_ok))
    if np.mod(np.float32(t), cadence) < 0.5:
        fresh = assoc.nearest_feasible_fog(dep, channel)
        return fresh.fog_id, fresh.participates
    return assoc_fog, assoc_ok


def train_windows(ds: SensorDataset, cfg: HFLConfig, t: int) -> torch.Tensor:
    """Round ``t``'s client windows: with the drift layer on, scaled by the
    covariate shift ``1 + covariate_shift * t`` in f32 as the reference
    computes it (a factor of exactly 1 leaves them as they are); a (B,)
    ``covariate_shift`` on the data's device scales trial b by its own."""
    if not cfg.drift.is_active:
        return ds.train
    shift = cfg.drift.covariate_shift
    if isinstance(shift, torch.Tensor):
        scale = 1.0 + shift * float(np.float32(t))
        return ds.train * scale.view((-1,) + (1,) * (ds.train.dim() - 1))
    scale = np.float32(1.0) + np.float32(shift) * np.float32(t)
    return ds.train if scale == 1.0 else ds.train * float(scale)


def stack_datasets(ds: Sequence[SensorDataset]) -> SensorDataset:
    """Trials' datasets stacked on a new leading trial axis (one dataset
    alone as a view); every split keeps its device."""
    if len(ds) == 1:
        return SensorDataset(*(t.unsqueeze(0) for t in ds[0]))
    return SensorDataset(*(torch.stack(ts) for ts in zip(*ds)))


def check_draws(cfg: HFLConfig, draws: RoundDraws) -> None:
    """Raise unless ``draws`` cover ``cfg``'s rounds and fault layer."""
    if not 1 <= cfg.rounds <= draws.mobility.shape[0]:
        raise ValueError(f"draws cover {draws.mobility.shape[0]} rounds, cfg.rounds={cfg.rounds}")
    if cfg.faults.is_active and (draws.crash is None or draws.erase is None or (
            cfg.faults.byz_mode == "gauss" and draws.byz_noise is None)):
        raise ValueError("the fault layer is on but the draws lack its uniforms or noise "
                         "(draw them with draw_rounds(..., d=...) under the same config)")


def place(init_params: Params, dep: topo.Deployment, draws: RoundDraws,
          dev: torch.device) -> tuple[Params, topo.Deployment, RoundDraws]:
    """One trial's params, deployment and draws on ``dev``."""
    params = [{k: v.to(dev) for k, v in layer.items()} for layer in init_params]
    return params, dep.to(dev), draws.to(dev)


def place_trials(init_params: Sequence[Params], deps: Sequence[topo.Deployment],
                 draws: Sequence[RoundDraws], dev: torch.device,
                 ) -> tuple[Params, topo.Deployment, RoundDraws]:
    """B trials' params (layers leading with B), deployments and draws
    ((T, B, ...)) stacked on ``dev``."""
    params = [{k: torch.stack([p[i][k] for p in init_params]).to(dev) for k in layer}
              for i, layer in enumerate(init_params[0])]
    return params, topo.Deployment.stack(list(deps)).to(dev), RoundDraws.stack(draws).to(dev)


def start(init_params: Params, ds: SensorDataset, cfg: HFLConfig, dep: topo.Deployment,
          draws: RoundDraws, client_mesh: Any = None) -> tuple[HFLState, RoundDraws]:
    """Check ``draws`` against ``cfg`` and move a trial onto ``ds``'s
    device: (the initial state, the draws there)."""
    check_draws(cfg, draws)
    params, dep, draws = place(init_params, dep, draws, ds.train.device)
    return init_state(params, dep, cfg, client_mesh), draws


def start_trials(init_params: Sequence[Params], ds: SensorDataset, cfg: HFLConfig,
                 deps: Sequence[topo.Deployment], draws: Sequence[RoundDraws],
                 client_mesh: Any = None) -> tuple[HFLState, RoundDraws]:
    """:func:`start` for B trials on the device of ``ds`` (stacked, (B, N,
    ...)): (their first state, their draws stacked (T, B, ...))."""
    for one in draws:
        check_draws(cfg, one)
    params, dep, draws = place_trials(init_params, deps, draws, ds.train.device)
    return init_state(params, dep, cfg, client_mesh), draws


def stack_metrics(per_round: list[NamedTuple]) -> NamedTuple:
    """Per-round metrics (``RoundMetrics``, or any family's record type)
    stacked over the rounds: (T, ...) leaves of the same type."""
    return type(per_round[0])(*(torch.stack(v) for v in zip(*per_round)))


def run_rounds(
    round_fn: Callable[..., tuple[HFLState, RoundMetrics]],
    state: HFLState,
    draws: RoundDraws,
    rounds: int,
    store: Any | None = None,
    publish_every: int = 1,
    publish_offset: int = 0,
) -> tuple[Params, RoundMetrics]:
    """Loop ``round_fn`` over ``rounds`` rounds of ``draws`` (or an async
    ``event_fn`` over its events); returns (the final params, metrics
    stacked over rounds).  With ``store`` the loop
    publishes the global params every ``publish_every`` rounds (step =
    round index + ``publish_offset``; the final round always publishes)."""
    per_round = []
    for t in range(rounds):
        state, m = round_fn(state, *draws.round(t))
        per_round.append(m)
        if store is not None and ((t + 1) % publish_every == 0 or t + 1 == rounds):
            store.publish(publish_offset + t + 1, state.params)
    return state.params, stack_metrics(per_round)


def train_trials(
    init_params: Sequence[Params],
    loss_fn: LossFn,
    ds: SensorDataset,
    cfg: HFLConfig,
    deps: Sequence[topo.Deployment],
    draws: Sequence[RoundDraws],
    *,
    client_mesh: Any = None,
) -> tuple[Params, RoundMetrics]:
    """T federated rounds of B trials at once on the device of ``ds``
    (stacked, :func:`stack_datasets`), trial b from ``init_params[b]``,
    ``deps[b]`` and ``draws[b]``; returns (final params, layers leading
    with B, and metrics (T, B)).  ``client_mesh`` as in
    :func:`make_round_fn`."""
    round_fn = make_round_fn(loss_fn, ds, cfg, client_mesh=client_mesh)
    # No name holds the first state: run_rounds frees each state as it goes.
    return run_rounds(round_fn, *start_trials(init_params, ds, cfg, deps, draws, client_mesh),
                      cfg.rounds)


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
    """Run T federated rounds of one trial; returns (final params, metrics
    stacked over rounds).  Everything runs on the device of ``ds``; ``dep``
    and ``draws`` (see :func:`draw_rounds`) are moved there once.

    With ``store`` (a ``checkpoint.CheckpointStore``) the loop publishes
    the global params every ``publish_every`` rounds (step = round index +
    ``publish_offset``; the final round always publishes), which is what
    the serving hot-swap watches.  With ``client_mesh`` every rank calls
    this with the same arguments and returns the same params and metrics
    (:func:`make_round_fn`); give the store to one rank.
    """
    round_fn = make_round_fn(loss_fn, ds, cfg, client_mesh=client_mesh)
    # No name holds the first state: run_rounds frees each state as it goes.
    return run_rounds(round_fn, *start(init_params, ds, cfg, dep, draws, client_mesh), cfg.rounds,
                      store, publish_every, publish_offset)
