"""Federated-experiment runner (one call = one paper table cell).

:func:`trial_metrics` trains a method and evaluates it with the paper's
protocol (train -> calibrate the 99th-percentile threshold on normal-only
validation -> score test -> F1 / PA-F1), beside the per-round energy and
participation traces.  The hierarchical methods (``hfl-*``,
``core/hfl``) and the flat baselines (``fedavg``, ``fedprox``,
``fedadam``, ``scaffold`` and the ``centralised`` oracle,
``core/flat_fl``) and the event-driven async family (``hfl-async``,
``core/async_fl``: ``cfg`` may be an ``AsyncFLConfig``, a plain
``HFLConfig`` is wrapped with the async defaults) are ported, with every
option of their config: the compressor's fused and per-client paths
(``CompressorConfig(fused=False)``, quantise-only ``rho_s=1``), the legacy
client scan (``LocalTrainConfig(fused=False)``), the fault layer, robust
reduces, client chunking and the dynamic world (``drift=DriftConfig(...)``),
all through :func:`make_config`'s overrides.  ``client_mesh``
(``launch/sharding.ClientMesh``) slices the client phase of the
hierarchical and flat rounds over a ``torch.distributed`` group (every
rank calls with the same arguments and gets the same result);
``hfl-async``, ``scaffold`` and ``centralised`` run whole on every rank
and ignore it, as the reference's runner does.

Randomness is injected: a trial's random inputs (:class:`TrialInputs`:
init params, deployment, per-round draws, and the centralised oracle's
per-epoch index tables) come from :func:`draw_trial` and a
``torch.Generator``, or are handed in by the caller, so one trial can run
on the card and on the CPU, or in both packages, on identical inputs.
:func:`batched_trial_metrics` runs B trials at once, each on its own
inputs, sharing every round's kernel launches (the batched ``Engine``'s
trial function); :func:`trial_metrics` runs one trial through the same
round, without a trial axis.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Sequence

import torch

from repro_torch import device as _device
from repro_torch.core import anomaly, async_fl, flat_fl, hfl
from repro_torch.core import association as assoc
from repro_torch.core import compression as comp
from repro_torch.core import cooperation as coop
from repro_torch.core import energy as en
from repro_torch.core import topology as topo
from repro_torch.data.pipeline import multi_epoch_indices
from repro_torch.data.synthetic import SensorDataset
from repro_torch.models import autoencoder as ae

METHODS = (
    "centralised",
    "fedavg",
    "fedprox",
    "fedadam",
    "scaffold",
    "hfl-nocoop",
    "hfl-selective",
    "hfl-nearest",
    "hfl-adam",
    "hfl-async",
)

_RULES = {
    "hfl-nocoop": coop.CoopRule.NOCOOP,
    "hfl-selective": coop.CoopRule.SELECTIVE,
    "hfl-nearest": coop.CoopRule.NEAREST,
    "hfl-adam": coop.CoopRule.SELECTIVE,   # FedAdam server + selective coop
}

FLAT_METHODS = ("fedavg", "fedprox", "fedadam")
# Methods that run no kernel: their trials run one after another.
UNBATCHED = ("centralised", "scaffold")

# FedProx proximal coefficient (paper uses mu ~ 0.01 scale defaults).
PROX_MU = 0.01


@dataclasses.dataclass(frozen=True)
class ExperimentResult:
    method: str
    f1: float
    precision: float
    recall: float
    participation: float       # mean over rounds
    e_total: float             # sum over rounds (J)
    e_s2f: float
    e_f2f: float
    e_f2g: float
    losses: tuple[float, ...]  # per-round mean training loss
    coop_links: float          # mean active fog-to-fog exchanges per round


class TrialInputs(NamedTuple):
    """A trial's random inputs.  The round methods (hierarchical, flat,
    SCAFFOLD) read ``draws``; the centralised oracle reads ``pooled``."""

    params: Any                # initial autoencoder params
    dep: topo.Deployment       # initial deployment
    draws: hfl.RoundDraws | None   # per-round (per-event) mobility noise, minibatch tables, fault draws
    pooled: torch.Tensor | None = None   # (T * E, N * window // bs, bs) pooled-row tables


def async_config(cfg: hfl.HFLConfig | async_fl.AsyncFLConfig) -> async_fl.AsyncFLConfig:
    """``cfg`` as the async family runs it: a plain ``HFLConfig`` wrapped
    with the async defaults."""
    return cfg if isinstance(cfg, async_fl.AsyncFLConfig) else async_fl.AsyncFLConfig(base=cfg)


def draw_trial(
    generator: torch.Generator, ds: SensorDataset,
    cfg: hfl.HFLConfig | async_fl.AsyncFLConfig,
    hidden: tuple[int, ...] = (16, 8, 16), method: str = "hfl-selective",
) -> TrialInputs:
    """Draw a trial's inputs on the CPU from ``generator``, in this order:
    the init params (``models/autoencoder.init``), the deployment
    (``core/topology.sample_deployment``), then for ``method`` =
    ``"centralised"`` the oracle's ``rounds * local_epochs`` epochs of
    minibatch tables over the pooled N * window rows
    (``data/pipeline.multi_epoch_indices``, one epoch a row), for any
    other method the per-round draws (``core/hfl.draw_rounds``, fault
    draws included when the fault layer is on); ``"hfl-async"`` draws
    ``n_events`` of them, one an event."""
    if method == "hfl-async":
        cfg = async_fl.draw_config(async_config(cfg))
    n, window, dim = ds.train.shape
    params = ae.init(generator, dim, hidden, device="cpu")
    dep = topo.sample_deployment(generator, cfg.deployment, device="cpu")
    if method == "centralised":
        pooled = multi_epoch_indices(generator, cfg.rounds * cfg.local_epochs, n * window,
                                     cfg.batch_size, 1)
        return TrialInputs(params, dep, None, pooled)
    draws = hfl.draw_rounds(generator, cfg, n, window, d=ae.param_count(dim, hidden))
    return TrialInputs(params, dep, draws)


def _check_method(method: str) -> None:
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; one of {METHODS}")


def _dataset_to(ds: SensorDataset, dev: torch.device) -> SensorDataset:
    return SensorDataset(*(t.to(dev) for t in ds))


def _detector_eval(
    params: Any, ds: SensorDataset, percentile: float, point_adjusted: bool
) -> anomaly.F1Result:
    """Paper protocol with the GLOBAL threshold variant (Sec. V-D); with
    ``params`` and ``ds`` leading with a trial axis, each trial has its own
    threshold and F1."""
    lead, d = tuple(ds.val.shape[:-3]), ds.val.shape[-1]
    return anomaly.evaluate_detector(
        ae.apply, params, ds.val.reshape(lead + (-1, d)), ds.test.reshape(lead + (-1, d)),
        ds.test_label.reshape(lead + (-1,)), percentile=percentile,
        point_adjusted=point_adjusted,
    )


def _run_cfg(method: str, cfg: hfl.HFLConfig) -> hfl.HFLConfig:
    """``cfg`` as the reference routes ``method``: ``fedprox`` with
    ``prox_mu = PROX_MU``, ``fedadam`` / ``hfl-adam`` with the FedAdam
    gateway, the hfl methods with their cooperation rule."""
    if method in FLAT_METHODS:
        return cfg.replace(prox_mu=PROX_MU if method == "fedprox" else 0.0,
                           server_opt="adam" if method == "fedadam" else cfg.server_opt)
    return cfg.replace(rule=_RULES[method], prox_mu=0.0,
                       server_opt="adam" if method == "hfl-adam" else cfg.server_opt)


def _summary(m: Any) -> dict[str, torch.Tensor]:
    """A round loop's metrics (T, ...) as the trial metrics, each (...)
    (the losses (..., T))."""
    return {
        "e_total": torch.sum(m.e_total, dim=0),
        "e_s2f": torch.sum(m.e_s2f, dim=0),
        "e_f2f": torch.sum(m.e_f2f, dim=0),
        "e_f2g": torch.sum(m.e_f2g, dim=0),
        "participation": torch.mean(m.participation, dim=0),
        "coop_links": torch.mean(m.coop_links.to(torch.float32), dim=0),
        "losses": torch.movedim(m.loss, 0, -1),
        "sim_time_s": torch.sum(m.latency_s, dim=0),
        "nonfinite_total": torch.sum(m.n_nonfinite.to(torch.float32), dim=0),
        "erased_total": torch.sum(m.n_erased.to(torch.float32), dim=0),
        "nonfinite_rounds": torch.sum(1.0 - m.global_finite.to(torch.float32), dim=0),
    }


def _async_summary(m: async_fl.AsyncEventMetrics) -> dict[str, torch.Tensor]:
    """An async loop's metrics (T, ...) as the trial metrics: the round
    loops' keys, with ``sim_time_s`` the final simulated clock, plus the
    merge count and the arrival-weighted mean staleness."""
    arrived = m.n_arrived.to(torch.float32)
    return {**_summary(m), "sim_time_s": m.t_sim[-1],
            "merges": torch.sum(m.merged.to(torch.float32), dim=0),
            "staleness": (torch.sum(m.staleness * arrived, dim=0)
                          / torch.clamp_min(torch.sum(arrived, dim=0), 1.0))}


def _one_trial(method, ds, cfg, inputs) -> tuple[Any, dict[str, torch.Tensor]]:
    """SCAFFOLD or the centralised oracle, one trial on ``ds``'s device
    (neither runs a kernel, so batching them would save no launch): (its
    params, its metrics but the F1s)."""
    dev = ds.train.device
    if method == "scaffold":
        params, m = flat_fl.train_scaffold(inputs.params, ae.loss, ds, cfg, inputs.dep,
                                           inputs.draws)
        return params, _summary(m)
    if inputs.pooled is None:
        raise ValueError("the centralised oracle needs TrialInputs.pooled "
                         "(draw_trial(..., method='centralised'))")
    params, losses, e_up = flat_fl.train_centralised(
        inputs.params, ae.loss, ds, cfg, inputs.dep, inputs.pooled)
    zero = torch.zeros((), device=dev)
    # The oracle sees everything; it has no federated uplinks, so the
    # robustness counters are 0.
    return params, {
        "e_s2f": zero, "e_f2f": zero, "e_f2g": zero, "e_total": e_up,
        "participation": torch.ones((), device=dev), "coop_links": zero,
        "losses": losses, "sim_time_s": zero, "nonfinite_total": zero,
        "erased_total": zero, "nonfinite_rounds": zero,
    }


def batched_trial_metrics(
    method: str,
    inputs: Sequence[TrialInputs],
    ds: SensorDataset | Sequence[SensorDataset],
    cfg: hfl.HFLConfig | Sequence[hfl.HFLConfig],
    *,
    percentile: float = 99.0,
    point_adjusted: bool = False,
    client_mesh: Any = None,
    return_params: bool = False,
    device: torch.device | str | None = None,
) -> dict[str, Any]:
    """B trials of ``method`` at once, trial b on ``inputs[b]`` and its
    dataset (``ds[b]``, or one dataset shared by every trial): the
    :func:`trial_metrics` dict with a leading B axis on every value
    (``"params"`` layers lead with B).

    The round methods run their B trials through one round loop
    (``hfl.train_trials``, ``flat_fl.train_flat_trials``,
    ``async_fl.train_trials``: an event is its round), so a round of B
    trials launches each kernel as often as one trial's round does (the
    chunked wire pair excepted: ceil(B * N / chunk) launches a round); the
    evaluation takes a threshold and an F1 per trial.  SCAFFOLD and the
    centralised oracle run their trials one after another.  ``client_mesh``
    slices the hierarchical and flat rounds' clients (:func:`trial_metrics`).

    ``cfg`` may carry (B,) knobs, trial b's values for trial b (a config
    sweep's cells folded into the trials, ``Engine.sweep``); SCAFFOLD and
    the oracle take a config per trial instead (a length-B sequence)."""
    _check_method(method)
    dev = _device.resolve(device)
    b_n = len(inputs)
    if b_n < 1:
        raise ValueError("needs at least one trial")
    per_trial = [ds] * b_n if isinstance(ds, SensorDataset) else list(ds)
    if len(per_trial) != b_n:
        raise ValueError(f"got {len(per_trial)} datasets for {b_n} trials")
    on_dev: dict[int, SensorDataset] = {}
    for one in per_trial:          # each distinct dataset goes to the device once
        on_dev.setdefault(id(one), _dataset_to(one, dev))
    stacked = hfl.stack_datasets([on_dev[id(one)] for one in per_trial])
    if not isinstance(cfg, hfl.HFLConfig | async_fl.AsyncFLConfig):
        if method not in UNBATCHED or len(cfg) != b_n:
            raise ValueError("a config per trial is for scaffold and centralised, one per trial")
    if method in UNBATCHED:
        cfgs = [cfg] * b_n if isinstance(cfg, hfl.HFLConfig) else list(cfg)
        runs = [_one_trial(method, on_dev[id(one)], c, inp)
                for one, c, inp in zip(per_trial, cfgs, inputs)]
        params = [{k: torch.stack([p[i][k] for p, _ in runs]) for k in layer}
                  for i, layer in enumerate(runs[0][0])]
        out = {k: torch.stack([m[k] for _, m in runs]) for k in runs[0][1]}
    elif method == "hfl-async":
        params, m = async_fl.train_trials([i.params for i in inputs], ae.loss, stacked,
                                          async_config(cfg), [i.dep for i in inputs],
                                          [i.draws for i in inputs])
        out = _async_summary(m)
    else:
        train = flat_fl.train_flat_trials if method in FLAT_METHODS else hfl.train_trials
        params, m = train([i.params for i in inputs], ae.loss, stacked, _run_cfg(method, cfg),
                          [i.dep for i in inputs], [i.draws for i in inputs],
                          client_mesh=client_mesh)
        out = _summary(m)
    f1 = _detector_eval(params, stacked, percentile, point_adjusted)
    out.update(f1=f1.f1, precision=f1.precision, recall=f1.recall)
    if return_params:
        out["params"] = params
    return out


def trial_metrics(
    method: str,
    generator: torch.Generator | None,
    ds: SensorDataset,
    cfg: hfl.HFLConfig,
    *,
    inputs: TrialInputs | None = None,
    percentile: float = 99.0,
    point_adjusted: bool = False,
    hidden: tuple[int, ...] = (16, 8, 16),
    client_mesh: Any = None,
    return_params: bool = False,
    store: Any | None = None,
    device: torch.device | str | None = None,
) -> dict[str, Any]:
    """One trial: train ``method``, evaluate; every value is a tensor on
    the trial's device.

    ``inputs`` (else :func:`draw_trial` from ``generator``) are moved to
    ``device`` (``None`` = the card) with ``ds``.  ``store`` publishes the
    global params every round of a synchronous hierarchical trial
    (``hfl.train``; the flat and async families do not publish);
    ``return_params`` adds the trained model under ``"params"``.  The
    flat methods run as the reference routes them: ``fedprox`` with
    ``prox_mu = PROX_MU``, ``fedadam`` with the FedAdam gateway, and
    ``scaffold`` and ``centralised`` with ``cfg`` as it is.  ``hfl-async``
    runs ``async_fl.train`` on :func:`async_config` of ``cfg`` and adds
    ``merges`` and ``staleness``; its ``sim_time_s`` is the final simulated
    clock, where the round loops report their summed Eq. 21 latency.

    ``client_mesh`` (``launch/sharding.ClientMesh``) shards the client
    axis of the hierarchical and flat rounds over its ranks; every rank
    makes this call with the same arguments and returns the same values.
    ``hfl-async``, ``scaffold`` and ``centralised`` ignore it and run
    whole on every rank, as in the reference.
    """
    _check_method(method)
    dev = _device.resolve(device)
    if inputs is None:
        inputs = draw_trial(generator, ds, cfg, hidden, method)
    ds = _dataset_to(ds, dev)
    if method in UNBATCHED:
        params, out = _one_trial(method, ds, cfg, inputs)
    elif method == "hfl-async":
        params, m = async_fl.train(inputs.params, ae.loss, ds, async_config(cfg), inputs.dep,
                                   inputs.draws)
        out = _async_summary(m)
    else:
        args = (inputs.params, ae.loss, ds, _run_cfg(method, cfg), inputs.dep, inputs.draws)
        if method in FLAT_METHODS:
            params, m = flat_fl.train_flat(*args, client_mesh=client_mesh)
        else:
            params, m = hfl.train(*args, client_mesh=client_mesh, store=store)
        out = _summary(m)
    f1 = _detector_eval(params, ds, percentile, point_adjusted)
    out.update(f1=f1.f1, precision=f1.precision, recall=f1.recall)
    if return_params:
        out["params"] = params
    return out


def run_method(
    method: str,
    ds: SensorDataset,
    cfg: hfl.HFLConfig,
    seed: int = 0,
    percentile: float = 99.0,
    point_adjusted: bool = False,
    hidden: tuple[int, ...] = (16, 8, 16),
    device: torch.device | str | None = None,
) -> ExperimentResult:
    """Train ``method`` on ``ds`` with draws from
    ``torch.Generator().manual_seed(seed)`` and evaluate the paper's
    metrics."""
    m = trial_metrics(
        method, torch.Generator().manual_seed(seed), ds, cfg,
        percentile=percentile, point_adjusted=point_adjusted, hidden=hidden, device=device,
    )
    return ExperimentResult(
        method=method,
        f1=float(m["f1"]),
        precision=float(m["precision"]),
        recall=float(m["recall"]),
        losses=tuple(float(x) for x in m["losses"]),
        participation=float(m["participation"]),
        e_total=float(m["e_total"]),
        e_s2f=float(m["e_s2f"]),
        e_f2f=float(m["e_f2f"]),
        e_f2g=float(m["e_f2g"]),
        coop_links=float(m["coop_links"]),
    )


def audit_trial(
    method: str,
    cfg: hfl.HFLConfig,
    dep: topo.Deployment,
    mobility: torch.Tensor,          # (T, M, 3) standard-normal Gauss-Markov noise
    d: int = 1352,
    l_u: float | None = None,
) -> dict[str, torch.Tensor]:
    """Replay Algorithm 1's association / cooperation / energy accounting
    over ``cfg.rounds`` rounds WITHOUT training (see :func:`audit_method`);
    returns summed energies, mean participation and mean coop links.  A
    deployment with leading trial axes (``Deployment.stack``) and mobility
    (T, B, M, 3) replay B trials at once, each value (B,); ``cfg`` may
    then carry (B,) knobs and ``l_u`` be a (B,) tensor of per-trial
    payloads."""
    if method in ("fedavg", "fedprox", "fedadam", "scaffold"):
        kind = "flat"
    elif method in _RULES:
        kind = "hfl"
    else:
        raise ValueError(f"audit unsupported for {method!r}")
    cfg = hfl.knobs_to(cfg, dep.fog_pos.device)
    if l_u is None:
        l_u = comp.payload_bits(d, cfg.compressor)
    elif isinstance(l_u, torch.Tensor):
        l_u = l_u.to(dep.fog_pos.device)
    l_full = 32.0 * d
    zero = torch.zeros(dep.fog_pos.shape[:-2], device=dep.fog_pos.device)
    rows = []
    for t in range(cfg.rounds):
        if cfg.fog_mobility:
            dep = topo.gauss_markov_step(mobility[t], dep, cfg.deployment)
        if kind == "flat":
            fa = assoc.flat_association(dep, cfg.channel)
            e_up = en.tx_energy_j(l_u, fa.dist_m, cfg.channel, cfg.energy)
            rows.append(dict(
                e_s2f=torch.sum(torch.where(fa.participates, e_up, 0.0), dim=-1),
                e_f2f=zero, e_f2g=zero,
                participation=torch.mean(fa.participates.to(torch.float32), dim=-1),
                coop_links=zero,
            ))
            continue
        fa = assoc.nearest_feasible_fog(dep, cfg.channel)
        decision = coop.decide(_RULES[method], dep.fog_pos, fa.cluster_size, cfg.channel)
        e_up = en.tx_energy_j(l_u, fa.dist_m, cfg.channel, cfg.energy)
        fog_active = fa.cluster_size > 0
        e_ff = en.tx_energy_j(l_full, decision.dist_m, cfg.channel, cfg.energy)
        e_fg = en.tx_energy_j(l_full, fa.fog_gateway_dist_m, cfg.channel, cfg.energy)
        rows.append(dict(
            e_s2f=torch.sum(torch.where(fa.participates, e_up, 0.0), dim=-1),
            e_f2f=torch.sum(torch.where(decision.cooperates & fog_active, e_ff, 0.0), dim=-1),
            e_f2g=torch.sum(torch.where(fog_active & fa.fog_gateway_feasible, e_fg, 0.0),
                            dim=-1),
            participation=torch.mean(fa.participates.to(torch.float32), dim=-1),
            coop_links=torch.sum(decision.cooperates.to(torch.float32), dim=-1),
        ))
    m = {k: torch.stack([r[k] for r in rows]) for k in rows[0]}
    total = {k: torch.sum(m[k], dim=0) for k in ("e_s2f", "e_f2f", "e_f2g")}
    total["e_total"] = total["e_s2f"] + total["e_f2f"] + total["e_f2g"]
    total["participation"] = torch.mean(m["participation"], dim=0)
    total["coop_links"] = torch.mean(m["coop_links"], dim=0)
    return total


def audit_trials(
    methods: Sequence[str],
    cfg: hfl.HFLConfig,
    dep: topo.Deployment,
    mobility: torch.Tensor,
    d: int = 1352,
    l_u: float | torch.Tensor | None = None,
) -> dict[str, torch.Tensor]:
    """:func:`audit_trial` of B trials (leading trial axis) whose methods
    differ: ``methods[b]`` is trial b's.  Each distinct method replays its
    own trials once (a gather of their deployments, mobility, knobs and
    payloads ``l_u`` (B,)), and the results go back in trial order."""
    uniq = tuple(dict.fromkeys(methods))
    if len(uniq) == 1:
        return audit_trial(uniq[0], cfg, dep, mobility, d, l_u)
    dev = dep.fog_pos.device
    out: dict[str, torch.Tensor] = {}
    for m in uniq:
        idx = torch.tensor([b for b, mb in enumerate(methods) if mb == m], device=dev)
        part = audit_trial(
            m, hfl.select_trials(cfg, idx),
            topo.Deployment(*(t[idx] for t in (dep.sensor_pos, dep.fog_pos, dep.fog_vel,
                                                dep.gateway_pos))),
            mobility[:, idx], d, l_u.to(dev)[idx] if isinstance(l_u, torch.Tensor) else l_u)
        for k, v in part.items():
            out.setdefault(k, torch.zeros((len(methods),), dtype=v.dtype, device=dev))[idx] = v
    return out


def audit_method(
    method: str,
    cfg: hfl.HFLConfig,
    d: int = 1352,
    seed: int = 0,
    device: torch.device | str | None = None,
) -> dict:
    """Training-free energy / participation replay of the paper's tables:
    per-round communication energy depends only on the topology, the
    association and cooperation decisions and the payload sizes, so it
    reproduces at full scale cheaply.  The deployment, then the (T, M, 3)
    mobility noise, are drawn from ``torch.Generator().manual_seed(seed)``."""
    g = torch.Generator().manual_seed(seed)
    dep = topo.sample_deployment(g, cfg.deployment, device="cpu")
    mobility = torch.randn((cfg.rounds, cfg.deployment.n_fog, 3), generator=g)
    dev = _device.resolve(device)
    m = audit_trial(method, cfg, dep.to(dev), mobility.to(dev), d)
    out = {k: float(v) for k, v in m.items()}
    out["method"] = method
    return out


def make_config(n_sensors: int, n_fog: int, rounds: int, **overrides: Any) -> hfl.HFLConfig:
    """Paper Table II defaults with per-experiment overrides."""
    dep = topo.DeploymentParams(n_sensors=n_sensors, n_fog=n_fog)
    return hfl.HFLConfig(deployment=dep, rounds=rounds).replace(**overrides)


def seed_sweep(
    method: str,
    ds_fn: Callable[[int], SensorDataset],
    cfg: hfl.HFLConfig,
    seeds: tuple[int, ...] = (0, 1, 2),
    **kw: Any,
) -> tuple[ExperimentResult, ...]:
    """Run ``method`` over seeds; ``ds_fn(seed) -> SensorDataset``, and
    each trial draws from ``torch.Generator().manual_seed(seed)``
    (:func:`run_method`)."""
    return tuple(run_method(method, ds_fn(s), cfg, seed=s, **kw) for s in seeds)


def mean_std(values: list[float]) -> tuple[float, float]:
    """Mean and population standard deviation (ddof 0) in f32, as the
    reference's ``jnp.mean`` / ``jnp.std``."""
    arr = torch.as_tensor(values, dtype=torch.float32)
    return float(torch.mean(arr)), float(torch.std(arr, correction=0))
