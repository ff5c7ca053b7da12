"""The system under test: the port's batched trial call, fed the
benchmark's inputs in the port's own types.

This module is the only one of the benchmark that imports the port
(``repro_torch``, from ``src/`` of the checkout).  It builds the port's
round configuration from the configuration file and the traffic mix,
wraps the drawn inputs as ``TrialInputs`` and ``SensorDataset``, makes the
call that ``Engine.run`` makes (``experiment.batched_trial_metrics`` with
``return_params``), and reads the port's launch counters.
"""
from __future__ import annotations

import sys
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"


def _import():
    if not (SRC / "repro_torch").is_dir():
        raise ImportError(f"the port's package is not at {SRC / 'repro_torch'}")
    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))
    from repro_torch.core import channel, compression, cooperation, energy, faults, hfl, topology
    from repro_torch.data.synthetic import SensorDataset
    from repro_torch.kernels import fused_agg, local_train, robust_agg
    from repro_torch.launch import experiment
    return dict(channel=channel, compression=compression, cooperation=cooperation, energy=energy,
                faults=faults, hfl=hfl, topology=topology, SensorDataset=SensorDataset,
                experiment=experiment, counters=(local_train, fused_agg, robust_agg))


class Program:
    """The port set up for one cell: ``call(inputs)`` runs one batch of
    trials and returns the port's result dict (``"params"`` included),
    without waiting for the card."""

    def __init__(self, cfg: dict, mix: dict, device):
        self.m = _import()
        self.device = device
        self.cfg = self._config(cfg, mix)
        self.method = mix["method"]
        self.percentile = mix["percentile"]

    def _config(self, cfg: dict, mix: dict):
        m = self.m
        dp, trn, comp = cfg["deployment"], cfg["training"], cfg["compressor"]
        deployment = m["topology"].DeploymentParams(
            lx_m=dp["lx_m"], ly_m=dp["ly_m"], depth_m=dp["depth_m"], n_sensors=dp["n_sensors"],
            n_fog=dp["n_fog"], sensor_depth=tuple(dp["sensor_depth"]),
            fog_depth=tuple(dp["fog_depth"]), fog_speed_m_s=dp["fog_speed_m_s"],
            gm_alpha=dp["gm_alpha"], round_interval_s=dp["round_interval_s"])
        faults = mix.get("faults")
        fault_cfg = (m["faults"].FaultConfig(**faults) if faults
                     else m["faults"].FaultConfig())
        return m["hfl"].HFLConfig(
            rule=m["cooperation"].CoopRule(mix["rule"]), rounds=trn["rounds"],
            local_epochs=trn["local_epochs"], batch_size=trn["batch_size"], lr=trn["lr"],
            compressor=m["compression"].CompressorConfig(
                rho_s=comp["rho_s"], quant_bits=comp["quant_bits"], mode=comp["mode"],
                fused=comp["fused"]),
            fog_mobility=dp["fog_mobility"], compute_rate_flops=trn["compute_rate_flops"],
            channel=m["channel"].ChannelParams(**cfg["channel"]),
            energy=m["energy"].EnergyParams(**cfg["energy"]),
            deployment=deployment, robust=mix["fog_reduce"], trim_frac=mix.get("trim_frac", 0.0),
            faults=fault_cfg, client_chunk=mix.get("client_chunk"))

    def inputs(self, trials: list) -> tuple[list, list]:
        """The drawn trials (``(telemetry, params, deployment, draws)``
        each) as the port's ``TrialInputs`` and ``SensorDataset`` lists."""
        m = self.m
        ins, data = [], []
        for tel, params, dep, draws in trials:
            ins.append(m["experiment"].TrialInputs(
                [dict(layer) for layer in params], m["topology"].Deployment(*dep),
                m["hfl"].RoundDraws(*draws)))
            data.append(m["SensorDataset"](*tel))
        return ins, data

    def call(self, prepared: tuple[list, list]) -> dict:
        ins, data = prepared
        return self.m["experiment"].batched_trial_metrics(
            self.method, ins, data, self.cfg, percentile=self.percentile, return_params=True,
            device=self.device)

    def launches(self) -> dict[str, int]:
        """The port's launch counters, summed over its kernel modules."""
        out = {}
        for mod in self.m["counters"]:
            out.update(mod.LAUNCHES)
        return dict(out)
