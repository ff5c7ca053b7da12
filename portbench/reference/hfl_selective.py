"""The reference of the ``hfl-selective`` method: T rounds of paper
Algorithm 1 for B trials at once, in plain PyTorch.

It follows the structure of ``src/repro_torch/core/hfl.py``'s round at
commit 503575e07401e7f10a9c0026dea9d563d82ebbba (the trials leading every
tensor, trial b's fogs offset by b * M for the fog reduce), with the
kernels replaced by ``plain`` and the physics by ``physics``.  It reads
only the configuration file's numbers, the traffic mix's and the inputs
that the benchmark drew; it imports nothing of the program.  The harness
finds a method's reference by its name (``reference/<method>.py``, ``-``
read as ``_``); ``check`` refuses a configuration or a mix that asks for
anything this module does not implement.

Per round: Gauss-Markov fog drift; nearest-feasible-fog association; the
battery and crash gates; cooperation on the round-active cluster sizes;
the client phase (E epochs of minibatch SGD); erasures and Gaussian
Byzantine deltas; EF top-k int8 compression with the fog reduce (the
weighted mean one shot or chunk by chunk on the wire, or the weighted
trimmed mean over per-client reconstructions); Eq. 15's cooperative mix;
the gateway's weighted mean (Eq. 16); the energies (Eqs. 17-20), latency
(Eq. 21) and batteries.
"""
from __future__ import annotations

import torch

from . import physics as ph
from . import plain
from .common import payload_bits, ravel, unravel, weighted_mean

METHOD = "hfl-selective"
MIX_KEYS = {"trials", "method", "rule", "fog_reduce", "trim_frac", "client_chunk", "faults",
            "percentile", "why"}
FAULT_KEYS = {"byz_mode", "byz_frac", "byz_scale", "erasure_prob", "crash_prob"}
RULES = ("selective",)      # the method's own rule: the program's method name sets it
REDUCES = ("mean", "trimmed")


def check(cfg: dict, mix: dict) -> None:
    """Raise ValueError naming every knob of ``cfg`` or ``mix`` that this
    reference does not implement."""
    bad = []
    if mix.get("method") != METHOD:
        bad.append(f"method {mix.get('method')!r}")
    bad += [f"traffic key {k!r}" for k in sorted(set(mix) - MIX_KEYS)]
    if mix.get("rule") not in RULES:
        bad.append(f"rule {mix.get('rule')!r}")
    if mix.get("fog_reduce") not in REDUCES:
        bad.append(f"fog_reduce {mix.get('fog_reduce')!r}")
    if mix.get("fog_reduce") != "trimmed" and mix.get("trim_frac"):
        bad.append("trim_frac without the trimmed reduce")
    faults = mix.get("faults") or {}
    bad += [f"fault key {k!r}" for k in sorted(set(faults) - FAULT_KEYS)]
    if faults.get("byz_frac", 0.0) > 0.0 and faults.get("byz_mode") != "gauss":
        bad.append(f"byz_mode {faults.get('byz_mode')!r}")
    comp, model, dp = cfg["compressor"], cfg["model"], cfg["deployment"]
    if comp.get("mode") != "blockwise" or comp.get("quant_bits") != 8:
        bad.append(f"compressor {comp.get('mode')!r} at {comp.get('quant_bits')!r} bits")
    if model.get("activation") != "tanh":
        bad.append(f"activation {model.get('activation')!r}")
    if dp.get("fog_mobility") is not True:
        bad.append("fogs that do not drift (fog_mobility)")
    if bad:
        raise ValueError(f"the {METHOD} reference does not implement: " + "; ".join(bad))


def train(cfg: dict, cell: dict, data, params0: list[dict], dep, draws, lowp: bool = False):
    """B trials (every input leads with B; ``draws`` (T, B, ...)) through
    ``cell["rounds"]`` rounds.  Returns (final params (B, d), per-round
    metrics {name: (T, B)})."""
    model, trn, comp = cfg["model"], cfg["training"], cfg["compressor"]
    chn, en, dp = cfg["channel"], cfg["energy"], cfg["deployment"]
    dims = (model["feature_dim"], *model["hidden"], model["feature_dim"])
    train_x = data.train
    b_n, n, window, dim = train_x.shape
    n_fog = dp["n_fog"]
    dev = train_x.device
    flat = ravel(params0).clone()
    d = flat.shape[-1]
    err = torch.zeros((b_n, n, d), dtype=torch.float32, device=dev)
    battery = torch.full((b_n, n), en["e_init_j"], dtype=torch.float32, device=dev)
    fog_pos, fog_vel = dep.fog_pos, dep.fog_vel
    faults = cell.get("faults")
    robust = cell["fog_reduce"] == "trimmed"
    chunk = cell.get("client_chunk")
    fog_base = torch.arange(b_n, dtype=torch.int32, device=dev)[:, None] * n_fog
    k = plain.block_k(plain.blockwise_k_frac(d, comp["rho_s"]))
    flops = ph.autoencoder_flops(dims, window, trn["local_epochs"])
    lat_comp = flops / trn["compute_rate_flops"]
    e_comp = float(en["eps_op_j"] * ph.f32(flops))
    l_u, l_full = payload_bits(d, comp), 32.0 * d
    rows = []
    for t in range(cell["rounds"]):
        fog_pos, fog_vel = ph.gauss_markov_step(draws.mobility[t], fog_pos, fog_vel, dp)
        fa = ph.nearest_feasible_fog(dep.sensor_pos, fog_pos, dep.gateway_pos, chn)
        active = fa["participates"] & (battery > en["e_min_j"])
        if faults:
            active = active & ~(draws.crash[t] < torch.tensor(faults["crash_prob"],
                                                               dtype=torch.float32))
        c_active = ph.cluster_sizes(fa["fog_id"], active, n_fog)
        decision = ph.cooperation(cell["rule"], fog_pos, c_active, chn)
        active_f = active.to(torch.float32)
        if faults:
            erased = active & (draws.erase[t] < torch.tensor(faults["erasure_prob"],
                                                             dtype=torch.float32))
        else:
            erased = torch.zeros_like(active)
        delivered = active & ~erased
        weights = data.n_samples * delivered.to(torch.float32)
        layers = unravel(flat, dims)
        deltas, losses = plain.local_train(
            train_x.reshape(b_n * n, window, dim),
            draws.batches[t].reshape((b_n * n,) + tuple(draws.batches.shape[-2:])),
            tuple(lay["w"] for lay in layers), tuple(lay["b"] for lay in layers),
            trn["lr"], lowp)
        deltas = deltas.view(b_n, n, d)
        losses = losses.view(b_n, n)
        if faults:
            pos = (torch.arange(n, dtype=torch.float32, device=dev) + 0.5) / n
            byz = pos < torch.tensor(faults["byz_frac"], dtype=torch.float32)
            attacked = torch.tensor(faults["byz_scale"], dtype=torch.float32) * draws.byz_noise[t]
            deltas = torch.where(byz[..., None], attacked, deltas)
        n_nonfinite = torch.sum(delivered & ~torch.all(torch.isfinite(deltas), dim=-1), dim=-1)
        fog_id = (fa["fog_id"] + fog_base).reshape(-1)
        d_f, e_f, w_f = deltas.reshape(b_n * n, d), err.reshape(b_n * n, d), weights.reshape(-1)
        finite = torch.all(torch.isfinite(d_f), dim=-1) & torch.all(torch.isfinite(e_f), dim=-1)
        d_f = torch.where(finite[:, None], d_f, 0.0)
        e_f = torch.where(finite[:, None], e_f, 0.0)
        w_f = w_f * finite.to(w_f.dtype)
        m_all = b_n * n_fog
        fog_weight = plain.segment_sum(w_f, fog_id, m_all)
        if robust:
            v, recon = plain.dense_recon(d_f, e_f, k)
            recon = recon.reshape(b_n * n, -1)[:, :d]
            new_err = (v.reshape(b_n * n, -1)[:, :d] - recon)
            fog_delta = plain.trimmed_mean(recon, fog_id, w_f, m_all, cell["trim_frac"])
        elif chunk is None or chunk >= b_n * n:
            fog_sum, new_err = plain.dense_fold(d_f, e_f, fog_id, w_f, m_all, k)
            fog_delta = fog_sum / torch.clamp_min(fog_weight, 1e-12)[:, None]
        else:
            fog_sum = torch.zeros((m_all, d), dtype=torch.float32, device=dev)
            new_err = torch.empty((b_n * n, d), dtype=torch.float32, device=dev)
            for s in range(0, b_n * n, chunk):
                e = min(s + chunk, b_n * n)
                idx, q, scale, new_err[s:e] = plain.compress_wire(d_f[s:e], e_f[s:e], k)
                plain.wire_fold(idx, q, scale, fog_id[s:e], w_f[s:e], fog_sum)
            fog_delta = fog_sum / torch.clamp_min(fog_weight, 1e-12)[:, None]
        fog_delta = fog_delta.view(b_n, n_fog, d)
        fog_weight = fog_weight.view(b_n, n_fog)
        err = torch.where(active[..., None], new_err.view(b_n, n, d), err)

        fog_model = fog_delta + flat[..., None, :]
        peer = torch.take_along_dim(fog_model, decision["partner"][..., None], dim=-2)
        mixed = torch.addcmul(decision["partner_weight"][..., None] * peer,
                              decision["self_weight"][..., None], fog_model)     # Eq. 15
        new_flat = weighted_mean(mixed, fog_weight, flat, lowp)                  # Eq. 16

        e_up = torch.where(active, ph.tx_energy_j(l_u, fa["dist_m"], chn, en), 0.0)
        fog_active = fog_weight > 0
        coop_on = decision["cooperates"] & fog_active
        e_ff = ph.tx_energy_j(l_full, decision["dist_m"], chn, en)
        e_fg = ph.tx_energy_j(l_full, fa["fog_gateway_dist_m"], chn, en)
        e_s2f = torch.sum(e_up, dim=-1)
        e_f2f = torch.sum(torch.where(coop_on, e_ff, 0.0), dim=-1)
        e_f2g = torch.sum(torch.where(fog_active & fa["fog_gateway_feasible"], e_fg, 0.0),
                          dim=-1)
        lat_up = torch.amax(torch.where(active, ph.link_latency_s(l_u, fa["dist_m"], chn), 0.0),
                            dim=-1)
        lat_ff = torch.amax(torch.where(coop_on, ph.link_latency_s(l_full, decision["dist_m"],
                                                                   chn), 0.0), dim=-1)
        lat_fg = torch.amax(torch.where(fog_active, ph.link_latency_s(
            l_full, fa["fog_gateway_dist_m"], chn), 0.0), dim=-1)
        spent = e_up + torch.where(active, e_comp, 0.0)
        battery = torch.clamp_min(battery - spent, en["e_min_j"])
        rows.append(dict(
            loss=(torch.sum(losses * active_f, dim=-1)
                  / torch.clamp_min(torch.sum(active_f, dim=-1), 1.0)),
            e_s2f=e_s2f, e_f2f=e_f2f, e_f2g=e_f2g, e_total=e_s2f + e_f2f + e_f2g,
            latency_s=torch.maximum(torch.maximum(lat_up, lat_ff), lat_fg) + lat_comp,
            participation=torch.mean(active_f, dim=-1),
            coop_links=torch.sum(decision["cooperates"].to(torch.int32), dim=-1),
            n_nonfinite=n_nonfinite.to(torch.int32),
            n_erased=torch.sum(erased.to(torch.int32), dim=-1),
            global_finite=torch.all(torch.isfinite(new_flat), dim=-1)))
        flat = new_flat
    return flat, {key: torch.stack([r[key] for r in rows]) for key in rows[0]}


