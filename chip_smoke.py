#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one Hopper card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one sm_90 CUDA card, nvcc (``$CUDA_HOME`` or ``/usr/local/cuda``),
the port's sources beside it (``src/repro_torch``; without them it exits 1)
and nothing of JAX.  Phases, in order; any failure exits non-zero before
the result line:

1. device  — name, capability, count, ``nvidia-smi`` name and power limit;
2. build   — every kernel source in ``kernels/csrc`` with nvcc for sm_90a,
             one nvcc each, all started together, printing ptxas's
             registers, shared memory and spills;
3. kernels — each score kernel against its plain PyTorch version on the card at
             rows 1..65,536, at the paper AE and at d=130 (64, 8, 64), with
             per-row tau and a NaN row (err to rtol=atol=1e-5, flags
             exactly away from tau);
4. serving — the main path: ``ScoringService`` on the card over the
             200-sensor / 20-fog synthetic fleet (f32, then int8 weights):
             per-fog streaming calibration, one request per sensor, a
             publish + poll hot-swap, a second wave, drain; every result is
             held against CPU plain scoring, and each kernel's launches
             must equal the service's steps plus its validation chunks;
5. load    — an MMPP trace replayed open-loop on a virtual clock;
6. timing  — each score kernel at 128 / 1,024 / 65,536 rows, and the two
             training kernels at the train-200 shapes, beside their plain
             versions and their bounds: device time per call from
             torch.profiler (CUPTI; ``ms`` and ``plain_ms``, and the run
             fails when the profiler records no device time), and per-call
             time by CUDA events over back-to-back calls, host dispatch
             included (``call_ms`` and ``plain_call_ms``); the launch floor
             (an empty kernel's device and per-call time); the wrappers'
             host cost before and after (``score_rows`` with its pointer
             arrays rebuilt every call or kept, ``compress_wire_blocks``
             with the attribute call every launch or once);
7. training kernels — ``local_train_f32`` (N 1 / 13 / 200, window 48 /
             256, the paper AE and d=130, mu 0 / 0.01) and ``fused_agg``
             (d 1,352 / 8,209 / 65,536, N 1 / 200 / 2,000, 20 fogs, int8 on
             and off, zero weights and an empty fog) against their plain
             versions on the card: survivor sets exactly, new_err to
             atol=1e-5, fog sums to rtol=1e-5 / atol=1e-4, deltas to
             rtol=1e-4 / atol=1e-6, losses to rtol=1e-5;
8. training — the main path of the training slice: one ``hfl-selective``
             trial (``launch/experiment.trial_metrics``) at full width, 200
             sensors, 20 fogs, window 256, E = 5, batch 32, 20 rounds,
             blockwise rho_s 0.05 int8, publishing every round to a
             ``CheckpointStore``; the same trial on the CPU with the plain
             versions and identical draws; per-round participation, links
             and energies to rtol=1e-5, loss within 1%, F1 within 0.02; a
             timed 20-round ``hfl.train`` (ms per round) and a profiled one
             (device busy share);
9. robust-200 — the Byzantine-robust path: train-200 with 25% Gaussian
             Byzantine clients at byz_scale 20 and erasure 0.3 (the
             robustness benchmark's hardest cell), ``robust="trimmed"``,
             trim 0.45, on the card and on the CPU with identical draws
             (participation and erasures exactly, energies to rtol=1e-5,
             loss within 1%, F1 within 0.02); median and mean on the card;
             trimmed at ``client_chunk=64`` bitwise equal to unchunked;
10. fleet-10k — the client-chunked path: N = 10,000 sensors, M = 1,000
             fogs, T = 5, robust mean, no faults, at ``client_chunk=512``
             (the sparse wire: ``wire_emit`` and ``wire_agg`` 20 times a
             round each, ``fused_agg`` never) and unchunked (``fused_agg``
             twice a round), both on the card: per-round participation and
             energies to rtol=1e-5, loss within 1%, F1 within 0.02; ms per
             round and peak device memory of each;
11. compressor kernels — ``compress_q8``, ``topk_ef`` and ``quant8``
             against their plain versions on the card (d 1,352 / 8,209 /
             65,536, N 1 / 200 / 2,000, keep fractions rho_s 0.05,
             rho_s 1 and 1/8,192, an all-zero row and a row tying more than
             k entries at each block max): codes, scales, sparse values,
             new_err, payload bits and survivor sets bitwise, the
             survivor sets equal to ``fused_agg``'s, and ``wire_emit``'s
             new_err equal to ``compress_q8``'s (the two selections);
12. legacy-200 — train-200 with the per-client compressor:
             ``CompressorConfig(fused=False)`` (``compress_q8`` once a
             round) on the card and on the CPU with identical draws
             (participation exactly, energies to rtol=1e-5, loss within 1%,
             F1 within 0.02) and against phase 8's fused trial (loss within
             1%, F1 within 0.02; on round 0's updates the same error
             feedback bitwise, fog sums to rtol=1e-5 / atol=1e-4);
             ``fused=False, quant_bits=32`` (``topk_ef``) and quantise-only
             ``rho_s=1`` (``compress_q8`` at k = 1,352) on the card; ms per
             round of each; then the int8 codec front door
             (``ops.quant8`` / ``ops.dequant8``) on round 0's updates;
13. drift-200 — train-200 in the drift benchmark's world (its compact
             basin and 135 dB source-level cap at N = 200, M = 20) in its
             three cells: static, frozen (current 3 m/s, no
             re-association) and re-association every 2 rounds; the last on
             the card and on the CPU with identical draws (per-round
             participation exactly, energies to rtol=1e-5, loss within 1%,
             F1 within 0.02); mean participation and F1 of each (their
             order is recorded, not gated);
14. swa_decode — the sliding-window decode-attention kernel against its
             plain version over (B, Hq, Hkv, d) in {(8, 10, 1, 256), (8, 32,
             8, 128), (2, 8, 2, 64), (2, 8, 8, 64), (2, 4, 1, 128)}, S in
             {64, 161, 321, 512, 2,233, 4,096} (161 and 321 are
             dense-decode's and hybrid-serve's caches), window in {64,
             2,048, 2^30}, f32 and bf16, per-row lengths 1, window -+ 1, window, S and one past
             S + window (f32 to rtol=1e-4 / atol=2e-5, bf16 equal or one
             ulp apart or within 2e-5, the empty window zeros), K/V outside
             the window perturbed leaving the output bitwise equal, and
             repeated calls bitwise equal (the splits merge in a fixed
             order); timed at hybrid-window's and at dense-decode's shapes
             beside its plain version, its bytes bound and
             ``scaled_dot_product_attention`` (the yardstick);
15. hybrid-serve — the LM main path: recurrentgemma-2b's published config
             (26 layers, bf16, random weights from seed 0) through
             ``launch/serve`` at batch 8, prompt 256 + 64 greedy tokens:
             tokens/s, ms per decode step, peak memory, ``swa_decode``
             launches = 8 x 320; then, from the decode's
             final cache, one more step whose ``swa_decode`` calls (the
             real q, caches and lengths) are held against the plain
             version at phase 14's tolerances, and the device time and
             idle share of the 5 steps after it; hybrid-window (3 layers at
             full width, 2,200 + 32, the window slides; launches = steps;
             the same check and profile); the card against the CPU,
             teacher-forced (full width 3 layers f32 batch 2 x 48 steps,
             REDUCED f32 and bf16 x 160 steps: f32 max |dlogit| <= 1e-3 x
             max |logit|, bf16 recorded);
16. dense-decode — llama3-8b at full width cut to 2 layers, batch 8, 128 +
             32 (``swa_decode`` launches = 2 x 160, the "global" window
             2^30; the same check and profile as phase 15's), the card
             against the CPU in f32 (2 layers, batch 2, 32
             steps), and gemma2-27b REDUCED against the CPU (soft-capped
             layers: no ``swa_decode`` launch).

Phase 6 also times ``robust_agg``, ``wire_emit`` and ``wire_agg`` at the
shapes of phases 9 and 10, ``compress_q8`` and ``topk_ef`` at train-200's
shape and ``compress_q8`` again at fleet-10k's chunk (the unchanged
control beside ``wire_emit``), and ``quant8`` on a 2^20-coordinate
vector; phase 7 holds the robust and wire kernels against their plain
versions over a grid and at fleet-10k's shapes (``fused_agg`` at N =
10,000 into 1,000 fogs, the wire pair chunk by chunk into running sums,
``robust_agg`` at N = 30,000 with a fog of 3,000), the wire's slots,
codes, scales and new_err bitwise, and ``wire_emit`` over its edges
(widths 1 to 65,536 on both team sizes, k = 1 to 8,192, zero and tied
rows).

The launch counts reported for the score kernels are those of phases 4
and 5 (the counters are zeroed just before phase 4 and read just after
phase 5), for the training kernels those of phase 8's trial, for
``robust_agg`` those of phase 9's trimmed trial on the card and for the
wire kernels those of phase 10's chunked trial, for ``compress_q8`` and
``topk_ef`` those of phase 12's first and second trials and for
``quant8`` those of phase 12's codec run and for ``swa_decode`` those of
phase 15's hybrid-serve run (each zeroed just before its run, read just
after; phases 15–16 check the other runs' counts too).  The last line is
``{"ok": true, "device": {...}}``; the line before it is the card's name and power limit, and the
one before that the ``kernels`` JSON.
"""
from __future__ import annotations

import ctypes
import importlib
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

D, HIDDEN = 32, (16, 8, 16)              # paper Table II autoencoder
WIDE = (130, (64, 8, 64))                # a feature dim above 128 lanes
CHECK_ROWS = (1, 127, 128, 1024, 25_600, 65_536)
TIME_ROWS = (128, 1024, 65_536)          # small bucket, large bucket, fleet x window
HEADLINE_ROWS = 1024                     # the service's large bucket
N_SENSORS, N_FOG, VAL_LEN, TEST_LEN = 200, 20, 64, 128
BUCKETS, MAX_WAIT_S = (128, 1024), 0.02
PEAK_BYTES_S = 3.35e12                   # H100 SXM HBM3
PEAK_F32_FLOP_S = 67e12                  # H100 SXM f32, CUDA cores
KERNELS = {
    "fused_score_f32": "src/repro/kernels/fused_score.py:39",
    "fused_score_q8": "src/repro/kernels/fused_score.py:55",
}
TRAIN_KERNELS = {   # name -> (TPU kernel it replaces, CUDA source)
    "local_train_f32": ("src/repro/kernels/fused_local_train.py:58",
                        "src/repro_torch/kernels/csrc/local_train.cu"),
    "fused_agg": ("src/repro/kernels/fused_agg.py:37",
                  "src/repro_torch/kernels/csrc/fused_agg.cu"),
}
# train-200: paper Table II at N = 200 (synthetic defaults: window 256, val
# 64, test 128, D = 32), M = N/10, E = 5, batch 32, T = 20, rho_s 0.05 int8.
TRAIN_N, TRAIN_FOG, WINDOW, EPOCHS, BATCH, ROUNDS, LR = 200, 20, 256, 5, 32, 20, 0.01
AGG_DS, AGG_NS = (1352, 8209, 65_536), (1, 200, 2000)
NEW_KERNELS = {     # name -> (TPU kernel it replaces, CUDA source)
    "robust_agg": ("src/repro/kernels/robust_agg.py:45",
                   "src/repro_torch/kernels/csrc/robust_agg.cu"),
    "wire_emit": ("src/repro/kernels/fused_agg.py:90",
                  "src/repro_torch/kernels/csrc/fused_agg.cu"),
    "wire_agg": ("src/repro/kernels/fused_agg.py:150",
                 "src/repro_torch/kernels/csrc/fused_agg.cu"),
}
# robust-200: train-200 under the robustness benchmark's hardest attack
# (experiments/bench/robustness_bench.json): 25% Gaussian Byzantine clients at scale 20 and
# erasure 0.3, with the weighted trimmed mean at trim 0.45.
ROBUST_FAULTS = dict(byz_mode="gauss", byz_frac=0.25, byz_scale=20.0, erasure_prob=0.3)
ROBUST_TRIM, ROBUST_CHUNK = 0.45, 64
ROBUST_MODES = (("trimmed", 0.0), ("trimmed", 0.2), ("trimmed", 0.45), ("median", 0.0))
ROBUST_NS, ROBUST_DS = (1, 13, 200, 2000), (1352, 8209)
WIRE_KS = (68, 410)              # rho_s 0.05 of d = 1,352, and of a whole block
# fleet-10k: the synthetic settings of train-200 at N = 10,000, M = N/10, T = 5.
FLEET_N, FLEET_FOG, FLEET_ROUNDS, FLEET_CHUNK = 10_000, 1_000, 5, 512
# robust_agg at a large fleet: N clients in FLEET_FOG fogs, fog 0 holding
# more members than the kernel stages in shared memory at once (1,024).
BIG_ROBUST_N, BIG_ROBUST_FOG0 = 30_000, 3_000
COMPRESS_KERNELS = {   # name -> (TPU kernel it replaces, CUDA source)
    "compress_q8": ("src/repro/kernels/quant8.py:54", "src/repro_torch/kernels/csrc/quant8.cu"),
    "topk_ef": ("src/repro/kernels/topk_ef.py:30", "src/repro_torch/kernels/csrc/topk_ef.cu"),
    "quant8": ("src/repro/kernels/quant8.py:22", "src/repro_torch/kernels/csrc/quant8.cu"),
}
COMP_DS, COMP_NS = (1352, 8209, 65_536), (1, 200, 2000)
QUANT8_D = 1 << 20               # phase 6: quant8 on one 2^20-coordinate vector
# drift-200: benchmarks/drift_bench.py's world (a compact basin and a 135 dB
# source-level cap, ~580 m of range) at train-200's N and M; its cells.
DRIFT_BASIN = dict(lx_m=1200.0, ly_m=1200.0, depth_m=400.0, sensor_depth=(200.0, 350.0),
                   fog_depth=(50.0, 150.0))
DRIFT_SL_MAX_DB, DRIFT_CURRENT, DRIFT_REASSOC = 135.0, 3.0, 2.0


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


START = time.perf_counter()
PHASE_S: dict[str, float] = {}        # seconds per phase, in order


def phase(name: str) -> None:
    now = time.perf_counter() - START
    if PHASE_S:
        last = next(reversed(PHASE_S))
        PHASE_S[last] = now - PHASE_S[last]
    PHASE_S[name] = now
    print(f"\n=== {name}  (t = {now:.1f} s)", flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def layer_tuples(params, q8: bool):
    keys = ("qw", "sw", "b") if q8 else ("w", "b")
    return tuple(tuple(layer[k] for layer in params) for k in keys)


def compare(err, flag, err_ref, flag_ref, tau) -> float:
    """Hold a kernel's output against the plain version; max |err diff|."""
    err, flag, err_ref, flag_ref, tau = (
        t.detach().cpu().numpy() for t in (err, flag, err_ref, flag_ref, tau)
    )
    check(np.array_equal(np.isnan(err), np.isnan(err_ref)), "NaN rows differ")
    fin = np.isfinite(err_ref)
    np.testing.assert_allclose(err[fin], err_ref[fin], rtol=1e-5, atol=1e-5)
    with np.errstate(invalid="ignore"):
        near = np.abs(err_ref - tau) <= 1e-5 * np.maximum(1.0, np.abs(tau))
    np.testing.assert_array_equal(flag[~near], flag_ref[~near])
    return float(np.max(np.abs(err[fin] - err_ref[fin]))) if fin.any() else 0.0


def kernel_case(ae, quantize_params, d, hidden, rows, q8, dev, seed):
    g = torch.Generator().manual_seed(seed)
    params = ae.init(g, d, hidden, device=dev)
    if q8:
        params = quantize_params(params)
    x = torch.randn((rows, d), generator=g).to(dev)
    if rows > 2:
        x[rows // 3] = float("nan")
    tau = (torch.rand((rows,), generator=g) * 2.0 * d).to(dev)
    return params, x, tau


def work(d, hidden, rows, q8) -> tuple[int, int]:
    """(bytes, operations) one score call needs: each input read once,
    each output written once; FMAs count 2, bias adds, tanh and the
    error's subtract / square / add 1 each."""
    dims = (d, *hidden, d)
    layers = list(zip(dims[:-1], dims[1:]))
    w_bytes = sum(a * b * (1 if q8 else 4) + b * (8 if q8 else 4) for a, b in layers)
    bytes_ = rows * (d * 4 + 4) + w_bytes + rows * (4 + 1)
    ops_row = sum(2 * a * b + b for a, b in layers) + sum(hidden) + 3 * d + 1
    return bytes_, rows * ops_row


def bound(d, hidden, rows, q8) -> tuple[float, str]:
    return bound_from(*work(d, hidden, rows, q8))


def call_ms(fn, n: int) -> float:
    """Per-call time of ``n`` back-to-back calls by CUDA events: what a
    caller pays, host dispatch included (the card idles when the host is
    slower than the kernel)."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


PROFILE_TRIES = 3     # traces of one measurement before an empty one fails the run


def device_events(run) -> list:
    """The device activities of torch.profiler's CUPTI trace of ``run()``
    (which ends in a ``torch.cuda.synchronize``).  A trace that comes back
    without device activity is taken again, up to ``PROFILE_TRIES``
    traces; the run fails when none recorded any."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
        dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if dev:
            return dev
        print(f"  torch.profiler recorded no device time (trace {attempt + 1} of "
              f"{PROFILE_TRIES})")
    check(False, "torch.profiler recorded no device time")


def device_ms(fn, n: int) -> tuple[float, float]:
    """(device ms per call, device activities per call) over ``n`` calls,
    from torch.profiler's CUPTI trace (:func:`device_events`)."""
    fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(n):
            fn()
        torch.cuda.synchronize()

    dev = device_events(run)
    return sum(e.time_range.elapsed_us() for e in dev) / 1e3 / n, len(dev) / n


def serve_fleet(mods, ds, weight_dtype, workdir):
    """Phase 4 for one weight dtype; returns (service, launches, F1 per wave)."""
    ae, anomaly, CheckpointStore, ScoringService, StreamingCalibrator, fs, score_mod = mods
    store = CheckpointStore(str(workdir / weight_dtype), keep=2)
    params = ae.init(torch.Generator().manual_seed(0), D, HIDDEN, device="cpu")
    swapped = [{k: v * 0.9 for k, v in layer.items()} for layer in params]
    store.publish(1, params)
    calib = StreamingCalibrator(capacity=16_384, n_fog=N_FOG, percentile=99.0)
    svc = ScoringService(store, params, buckets=BUCKETS, max_wait_s=MAX_WAIT_S,
                         calibrator=calib, weight_dtype=weight_dtype)
    check(svc.device.type == "cuda", f"service resolved to {svc.device}")
    fog_id = np.arange(N_SENSORS) % N_FOG
    before = dict(fs.LAUNCHES)
    val_err = svc.ingest_validation(ds.val, fog_id[:, None])
    n_val_chunks = -(-N_SENSORS * VAL_LEN // svc.batch_rows)
    taus = calib.taus()
    check(bool(torch.isfinite(taus).all()), "calibrated thresholds are not finite")

    q8 = weight_dtype == "int8"
    cpu_score = score_mod.score_q8 if q8 else score_mod.score
    test = ds.test.cpu()
    f1s = []
    for wave, wparams in enumerate((params, swapped)):
        if wave == 1:
            store.publish(2, swapped)
            check(svc.poll() and svc.loaded_step == 2, "hot-swap did not happen")
        rids = []
        for i in range(N_SENSORS):
            rids.append(svc.submit(ds.test[i], fog=int(fog_id[i])))
            svc.pump()
        res = svc.drain()
        check(sorted(res) == sorted(rids), "not every request completed")
        ref_params = score_mod.quantize_params(wparams) if q8 else wparams
        tau_rows = taus[torch.from_numpy(fog_id)][:, None].expand(N_SENSORS, TEST_LEN)
        ref = cpu_score(ref_params, test, tau_rows)
        err = np.stack([res[r].error for r in rids])
        flag = np.stack([res[r].flag for r in rids])
        compare(torch.from_numpy(err), torch.from_numpy(flag), ref.error, ref.flag,
                tau_rows.contiguous())
        f1 = anomaly.pointwise_f1(torch.from_numpy(flag), ds.test_label.cpu())
        f1s.append(float(f1.f1))
    name = "fused_score_q8" if q8 else "fused_score_f32"
    other = "fused_score_f32" if q8 else "fused_score_q8"
    launched = fs.LAUNCHES[name] - before[name]
    check(launched == svc.stats.steps + n_val_chunks,
          f"{name} launched {launched} times for {svc.stats.steps} steps "
          f"+ {n_val_chunks} validation chunks")
    check(fs.LAUNCHES[other] == before[other], f"{other} launched on the {weight_dtype} path")
    check(svc.stats.swaps == 1 and svc.stats.dropped == 0, "unexpected swap/drop counts")
    check(set(svc.stats.compiles_by_bucket.values()) == {1}, "a bucket prepared twice")
    check(val_err.shape == (N_SENSORS * VAL_LEN,), "validation error shape")
    return svc, launched, f1s


def train_work(dims, n, window, steps, batch, prox) -> tuple[int, int]:
    """(bytes, operations) of one local-train call: windows, index table
    and params read once, deltas and losses written once; per step and
    client, matmul FMAs count 2 (forward, weight gradients, the input
    gradients of layers 1..L-1), bias adds, tanh, the loss and output
    gradient (4 per output), tanh' (3 per hidden unit), bias-gradient sums,
    and the update (2 per parameter, 5 with FedProx)."""
    layers = list(zip(dims[:-1], dims[1:]))
    mm = sum(a * b for a, b in layers)
    outs = sum(b for _, b in layers)
    hidden = sum(dims[1:-1])
    n_params = mm + outs
    bytes_ = 4 * (n * window * dims[0] + n * steps * batch + n_params + n * n_params + n)
    per_step = (batch * (2 * mm + outs + hidden + 4 * dims[0])
                + batch * (2 * (mm - dims[0] * dims[1]) + 3 * hidden)
                + batch * (2 * mm + outs)
                + (5 if prox else 2) * n_params)
    return bytes_, per_step * steps * n


def agg_work(n, d, n_fog) -> tuple[int, int]:
    """(bytes, operations) of one compress-aggregate call: deltas, error
    buffers, fog ids and weights read once, new error buffers and fog sums
    written once (the zero padding is counted, not loaded); per real
    coordinate the add, |v|, 32 bisection compares and count adds, the
    int8 round trip (divide, round, two clamps, multiply), the residual and
    the weighted fog add (2)."""
    return 4 * (3 * n * d + 2 * n + n_fog * d), n * d * (2 + 2 * 32 + 5 + 1 + 2)


def robust_work(fog_id, weights, n_fog, d) -> tuple[int, int]:
    """(bytes, operations) of one robust reduce, counted on this call's
    data: recon, ids and weights read once, the fog rows written once; per
    column, each ordered pair of members of a fog (weight > 0) takes two
    compares, two selects and two adds, and each member its ratio, eff and
    the num / den updates (9)."""
    members = torch.bincount(fog_id[weights > 0].long().cpu(), minlength=n_fog).double()
    n = int(fog_id.numel())
    ops = float((members ** 2).sum()) * d * 6 + float(members.sum()) * d * 9
    return 4 * (n * d + 2 * n + n_fog * d), int(ops)


def wire_emit_work(n, d, k, quantize) -> tuple[int, int]:
    """(bytes, operations) of one wire emit: deltas and error buffers read
    once, new_err, the slots (int32 index + int8 code, or f32 value) and
    the block scales written once; per real coordinate what
    :func:`agg_work` counts short of the fog add, plus one to pack."""
    nb = -(-d // 8192)
    return (4 * 3 * n * d + n * nb * k * (5 if quantize else 8) + 4 * n * nb,
            n * d * (2 + 2 * 32 + 5 + 1 + 1))


def wire_agg_work(fog_id, n_fog, d, k, quantize) -> tuple[int, int]:
    """(bytes, operations) of one wire aggregate into running sums: the
    slots, scales, ids and weights read once, and each fog row the call
    touches read and written once; per slot two multiplies and an add."""
    n, nb = int(fog_id.numel()), -(-d // 8192)
    touched = int(torch.unique(fog_id).numel())
    return (n * nb * k * (5 if quantize else 8) + 4 * n * nb + 8 * n + 8 * touched * d,
            3 * n * nb * k)


def compress_work(n, d, quantize) -> tuple[int, int]:
    """(bytes, operations) of one per-client compressor call
    (``compress_q8`` with ``quantize``, else ``topk_ef``): deltas and error
    buffers read once; new_err and the int8 codes and block scales, or the
    f32 sparse values, written once (the zero padding is counted, not
    loaded); per real coordinate the add, |v|, 32 bisection compares and
    count adds, the selection, with int8 the divide, round, two clamps and
    the product, and the residual."""
    nb = -(-d // 8192)
    written = n * d * 5 + 4 * n * nb if quantize else n * d * 8
    return 8 * n * d + written, n * d * (2 + 2 * 32 + 1 + (5 if quantize else 0) + 1)


def quant8_work(n, d) -> tuple[int, int]:
    """(bytes, operations) of one ``quant8`` call: x read once, the
    blocked codes (padding included) and the block scales written once;
    per coordinate |x|, the max, the divide, the round and two clamps."""
    nb = -(-d // 8192)
    return 4 * n * d + n * nb * 8192 + 4 * n * nb, n * d * 6


def bound_from(bytes_, ops) -> tuple[float, str]:
    t_bytes, t_ops = bytes_ / PEAK_BYTES_S, ops / PEAK_F32_FLOP_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def close_on_device(got, want, rtol, atol, what) -> float:
    """Check |got - want| <= atol + rtol |want| on the card; max |diff|."""
    diff = (got - want).abs()
    check(bool(torch.all(diff <= atol + rtol * want.abs())),
          f"{what}: max |diff| {float(diff.max()):.3e} beyond rtol={rtol}, atol={atol}")
    return float(diff.max()) if diff.numel() else 0.0


def agree_with_cpu(label, gpu, cpu, rounds) -> float:
    """The card's trial against the CPU's on identical draws: the same
    sensor-rounds, energies to rtol=1e-5, loss within 1%, F1 within 0.02;
    returns the max relative loss difference."""
    participants = [round(float(m["participation"]) * TRAIN_N * rounds) for m in (gpu, cpu)]
    check(participants[0] == participants[1],
          f"{label}: participation {participants[0]} vs CPU {participants[1]} sensor-rounds")
    for key in ("e_total", "e_s2f", "e_f2f", "e_f2g"):
        check(np.isclose(float(gpu[key]), float(cpu[key]), rtol=1e-5, atol=0.0),
              f"{label}: {key} {float(gpu[key])} vs CPU {float(cpu[key])}")
    loss_g, loss_c = gpu["losses"].cpu().numpy(), cpu["losses"].cpu().numpy()
    loss_rel = float(np.max(np.abs(loss_g - loss_c) / np.abs(loss_c)))
    check(loss_rel <= 0.01, f"{label}: loss differs from the CPU run by {loss_rel:.3e}")
    check(abs(float(gpu["f1"]) - float(cpu["f1"])) <= 0.02,
          f"{label}: F1 {float(gpu['f1']):.4f} vs CPU {float(cpu['f1']):.4f}")
    return loss_rel


def check_training_kernels(dev, lt, fa, kops, kref, ae, multi_epoch_indices) -> dict:
    """Phase 7: each training kernel against its plain version on the
    card; returns the max |kernel - plain| per kernel."""
    max_err = dict.fromkeys(TRAIN_KERNELS, 0.0)
    g = torch.Generator().manual_seed(7)
    for n in (1, 13, TRAIN_N):
        for window in (48, WINDOW):
            for d, hidden in ((D, HIDDEN), WIDE):
                for mu in (0.0, 0.01):
                    params = ae.init(g, d, hidden, device=dev)
                    x = torch.randn((n, window, d), generator=g).to(dev)
                    idx = multi_epoch_indices(g, n, window, BATCH, EPOCHS).to(dev)
                    deltas, loss = lt.train_clients(
                        x, idx, ae.ravel(params), (d, *hidden, d), LR, mu)
                    d_ref, l_ref = kref.local_train_ref(
                        x, idx, tuple(p["w"] for p in params), tuple(p["b"] for p in params),
                        LR, mu)
                    e = close_on_device(deltas, d_ref, 1e-4, 1e-6, "local_train deltas")
                    close_on_device(loss, l_ref, 1e-5, 0.0, "local_train loss")
                    max_err["local_train_f32"] = max(max_err["local_train_f32"], e)
                    print(f"  local_train_f32 N={n:4d} window={window:3d} d={d:3d} mu={mu:4.2f} "
                          f"max|delta diff|={e:.3e}  ok")
    k = kops.block_k(0.05)
    for d in AGG_DS:
        for n in AGG_NS:
            deltas = torch.randn((n, d), generator=g).to(dev)
            err = (0.1 * torch.randn((n, d), generator=g)).to(dev)
            fog_id = torch.randint(0, TRAIN_FOG, (n,), generator=g, dtype=torch.int32)
            fog_id[fog_id == 1] = 0                      # fog 1 stays empty
            weights = torch.rand((n,), generator=g)
            weights[::3] = 0.0                           # non-participants
            fog_id, weights = fog_id.to(dev), weights.to(dev)
            absv = kref.pad_blocks(deltas + err).abs()
            for quantize in (True, False):
                fs_k, ne_k, thr_k = fa.compress_aggregate_blocks(
                    deltas, err, fog_id, weights, TRAIN_FOG, k, quantize)
                fs_r, ne_r, thr_r = kref.compress_aggregate_ref(
                    deltas, err, fog_id, weights, TRAIN_FOG, k, quantize)
                check(torch.equal(absv > thr_k[..., None], absv > thr_r[..., None]),
                      f"fused_agg survivor sets differ at d={d}, N={n}")
                check(not bool(fs_k[1].any()), "the empty fog got a nonzero sum")
                e = max(close_on_device(ne_k, ne_r, 0.0, 1e-5, "fused_agg new_err"),
                        close_on_device(fs_k, fs_r, 1e-5, 1e-4, "fused_agg fog sums"))
                max_err["fused_agg"] = max(max_err["fused_agg"], e)
                print(f"  fused_agg       d={d:5d} N={n:4d} int8={quantize!s:5s} survivors equal, "
                      f"max|diff|={e:.3e}  ok")
            del deltas, err, absv
    return max_err


def time_training_kernels(dev, lt, fa, kops, kref, ae, multi_epoch_indices, name, smi) -> dict:
    """Phase 6 for the training kernels at the train-200 shapes (the
    compress-aggregate keep count is the round's: rho_s 0.05 of d)."""
    from repro_torch.core.compression import blockwise_k_frac

    g = torch.Generator().manual_seed(6)
    dims = (D, *HIDDEN, D)
    params = ae.init(g, D, HIDDEN, device=dev)
    ws, bs = tuple(p["w"] for p in params), tuple(p["b"] for p in params)
    theta = ae.ravel(params)
    x = torch.randn((TRAIN_N, WINDOW, D), generator=g).to(dev)
    idx = multi_epoch_indices(g, TRAIN_N, WINDOW, BATCH, EPOCHS).to(dev)
    steps = int(idx.shape[1])
    deltas, _ = lt.train_clients(x, idx, theta, dims, LR, 0.0)
    err = (0.1 * torch.randn(tuple(deltas.shape), generator=g)).to(dev)
    fog_id = torch.randint(0, TRAIN_FOG, (TRAIN_N,), generator=g, dtype=torch.int32).to(dev)
    weights = torch.full((TRAIN_N,), float(WINDOW), device=dev)
    d = int(deltas.shape[1])
    k = kops.block_k(blockwise_k_frac(d, 0.05))
    cases = {
        "local_train_f32": (
            lambda: lt.train_clients(x, idx, theta, dims, LR, 0.0),
            lambda: kref.local_train_ref(x, idx, ws, bs, LR, 0.0),
            train_work(dims, TRAIN_N, WINDOW, steps, BATCH, False),
            (50, 5, 20, 3),
            f"N={TRAIN_N} window={WINDOW} {steps} steps x {BATCH} rows, AE {dims}",
        ),
        "fused_agg": (
            lambda: fa.compress_aggregate_blocks(deltas, err, fog_id, weights, TRAIN_FOG, k),
            lambda: kref.compress_aggregate_ref(deltas, err, fog_id, weights, TRAIN_FOG, k),
            agg_work(TRAIN_N, d, TRAIN_FOG),
            (200, 20, 50, 5),
            f"N={TRAIN_N} d={d} n_fog={TRAIN_FOG} k={k} int8",
        ),
    }
    return time_cases(cases, name, smi)


def time_cases(cases, name, smi) -> dict:
    """Time each kernel beside its plain version: CUDA-event per-call time
    and torch.profiler device time, with the bound from its work."""
    out = {}
    for kname, (run_kernel, run_plain, work, (n_k, n_p, prof_k, prof_p), shape) in cases.items():
        calls = {"call_ms": call_ms(run_kernel, n_k), "plain_call_ms": call_ms(run_plain, n_p)}
        (ms, per_call), (plain_ms, plain_kernels) = (
            device_ms(run_kernel, prof_k), device_ms(run_plain, prof_p))
        bound_ms, bound_by = bound_from(*work)
        out[kname] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                          device_ops_per_call=per_call, plain_device_ops_per_call=plain_kernels,
                          shape=shape, bytes=work[0], operations=work[1], **calls)
        print(f"  {kname:16s} {shape}: device time kernel {ms * 1e3:9.3f} us "
              f"({per_call:.0f} launches per call), plain {plain_ms * 1e3:10.3f} us "
              f"({plain_kernels:.0f} device ops); bound {bound_ms * 1e3:8.4f} us ({bound_by}); "
              f"per call by CUDA events: kernel {calls['call_ms'] * 1e3:9.3f} us, "
              f"plain {calls['plain_call_ms'] * 1e3:10.3f} us  on {name} ({smi})")
    return out


def time_new_kernels(dev, fa, ra, kops, kref, agg, comp, ae, name, smi) -> dict:
    """Phase 6 for the robust and wire kernels: ``robust_agg`` at
    robust-200's reduce (N = 200 compressed reconstructions of d = 1,352,
    20 fogs, integer weights with 30% erased, trim 0.45), the wire pair at
    one fleet-10k chunk (512 clients, k = 68, int8, into 1,000 fogs)."""
    g = torch.Generator().manual_seed(9)
    d = ae.param_count(D, HIDDEN)
    deltas = torch.randn((TRAIN_N, d), generator=g).to(dev)
    err = (0.1 * torch.randn((TRAIN_N, d), generator=g)).to(dev)
    recon, _ = agg.client_compress(deltas, err, comp.CompressorConfig())
    fog_id = torch.randint(0, TRAIN_FOG, (TRAIN_N,), generator=g, dtype=torch.int32).to(dev)
    weights = (WINDOW * (torch.rand((TRAIN_N,), generator=g) > 0.3).to(torch.float32)).to(dev)
    cd = torch.randn((FLEET_CHUNK, d), generator=g).to(dev)
    ce = (0.1 * torch.randn((FLEET_CHUNK, d), generator=g)).to(dev)
    k = kops.wire_k(comp.blockwise_k_frac(d, 0.05))
    wire = fa.compress_wire_blocks(cd, ce, k)
    cfog = torch.randint(0, FLEET_FOG, (FLEET_CHUNK,), generator=g, dtype=torch.int32).to(dev)
    cw = torch.full((FLEET_CHUNK,), float(WINDOW), device=dev)
    fog_sum = torch.zeros((FLEET_FOG, d), device=dev)
    cases = {
        "robust_agg": (
            lambda: ra.robust_aggregate_blocks(recon, fog_id, weights, TRAIN_FOG, ROBUST_TRIM),
            lambda: kref.robust_aggregate_ref(recon, fog_id, weights, TRAIN_FOG, ROBUST_TRIM),
            robust_work(fog_id, weights, TRAIN_FOG, d),
            (200, 5, 50, 3),
            f"N={TRAIN_N} d={d} n_fog={TRAIN_FOG} trimmed {ROBUST_TRIM}, compressed recon",
        ),
        "wire_emit": (
            lambda: fa.compress_wire_blocks(cd, ce, k, True, out=wire),
            lambda: kref.compress_wire_ref(cd, ce, k),
            wire_emit_work(FLEET_CHUNK, d, k, True),
            (200, 20, 50, 5),
            f"N={FLEET_CHUNK} d={d} k={k} int8",
        ),
        "wire_agg": (
            lambda: fa.wire_aggregate_blocks(*wire[:3], cfog, cw, FLEET_FOG, d, out=fog_sum),
            lambda: kref.wire_aggregate_ref(*wire[:3], cfog, cw, FLEET_FOG, d),
            wire_agg_work(cfog, FLEET_FOG, d, k, True),
            (200, 20, 50, 5),
            f"N={FLEET_CHUNK} d={d} k={k} int8 into n_fog={FLEET_FOG}",
        ),
    }
    return time_cases(cases, name, smi)


def time_compress_kernels(dev, kq8, tk, kops, kref, comp, ae, name, smi) -> dict:
    """Phase 6 for the per-client compressor kernels: ``compress_q8`` and
    ``topk_ef`` at train-200's shape (N = 200 updates of d = 1,352, rho_s
    0.05: k = 68), ``compress_q8`` again at fleet-10k's chunk (N = 512, the
    old selection beside ``wire_emit``'s new one), ``quant8`` on one
    2^20-coordinate vector."""
    g = torch.Generator(device=dev).manual_seed(12)
    d = ae.param_count(D, HIDDEN)
    deltas = torch.randn((TRAIN_N, d), generator=g, device=dev)
    err = 0.1 * torch.randn((TRAIN_N, d), generator=g, device=dev)
    x = torch.randn((1, QUANT8_D), generator=g, device=dev)
    k = kops.block_k(comp.blockwise_k_frac(d, 0.05))
    cd = torch.randn((FLEET_CHUNK, d), generator=g, device=dev)
    ce = 0.1 * torch.randn((FLEET_CHUNK, d), generator=g, device=dev)
    k_chunk = kops.wire_k(comp.blockwise_k_frac(d, 0.05))
    cases = {
        "compress_q8": (
            lambda: kq8.compress_blocks(deltas, err, k),
            lambda: kref.compress_ref(deltas, err, k),
            compress_work(TRAIN_N, d, True),
            (200, 20, 50, 5),
            f"N={TRAIN_N} d={d} k={k} int8",
        ),
        "topk_ef": (
            lambda: tk.topk_ef_blocks(deltas, err, k),
            lambda: kref.blockwise_topk_ef_ref(deltas, err, k),
            compress_work(TRAIN_N, d, False),
            (200, 20, 50, 5),
            f"N={TRAIN_N} d={d} k={k}",
        ),
        "compress_q8 @ fleet chunk": (
            lambda: kq8.compress_blocks(cd, ce, k_chunk),
            lambda: kref.compress_ref(cd, ce, k_chunk),
            compress_work(FLEET_CHUNK, d, True),
            (200, 10, 50, 3),
            f"N={FLEET_CHUNK} d={d} k={k_chunk} int8, the control beside wire_emit",
        ),
        "quant8": (
            lambda: kq8.quant8_blocks(x),
            lambda: kref.quant8_ref(x),
            quant8_work(1, QUANT8_D),
            (200, 20, 50, 5),
            f"N=1 d={QUANT8_D}",
        ),
    }
    return time_cases(cases, name, smi)


EMPTY_KERNEL = r"""
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
"""


def launch_floor(_build, name, smi) -> dict:
    """Phase 6: an empty kernel built and launched as the port's kernels
    are (nvcc with the same flags, ctypes, the current stream): its device
    time and its per-call time, the floor under every kernel time here."""
    out = ROOT / "build" / "launch_floor"
    out.mkdir(parents=True, exist_ok=True)
    (out / "empty.cu").write_text(EMPTY_KERNEL)
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(out / "libempty.so"),
                    str(out / "empty.cu")], check=True, capture_output=True, text=True,
                   timeout=300)
    lib = ctypes.CDLL(str(out / "libempty.so"))
    lib.empty_launch.argtypes = [ctypes.c_void_p]
    lib.empty_launch.restype = ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        check(lib.empty_launch(stream) == 0, "the empty kernel was refused")

    per_call = call_ms(run, 1000)
    ms, _ = device_ms(run, 200)
    print(f"  launch floor (an empty kernel by ctypes on the current stream): device time "
          f"{ms * 1e3:.3f} us, per call by CUDA events {per_call * 1e3:.3f} us  on {name} ({smi})")
    return dict(ms=ms, call_ms=per_call)


def wrapper_host_cost(dev, fs, fa, ae, kops, comp, name, smi) -> dict:
    """Phase 6: per-call time (CUDA events) of ``score_rows`` at the large
    bucket and of ``compress_wire_blocks`` at the fleet chunk, each as the
    wrapper works now ("after") and with its old per-call host work put
    back ("before": the ctypes pointer arrays rebuilt every call; the
    dynamic shared-memory attribute set before every launch), in turns."""
    g = torch.Generator().manual_seed(3)
    params = ae.init(g, D, HIDDEN, device=dev)
    ws, bs = layer_tuples(params, False)
    x = torch.randn((HEADLINE_ROWS, D), generator=g).to(dev)
    tau = torch.full((HEADLINE_ROWS,), 40.0, device=dev)
    d = ae.param_count(D, HIDDEN)
    cd = torch.randn((FLEET_CHUNK, d), generator=g).to(dev)
    ce = (0.1 * torch.randn((FLEET_CHUNK, d), generator=g)).to(dev)
    k = kops.wire_k(comp.blockwise_k_frac(d, 0.05))
    wire = fa.compress_wire_blocks(cd, ce, k)
    lib = fa._library()

    def score_after():
        fs.score_rows(x, tau, ws, bs)

    def score_before():
        fs._f32_args.clear()
        fs.score_rows(x, tau, ws, bs)

    def wire_after():
        fa.compress_wire_blocks(cd, ce, k, True, out=wire)

    def wire_before():
        check(lib.wire_emit_init(fa.SMEM_MAX) == 0, "wire_emit_init failed")
        fa.compress_wire_blocks(cd, ce, k, True, out=wire)

    out = {}
    for label, before, after in (("score_rows", score_before, score_after),
                                 ("compress_wire_blocks", wire_before, wire_after)):
        b1, a1, a2, b2 = (call_ms(f, 500) for f in (before, after, after, before))
        out[label] = dict(before_call_ms=(b1 + b2) / 2, after_call_ms=(a1 + a2) / 2)
        print(f"  {label} host cost: per call {out[label]['before_call_ms'] * 1e3:.3f} us "
              f"before ({b1 * 1e3:.3f}, {b2 * 1e3:.3f}), {out[label]['after_call_ms'] * 1e3:.3f} "
              f"us after ({a1 * 1e3:.3f}, {a2 * 1e3:.3f})  on {name} ({smi})")
    return out


WIRE_EDGE_DS = (1, 31, 33, 1352, 2049, 8191, 8192, 8209, 65_536)
WIRE_EDGE_KS = ((8209, 1), (8209, 68), (31, 68), (1352, 1352), (1352, 2048), (2049, 4096),
                (8209, 8192), (1, 8192))


def check_wire_edges(dev, fa, kref) -> int:
    """Phase 7: ``wire_emit`` over its team sizes and edges, bitwise against
    its plain version (slots, codes, scales, new_err): widths 1 to 65,536
    at k = 68 (a two-warp team up to 2,048, a block team above, both at
    8,209), then k = 1, fills reaching into the padding, k at
    and above a block's real width and k = 8,192; N = 7 rows with an
    all-zero and a tied row; int8 on and off.  Returns the cases checked."""
    g = torch.Generator(device=dev).manual_seed(29)
    cases = [(d, 68) for d in WIRE_EDGE_DS] + list(WIRE_EDGE_KS)
    for d, k in cases:
        deltas, err = compress_rows(7, d, k, g, dev)
        for quantize in (True, False):
            got = fa.compress_wire_blocks(deltas, err, k, quantize)
            want = kref.compress_wire_ref(deltas, err, k, quantize)
            for a, b, what in zip(got, want, ("slots", "codes", "scales", "new_err")):
                check(a.dtype == b.dtype and torch.equal(a, b),
                      f"wire_emit {what} differ at d={d}, k={k}, int8={quantize}")
    print(f"  wire_emit edges: {2 * len(cases)} cases (d 1..65,536, k 1..8,192, zero and tied "
          f"rows, int8 on and off) bitwise equal  ok")
    return 2 * len(cases)


def robust_layouts(n, g, dev) -> dict:
    one = torch.zeros((n,), dtype=torch.int32)
    twenty = torch.randint(0, TRAIN_FOG, (n,), generator=g, dtype=torch.int32)
    half = torch.randint(1, TRAIN_FOG, (n,), generator=g, dtype=torch.int32)
    half[: (n + 1) // 2] = 0
    return {"one fog": one.to(dev), "20 fogs": twenty.to(dev), "half in one fog": half.to(dev)}


def check_new_kernels(dev, fa, ra, kref, agg, comp) -> dict:
    """Phase 7 for the robust and wire kernels against their plain
    versions; returns the max |kernel - plain| per kernel.

    ``robust_agg``: N 1 / 13 / 200 / 2,000, d 1,352 / 8,209, one fog / 20
    fogs / one fog holding half the fleet, trimmed 0 / 0.2 / 0.45 and the
    median, on real compressed reconstructions with integer weights:
    rtol=1e-5, atol=1e-6.  The wire pair: phase 7's d x N grid, int8 on and
    off, k 68 / 410, written at a row offset of larger buffers (rows
    outside untouched): slots, codes, scales and new_err exactly;
    ``wire_agg`` into running sums to rtol=1e-5 / atol=1e-4,
    the empty fog's row untouched."""
    max_err = dict.fromkeys(NEW_KERNELS, 0.0)
    g = torch.Generator().manual_seed(17)
    for d in ROBUST_DS:
        for n in ROBUST_NS:
            deltas = torch.randn((n, d), generator=g).to(dev)
            err = (0.1 * torch.randn((n, d), generator=g)).to(dev)
            recon, _ = agg.client_compress(deltas, err, comp.CompressorConfig())
            weights = (WINDOW * (torch.rand((n,), generator=g) > 0.3).to(torch.float32)).to(dev)
            for lname, fog_id in robust_layouts(n, g, dev).items():
                e = 0.0
                for mode, beta in ROBUST_MODES:
                    out = ra.robust_aggregate_blocks(recon, fog_id, weights, TRAIN_FOG, beta, mode)
                    want, _ = kref.robust_aggregate_ref(recon, fog_id, weights, TRAIN_FOG, beta,
                                                        mode)
                    e = max(e, close_on_device(out, want, 1e-5, 1e-6,
                                               f"robust_agg {mode} {beta} N={n} d={d} {lname}"))
                max_err["robust_agg"] = max(max_err["robust_agg"], e)
                print(f"  robust_agg      d={d:5d} N={n:4d} {lname:15s} trimmed 0/0.2/0.45 + "
                      f"median max|diff|={e:.3e}  ok")
            del deltas, err, recon
    off = 5
    for d in AGG_DS:
        for n in AGG_NS:
            deltas = torch.randn((n, d), generator=g).to(dev)
            err = (0.1 * torch.randn((n, d), generator=g)).to(dev)
            fog_id = torch.randint(0, TRAIN_FOG, (n,), generator=g, dtype=torch.int32)
            fog_id[fog_id == 1] = 0                      # fog 1 stays empty
            weights = torch.rand((n,), generator=g)
            weights[::3] = 0.0
            fog_id, weights = fog_id.to(dev), weights.to(dev)
            base = torch.randn((TRAIN_FOG, d), generator=g).to(dev)
            nb = -(-d // 8192)
            for quantize in (True, False):
                for k in WIRE_KS:
                    code = torch.int8 if quantize else torch.float32
                    bufs = (torch.full((n + off + 2, nb, k), -7, dtype=torch.int32, device=dev),
                            torch.full((n + off + 2, nb, k), 5, dtype=code, device=dev),
                            torch.full((n + off + 2, nb), 9.0, device=dev),
                            torch.full((n + off + 2, d), 9.0, device=dev))
                    view = tuple(b[off:off + n] for b in bufs)
                    fa.compress_wire_blocks(deltas, err, k, quantize, out=view)
                    r_idx, r_q, r_scale, r_err = kref.compress_wire_ref(deltas, err, k, quantize)
                    check(torch.equal(view[0], r_idx) and torch.equal(view[1], r_q)
                          and torch.equal(view[2], r_scale),
                          f"wire_emit slots, codes or scales differ at d={d}, N={n}, k={k}, "
                          f"int8={quantize}")
                    for b, fill in zip(bufs, (-7, 5, 9.0, 9.0)):
                        check(bool((b[:off] == fill).all()) and bool((b[off + n:] == fill).all()),
                              "wire_emit wrote outside its rows")
                    check(torch.equal(view[3], r_err),
                          f"wire_emit new_err differs at d={d}, N={n}, k={k}, int8={quantize}")
                    e1 = close_on_device(view[3], r_err, 0.0, 0.0, "wire_emit new_err")
                    got = fa.wire_aggregate_blocks(*view[:3], fog_id, weights, TRAIN_FOG, d,
                                                   out=base.clone())
                    want = base + kref.wire_aggregate_ref(*view[:3], fog_id, weights, TRAIN_FOG, d)
                    check(torch.equal(got[1], base[1]), "wire_agg touched the empty fog's row")
                    e2 = close_on_device(got, want, 1e-5, 1e-4, "wire_agg fog sums")
                    max_err["wire_emit"] = max(max_err["wire_emit"], e1)
                    max_err["wire_agg"] = max(max_err["wire_agg"], e2)
                    print(f"  wire_emit/agg   d={d:5d} N={n:4d} k={k:3d} int8={quantize!s:5s} "
                          f"slots and new_err equal, max|fog diff|={e2:.3e}  ok")
                    del bufs, view
            del deltas, err
    return max_err


def check_fleet_kernels(dev, fa, ra, kops, kref, agg, comp, ae) -> dict:
    """Phase 7 at the shapes of fleet-10k and beyond; returns the max
    |kernel - plain| per kernel.

    ``fused_agg`` as the unchunked round calls it (N = 10,000, d = 1,352,
    1,000 fogs, k = 68, int8, integer weights with 30% erased); the wire
    pair as the chunked round calls it: every 512-client chunk emitted into
    one chunk-sized wire and its rows of the round's error-feedback buffer,
    then added into the running (1,000, d) fog sums, each step against the
    plain versions (slots, codes, scales and new_err exactly, the running
    sums to rtol=1e-5 / atol=1e-4).  ``robust_agg`` at N =
    30,000 in 1,000 fogs, fog 0 holding 3,000 clients (its member list is
    streamed through shared memory in tiles), trimmed 0.45 and the
    median, to rtol=1e-5 / atol=1e-6."""
    max_err = dict.fromkeys(("fused_agg", *NEW_KERNELS), 0.0)
    g = torch.Generator().manual_seed(23)
    d = ae.param_count(D, HIDDEN)
    k = kops.wire_k(comp.blockwise_k_frac(d, 0.05))
    deltas = torch.randn((FLEET_N, d), generator=g).to(dev)
    err = (0.1 * torch.randn((FLEET_N, d), generator=g)).to(dev)
    fog_id = torch.randint(0, FLEET_FOG, (FLEET_N,), generator=g, dtype=torch.int32).to(dev)
    weights = (WINDOW * (torch.rand((FLEET_N,), generator=g) > 0.3).to(torch.float32)).to(dev)

    fs_k, ne_k, thr_k = fa.compress_aggregate_blocks(deltas, err, fog_id, weights, FLEET_FOG, k)
    fs_r, ne_r, thr_r = kref.compress_aggregate_ref(deltas, err, fog_id, weights, FLEET_FOG, k)
    absv = kref.pad_blocks(deltas + err).abs()
    check(torch.equal(absv > thr_k[..., None], absv > thr_r[..., None]),
          f"fused_agg survivor sets differ at N={FLEET_N}, n_fog={FLEET_FOG}")
    max_err["fused_agg"] = max(close_on_device(ne_k, ne_r, 0.0, 1e-5, "fused_agg new_err"),
                               close_on_device(fs_k, fs_r, 1e-5, 1e-4, "fused_agg fog sums"))
    print(f"  fused_agg       d={d:5d} N={FLEET_N} n_fog={FLEET_FOG} k={k} int8 survivors equal, "
          f"max|diff|={max_err['fused_agg']:.3e}  ok")
    del absv, thr_k, thr_r

    nb = -(-d // 8192)
    wire = (torch.empty((FLEET_CHUNK, nb, k), dtype=torch.int32, device=dev),
            torch.empty((FLEET_CHUNK, nb, k), dtype=torch.int8, device=dev),
            torch.empty((FLEET_CHUNK, nb), device=dev))
    new_err = torch.empty((FLEET_N, d), device=dev)
    run_k = torch.zeros((FLEET_FOG, d), device=dev)
    run_r = torch.zeros((FLEET_FOG, d), device=dev)
    for s in range(0, FLEET_N, FLEET_CHUNK):
        e = min(s + FLEET_CHUNK, FLEET_N)
        view = tuple(t[:e - s] for t in wire) + (new_err[s:e],)
        fa.compress_wire_blocks(deltas[s:e], err[s:e], k, True, out=view)
        r_idx, r_q, r_scale, r_err = kref.compress_wire_ref(deltas[s:e], err[s:e], k)
        check(torch.equal(view[0], r_idx) and torch.equal(view[1], r_q)
              and torch.equal(view[2], r_scale),
              f"wire_emit slots, codes or scales differ in the chunk at {s}")
        check(torch.equal(view[3], r_err), f"wire_emit new_err differs in the chunk at {s}")
        e1 = close_on_device(view[3], r_err, 0.0, 0.0, "wire_emit new_err")
        fa.wire_aggregate_blocks(*view[:3], fog_id[s:e], weights[s:e], FLEET_FOG, d, out=run_k)
        run_r += kref.wire_aggregate_ref(*view[:3], fog_id[s:e], weights[s:e], FLEET_FOG, d)
        e2 = close_on_device(run_k, run_r, 1e-5, 1e-4, "wire_agg running fog sums")
        max_err["wire_emit"] = max(max_err["wire_emit"], e1)
        max_err["wire_agg"] = max(max_err["wire_agg"], e2)
    print(f"  wire_emit/agg   d={d:5d} N={FLEET_N} in chunks of {FLEET_CHUNK} into "
          f"n_fog={FLEET_FOG}, k={k} int8: slots and new_err equal, max|running fog diff|="
          f"{max_err['wire_agg']:.3e}  ok")
    del deltas, err, new_err, wire, fs_k, ne_k, fs_r, ne_r

    n = BIG_ROBUST_N
    deltas = torch.randn((n, d), generator=g).to(dev)
    err = (0.1 * torch.randn((n, d), generator=g)).to(dev)
    recon, _ = agg.client_compress(deltas, err, comp.CompressorConfig())
    fog_id = torch.randint(1, FLEET_FOG, (n,), generator=g, dtype=torch.int32)
    fog_id[:BIG_ROBUST_FOG0] = 0
    fog_id = fog_id.to(dev)
    weights = (WINDOW * (torch.rand((n,), generator=g) > 0.3).to(torch.float32)).to(dev)
    for mode, beta in (("trimmed", ROBUST_TRIM), ("median", 0.0)):
        out = ra.robust_aggregate_blocks(recon, fog_id, weights, FLEET_FOG, beta, mode)
        want, _ = kref.robust_aggregate_ref(recon, fog_id, weights, FLEET_FOG, beta, mode)
        max_err["robust_agg"] = max(max_err["robust_agg"], close_on_device(
            out, want, 1e-5, 1e-6, f"robust_agg {mode} {beta} N={n}"))
    print(f"  robust_agg      d={d:5d} N={n} n_fog={FLEET_FOG}, fog 0 holding "
          f"{BIG_ROBUST_FOG0}: trimmed {ROBUST_TRIM} + median "
          f"max|diff|={max_err['robust_agg']:.3e}  ok")
    return max_err


def train_fleet(mods, dev, name, smi, workdir) -> dict:
    """Phase 8: the hfl-selective trial at full width on the card and on
    the CPU with identical draws; a timed and a profiled ``hfl.train``."""
    exp, hfl, ae, CheckpointStore, SensorDataset, ds, lt, fa = mods
    cfg = exp.make_config(TRAIN_N, TRAIN_FOG, ROUNDS)
    check((cfg.local_epochs, cfg.batch_size, cfg.lr, cfg.compressor.mode, cfg.compressor.rho_s,
           cfg.compressor.quant_bits) == (EPOCHS, BATCH, LR, "blockwise", 0.05, 8),
          f"unexpected train-200 config {cfg}")
    inputs = exp.draw_trial(torch.Generator().manual_seed(0), ds, cfg)
    store = CheckpointStore(str(workdir / "train"), keep=2)

    lt.reset_launches()
    fa.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gpu = exp.trial_metrics("hfl-selective", None, ds, cfg, inputs=inputs, store=store,
                            return_params=True)
    torch.cuda.synchronize()
    trial_s = time.perf_counter() - t0
    launches = {"local_train_f32": lt.LAUNCHES["local_train_f32"],
                "fused_agg": fa.LAUNCHES["fused_agg"]}
    check(launches == {"local_train_f32": ROUNDS, "fused_agg": 2 * ROUNDS},
          f"training launches {launches} for {ROUNDS} rounds")
    check(gpu["losses"].device.type == "cuda", "the trial did not run on the card")
    loaded, step = store.latest(gpu["params"])
    check(step == ROUNDS and torch.equal(ae.ravel(loaded), ae.ravel(gpu["params"])),
          "the last published step does not load back equal to the returned params")
    cpu = exp.trial_metrics("hfl-selective", None, ds, cfg, inputs=inputs, device="cpu")
    loss_g, loss_c = gpu["losses"].cpu().numpy(), cpu["losses"].numpy()
    loss_rel = float(np.max(np.abs(loss_g - loss_c) / np.abs(loss_c)))
    check(loss_rel <= 0.01, f"per-round loss differs from the CPU run by {loss_rel:.3e}")
    f1_diff = abs(float(gpu["f1"]) - float(cpu["f1"]))
    check(f1_diff <= 0.02, f"F1 {float(gpu['f1']):.4f} vs CPU {float(cpu['f1']):.4f}")
    check(all(bool(torch.isfinite(v).all()) for k, v in gpu.items() if k != "params"),
          "non-finite trial metrics")

    # Per-round physics against the CPU, and ms per round, from hfl.train.
    ds_dev = SensorDataset(*(t.to(dev) for t in ds))
    dep_dev, draws_dev = inputs.dep.to(dev), inputs.draws.to(dev)
    params_dev = [{k: v.to(dev) for k, v in layer.items()} for layer in inputs.params]

    def train_on_card():
        return hfl.train(params_dev, ae.loss, ds_dev, cfg, dep_dev, draws_dev)

    round_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, m_g = train_on_card()
        torch.cuda.synchronize()
        round_ms.append((time.perf_counter() - t0) * 1e3 / ROUNDS)
    _, m_c = hfl.train(inputs.params, ae.loss, ds, cfg, inputs.dep, inputs.draws)
    for field in ("participation", "coop_links", "e_s2f", "e_f2f", "e_f2g"):
        got = getattr(m_g, field).cpu().to(torch.float64).numpy()
        want = getattr(m_c, field).to(torch.float64).numpy()
        check(np.allclose(got, want, rtol=1e-5, atol=0.0),
              f"per-round {field} differs from the CPU run: {got} vs {want}")

    train_ms, train_ops = device_ms(train_on_card, 1)
    device_ms_round = train_ms / ROUNDS
    best = min(round_ms)
    summary = dict(
        launches=launches, trial_s=trial_s, round_ms=round_ms, rounds_per_s=1e3 / best,
        device_ms_per_round=device_ms_round, device_ops_per_round=train_ops / ROUNDS,
        idle_share=max(0.0, 1.0 - device_ms_round / best),
        f1=float(gpu["f1"]), precision=float(gpu["precision"]), recall=float(gpu["recall"]),
        cpu_f1=float(cpu["f1"]), e_total=float(gpu["e_total"]),
        participation=float(gpu["participation"]), coop_links=float(gpu["coop_links"]),
        loss_first=float(loss_g[0]), loss_last=float(loss_g[-1]), loss_rel_vs_cpu=loss_rel,
        losses=[float(x) for x in loss_g],
    )
    print(f"  hfl-selective N={TRAIN_N} M={TRAIN_FOG} window={WINDOW} E={EPOCHS} bs={BATCH} "
          f"T={ROUNDS} on {name} ({smi}):")
    print(f"    trial (with publishing + evaluation) {trial_s:.3f} s; hfl.train "
          f"{', '.join(f'{v:.3f}' for v in round_ms)} ms per round "
          f"({summary['rounds_per_s']:.1f} rounds/s at the best)")
    print(f"    device time {device_ms_round:.3f} ms per round in "
          f"{summary['device_ops_per_round']:.0f} device ops; idle share "
          f"{summary['idle_share']:.3f} of the best round")
    print(f"    F1 {summary['f1']:.4f} precision {summary['precision']:.4f} recall "
          f"{summary['recall']:.4f} (CPU F1 {summary['cpu_f1']:.4f}); loss "
          f"{summary['loss_first']:.4f} -> {summary['loss_last']:.4f} (max rel vs CPU "
          f"{loss_rel:.2e}); energy {summary['e_total']:.4f} J; participation "
          f"{summary['participation']:.4f}; coop links {summary['coop_links']:.2f}/round")
    print(f"    launches {launches}")
    return summary


def robust_fleet(exp, hfl, ae, SensorDataset, FaultConfig, ds, fa, ra, dev, name, smi) -> dict:
    """Phase 9: robust-200 on the card against the CPU; median and mean on
    the card; trimmed at ``client_chunk=64`` bitwise equal to unchunked;
    ms per round of the trimmed ``hfl.train`` on the card."""
    faults = FaultConfig(**ROBUST_FAULTS)
    cfg = exp.make_config(TRAIN_N, TRAIN_FOG, ROUNDS, robust="trimmed", trim_frac=ROBUST_TRIM,
                          faults=faults)
    inputs = exp.draw_trial(torch.Generator().manual_seed(0), ds, cfg)

    def on_card(c):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = exp.trial_metrics("hfl-selective", None, ds, c, inputs=inputs, return_params=True)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    ra.reset_launches()
    fa.reset_launches()
    gpu, trial_s = on_card(cfg)
    launches = {"robust_agg": ra.LAUNCHES["robust_agg"], "fused_agg": fa.LAUNCHES["fused_agg"],
                "wire_emit": fa.LAUNCHES["wire_emit"]}
    check(launches == {"robust_agg": ROUNDS, "fused_agg": 2 * ROUNDS, "wire_emit": 0},
          f"robust-200 launches {launches} for {ROUNDS} rounds")
    cpu = exp.trial_metrics("hfl-selective", None, ds, cfg, inputs=inputs, device="cpu")
    loss_rel = agree_with_cpu("robust-200", gpu, cpu, ROUNDS)
    check(float(gpu["erased_total"]) == float(cpu["erased_total"]) > 0,
          f"erasures {float(gpu['erased_total'])} vs CPU {float(cpu['erased_total'])}")
    loss_g = gpu["losses"].cpu().numpy()
    check(all(bool(torch.isfinite(v).all()) for k, v in gpu.items() if k != "params"),
          "non-finite robust-200 metrics")

    f1 = {"trimmed": float(gpu["f1"])}
    for robust in ("median", "mean"):
        out, _ = on_card(cfg.replace(robust=robust))
        f1[robust] = float(out["f1"])
    fa.reset_launches()
    chunked, chunked_s = on_card(cfg.replace(client_chunk=ROBUST_CHUNK))
    chunks = -(-TRAIN_N // ROBUST_CHUNK)
    check(fa.LAUNCHES["fused_agg"] == 2 * chunks * ROUNDS,
          f"chunked robust-200 launched fused_agg {fa.LAUNCHES['fused_agg']} times")
    for key, v in gpu.items():
        got = ae.ravel(chunked[key]) if key == "params" else chunked[key]
        want = ae.ravel(v) if key == "params" else v
        check(torch.equal(got, want), f"chunked trimmed differs from unchunked in {key}")
    ds_dev = SensorDataset(*(t.to(dev) for t in ds))
    dep_dev, draws_dev = inputs.dep.to(dev), inputs.draws.to(dev)
    params_dev = [{k: v.to(dev) for k, v in layer.items()} for layer in inputs.params]
    round_ms = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hfl.train(params_dev, ae.loss, ds_dev, cfg, dep_dev, draws_dev)
        torch.cuda.synchronize()
        round_ms.append((time.perf_counter() - t0) * 1e3 / ROUNDS)
    summary = dict(
        launches=launches, trial_s=trial_s, chunked_trial_s=chunked_s, f1=f1, round_ms=round_ms,
        cpu_f1=float(cpu["f1"]), loss_first=float(loss_g[0]), loss_last=float(loss_g[-1]),
        loss_rel_vs_cpu=loss_rel, e_total=float(gpu["e_total"]),
        participation=float(gpu["participation"]), erased_total=float(gpu["erased_total"]),
    )
    print(f"  hfl-selective N={TRAIN_N} M={TRAIN_FOG} T={ROUNDS}, {ROBUST_FAULTS} on {name} "
          f"({smi}):")
    print(f"    trimmed {ROBUST_TRIM}: hfl.train {', '.join(f'{v:.3f}' for v in round_ms)} ms per "
          f"round; trial {trial_s:.3f} s, F1 {f1['trimmed']:.4f} (CPU "
          f"{summary['cpu_f1']:.4f}); loss {summary['loss_first']:.4f} -> "
          f"{summary['loss_last']:.4f}"
          f" (max rel vs CPU {loss_rel:.2e}); {summary['erased_total']:.0f} erasures; "
          f"participation {summary['participation']:.4f}; energy {summary['e_total']:.4f} J")
    print(f"    F1 by fog reduce on the card: trimmed {f1['trimmed']:.4f}, median "
          f"{f1['median']:.4f}, mean {f1['mean']:.4f}")
    print(f"    client_chunk={ROBUST_CHUNK}: bitwise equal to unchunked ({chunks} chunks, trial "
          f"{chunked_s:.3f} s); launches {launches}")
    return summary


def fleet_scale(exp, hfl, ae, SensorDataset, generate, normalize, SyntheticConfig, fa, dev,
                name, smi) -> dict:
    """Phase 10: fleet-10k at client_chunk=512 and unchunked, both on the
    card; per-round physics, loss and F1 agree; ms per round and peak
    device memory of each."""
    ds = normalize(generate(
        torch.Generator().manual_seed(0),
        SyntheticConfig(n_sensors=FLEET_N, train_len=WINDOW, val_len=VAL_LEN, test_len=TEST_LEN),
        device=dev,
    ))
    cfg = exp.make_config(FLEET_N, FLEET_FOG, FLEET_ROUNDS)
    t0 = time.perf_counter()
    inputs = exp.draw_trial(torch.Generator().manual_seed(0), ds, cfg)
    draw_s = time.perf_counter() - t0
    dep, draws = inputs.dep.to(dev), inputs.draws.to(dev)
    params = [{k: v.to(dev) for k, v in layer.items()} for layer in inputs.params]
    runs = {}
    for chunk in (FLEET_CHUNK, None):
        c = cfg.replace(client_chunk=chunk)
        fa.reset_launches()
        trial = exp.trial_metrics("hfl-selective", None, ds, c, inputs=inputs)
        torch.cuda.synchronize()
        launches = {k: fa.LAUNCHES[k] for k in ("wire_emit", "wire_agg", "fused_agg")}
        torch.cuda.reset_peak_memory_stats(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, m = hfl.train(params, ae.loss, ds, c, dep, draws)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / FLEET_ROUNDS
        runs[chunk] = dict(trial=trial, metrics=m, launches=launches, ms_per_round=ms,
                           peak_bytes=torch.cuda.max_memory_allocated(dev))
    chunks = -(-FLEET_N // FLEET_CHUNK)
    want = {None: {"wire_emit": 0, "wire_agg": 0, "fused_agg": 2 * FLEET_ROUNDS},
            FLEET_CHUNK: {"wire_emit": chunks * FLEET_ROUNDS, "wire_agg": chunks * FLEET_ROUNDS,
                          "fused_agg": 0}}
    for chunk, r in runs.items():
        check(r["launches"] == want[chunk], f"fleet-10k chunk={chunk} launches {r['launches']}")
    a, b = runs[FLEET_CHUNK], runs[None]
    for field in ("participation", "e_s2f", "e_f2f", "e_f2g"):
        got = getattr(a["metrics"], field).cpu().to(torch.float64).numpy()
        ref = getattr(b["metrics"], field).cpu().to(torch.float64).numpy()
        check(np.allclose(got, ref, rtol=1e-5, atol=0.0),
              f"fleet-10k per-round {field} chunked vs unchunked: {got} vs {ref}")
    loss_a, loss_b = (r["metrics"].loss.cpu().numpy() for r in (a, b))
    loss_rel = float(np.max(np.abs(loss_a - loss_b) / np.abs(loss_b)))
    check(loss_rel <= 0.01, f"fleet-10k loss chunked vs unchunked differs by {loss_rel:.3e}")
    f1 = {chunk: float(r["trial"]["f1"]) for chunk, r in runs.items()}
    check(abs(f1[FLEET_CHUNK] - f1[None]) <= 0.02, f"fleet-10k F1 {f1}")
    bitwise = all(torch.equal(x, y) for x, y in zip(a["metrics"], b["metrics"]))
    layer_peaks = fleet_layer_peaks(ae, ds, cfg, dep, draws, params, dev)
    check(all(bool(torch.isfinite(v).all()) for r in runs.values() for v in r["trial"].values()),
          "non-finite fleet-10k metrics")
    summary = dict(
        draw_s=draw_s, loss_rel=loss_rel, metrics_bitwise_equal=bitwise,
        layer_peak_bytes=layer_peaks,
        **{("chunked" if chunk else "unchunked"): dict(
            launches=r["launches"], ms_per_round=r["ms_per_round"], peak_bytes=r["peak_bytes"],
            f1=f1[chunk], participation=float(r["trial"]["participation"]),
            e_total=float(r["trial"]["e_total"]),
            loss_first=float(r["metrics"].loss[0]), loss_last=float(r["metrics"].loss[-1]))
           for chunk, r in runs.items()},
    )
    print(f"  hfl-selective N={FLEET_N} M={FLEET_FOG} T={FLEET_ROUNDS} on {name} ({smi}); "
          f"draws {draw_s:.2f} s on the host")
    for label, chunk in ((f"client_chunk={FLEET_CHUNK}", FLEET_CHUNK), ("unchunked", None)):
        r = runs[chunk]
        print(f"    {label:16s} {r['ms_per_round']:9.3f} ms per round, peak device memory "
              f"{r['peak_bytes'] / 2**20:9.1f} MiB, F1 {f1[chunk]:.4f}, loss "
              f"{float(r['metrics'].loss[0]):.4f} -> {float(r['metrics'].loss[-1]):.4f}, "
              f"launches {r['launches']}")
    print(f"    chunked vs unchunked: max rel loss diff {loss_rel:.2e}; every per-round metric "
          f"bitwise equal: {bitwise}")
    print("    peak device memory above the resident set, outputs included: "
          + ", ".join(f"{k} {v / 2**20:.1f} MiB" for k, v in layer_peaks.items()))
    return summary


def fleet_layer_peaks(ae, ds, cfg, dep, draws, params, dev) -> dict:
    """Peak device memory above what is already allocated, for one call of
    each big layer of a fleet-10k round: association, the client phase,
    and compress-and-accumulate chunked and unchunked (outputs included)."""
    from repro_torch.core import aggregation as agg
    from repro_torch.core import association as assoc
    from repro_torch.kernels import ops as kops

    def peak_above(fn):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        out = fn()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev) - base
        del out
        return peak

    fa_ = assoc.nearest_feasible_fog(dep, cfg.channel)
    deltas, _ = kops.local_train(params, ds.train, draws.batches[0], cfg.lr)
    err = torch.zeros_like(deltas)
    weights = ds.n_samples * fa_.participates.to(torch.float32)
    peaks = {
        "association": peak_above(lambda: assoc.nearest_feasible_fog(dep, cfg.channel)),
        "client phase": peak_above(lambda: kops.local_train(params, ds.train, draws.batches[0],
                                                            cfg.lr)),
    }
    for label, chunk in ((f"compress chunk {FLEET_CHUNK}", FLEET_CHUNK),
                         ("compress unchunked", None)):
        peaks[label] = peak_above(lambda: agg.compress_and_accumulate(
            deltas, err, fa_.fog_id, weights, FLEET_FOG, cfg.compressor, chunk=chunk))
    return peaks


def compress_rows(n, d, k, g, dev):
    """Gaussian updates and error buffers on the card; with N > 2, row 1
    all zeros and row 2 tying more than k entries of every block at the
    block max (as many as the block's width allows)."""
    deltas = torch.randn((n, d), generator=g, device=dev)
    err = 0.1 * torch.randn((n, d), generator=g, device=dev)
    if n > 2:
        deltas[1] = 0.0
        err[1] = 0.0
        deltas[2] *= 0.1
        err[2] = 0.0
        for lo in range(0, d, 8192):
            t = min(d - lo, 8192, k + 3)
            deltas[2, lo:lo + t] = torch.where(torch.arange(t, device=dev) % 2 == 0, 5.0, -5.0)
    return deltas, err


def check_compress_kernels(dev, kq8, tk, fa, kops, kref, comp) -> dict:
    """Phase 11: the per-client compressor kernels against their plain
    versions over d x N x keep fraction, bitwise: ``compress_q8``'s codes,
    scales and new_err, the payload bits of ``ops.compress``,
    ``topk_ef``'s sparse values and new_err, ``quant8``'s codes and scales
    (on the same rows); and ``topk_ef``'s selection equal to
    ``fused_agg``'s (v where |v| > its thresholds).  Returns the max |kernel -
    plain| per kernel and the number of tied blocks checked."""
    max_err = dict.fromkeys(COMPRESS_KERNELS, 0.0)
    g = torch.Generator(device=dev).manual_seed(11)
    tied = 0
    for d in COMP_DS:
        b_idx = math.ceil(math.log2(d))
        fracs = {"rho_s 0.05": comp.blockwise_k_frac(d, 0.05),
                 "rho_s 1": comp.blockwise_k_frac(d, 1.0), "1/8192": 1.0 / 8192}
        for n in COMP_NS:
            for label, k_frac in fracs.items():
                k = kops.block_k(k_frac)
                deltas, err = compress_rows(n, d, k, g, dev)
                q, scale, new_err = kq8.compress_blocks(deltas, err, k)
                w_q, w_scale, w_err = kref.compress_ref(deltas, err, k)
                for got, want, what in ((q, w_q, "codes"), (scale, w_scale, "scales"),
                                        (new_err, w_err, "new_err")):
                    check(got.dtype == want.dtype and torch.equal(got, want),
                          f"compress_q8 {what} differ at d={d}, N={n}, k={k}")
                wire_err = fa.compress_wire_blocks(deltas, err, k)[3]
                check(torch.equal(wire_err, new_err),
                      f"wire_emit and compress_q8 new_err differ at d={d}, N={n}, k={k}")
                del wire_err
                bits = kops.compress(deltas, err, k_frac)[2]
                check(torch.equal(bits, (w_q != 0).sum(1).to(torch.float32) * (8.0 + b_idx)),
                      f"payload bits differ at d={d}, N={n}, k={k}")
                sparse, t_err = tk.topk_ef_blocks(deltas, err, k)
                w_sparse, w_terr = kref.blockwise_topk_ef_ref(deltas, err, k)
                check(torch.equal(sparse, w_sparse) and torch.equal(t_err, w_terr),
                      f"topk_ef differs at d={d}, N={n}, k={k}")
                _, _, thr = fa.compress_aggregate_blocks(
                    deltas, err, torch.zeros((n,), dtype=torch.int32, device=dev),
                    torch.ones((n,), device=dev), 1, k)
                v = kref.pad_blocks(deltas + err)
                selected = kref.unpad_rows(torch.where(v.abs() > thr[..., None], v, 0.0), d)
                check(torch.equal(sparse, selected),
                      f"per-client and fused survivor sets differ at d={d}, N={n}, k={k}")
                del v, selected, thr
                xq, xs = kq8.quant8_blocks(deltas)
                w_xq, w_xs = kref.quant8_ref(deltas)
                check(torch.equal(xq, w_xq) and torch.equal(xs, w_xs),
                      f"quant8 differs at d={d}, N={n}")
                if n > 2:
                    for b, lo in enumerate(range(0, d, 8192)):
                        if min(d - lo, 8192, k + 3) > k:
                            check(float(scale[2, b]) == 0.0 and not bool(q[2, lo:lo + 8192].any()),
                                  f"a tie at the block max kept codes at d={d}, k={k}")
                            tied += 1
                print(f"  compress_q8/topk_ef/quant8 d={d:5d} N={n:4d} {label:10s} k={k:4d}: "
                      f"codes, scales, new_err (and wire_emit's), sparse, payload bits and "
                      f"survivors equal  ok")
                del deltas, err, q, scale, new_err, w_q, w_scale, w_err, sparse, t_err
                del w_sparse, w_terr, xq, xs, w_xq, w_xs
    check(tied > 0, "no block tied more than k entries at its max")
    print(f"  {tied} tied blocks: nothing survived, scale 0")
    return max_err, tied


def train_variant(exp, hfl, ae, ds, cfg, inputs, counters, dev) -> dict:
    """One train-200 trial on the card under ``cfg`` with ``counters``
    (name -> (LAUNCHES dict, reset)) zeroed just before it and read just
    after, then two timed ``hfl.train`` runs on the resident inputs and a
    profiled one (device time and ops per round, idle share of the best
    round)."""
    for _, reset in counters.values():
        reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gpu = exp.trial_metrics("hfl-selective", None, ds, cfg, inputs=inputs)
    torch.cuda.synchronize()
    trial_s = time.perf_counter() - t0
    launches = {k: launches_of[k] for k, (launches_of, _) in counters.items()}
    check(all(bool(torch.isfinite(v).all()) for v in gpu.values()), "non-finite trial metrics")
    ds_dev = type(ds)(*(t.to(dev) for t in ds))
    dep, draws = inputs.dep.to(dev), inputs.draws.to(dev)
    params = [{k: v.to(dev) for k, v in layer.items()} for layer in inputs.params]
    def train_on_card():
        return hfl.train(params, ae.loss, ds_dev, cfg, dep, draws)

    round_ms = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, m = train_on_card()
        torch.cuda.synchronize()
        round_ms.append((time.perf_counter() - t0) * 1e3 / cfg.rounds)
    train_ms, train_ops = device_ms(train_on_card, 1)
    device = dict(device_ms_per_round=train_ms / cfg.rounds,
                  device_ops_per_round=train_ops / cfg.rounds,
                  idle_share=max(0.0, 1.0 - train_ms / cfg.rounds / min(round_ms)))
    return dict(trial=gpu, metrics=m, launches=launches, trial_s=trial_s, round_ms=round_ms,
                **device)


def legacy_fleet(exp, hfl, ae, agg, comp, kops, ds, kq8, tk, fa, training, dev, name,
                 smi) -> dict:
    """Phase 12: legacy-200, train-200 with the per-client compressor, in
    three variants, each launching its kernel once a round; the int8
    variant on the CPU too and against phase 8's fused trial; then the
    int8 codec front door on round 0's updates."""
    base = exp.make_config(TRAIN_N, TRAIN_FOG, ROUNDS)
    inputs = exp.draw_trial(torch.Generator().manual_seed(0), ds, base)   # phase 8's draws
    counters = {"compress_q8": (kq8.LAUNCHES, kq8.reset_launches),
                "topk_ef": (tk.LAUNCHES, tk.reset_launches),
                "fused_agg": (fa.LAUNCHES, fa.reset_launches)}
    variants = {
        "fused=False int8": (comp.CompressorConfig(fused=False), "compress_q8"),
        "fused=False f32": (comp.CompressorConfig(fused=False, quant_bits=32), "topk_ef"),
        "rho_s=1 int8": (comp.CompressorConfig(rho_s=1.0), "compress_q8"),
    }
    out = {}
    for label, (cc, kernel) in variants.items():
        cfg = base.replace(compressor=cc)
        r = train_variant(exp, hfl, ae, ds, cfg, inputs, counters, dev)
        launches = r["launches"]
        want = {k: (ROUNDS if k == kernel else 0) for k in counters}
        check(launches == want, f"legacy-200 {label} launches {launches}, expected {want}")
        gpu = r["trial"]
        out[label] = dict(
            launches=launches, trial_s=r["trial_s"], round_ms=r["round_ms"],
            device_ms_per_round=r["device_ms_per_round"],
            device_ops_per_round=r["device_ops_per_round"], idle_share=r["idle_share"],
            f1=float(gpu["f1"]), participation=float(gpu["participation"]),
            e_total=float(gpu["e_total"]), loss_first=float(gpu["losses"][0]),
            loss_last=float(gpu["losses"][-1]))
        if label == "fused=False int8":
            cpu = exp.trial_metrics("hfl-selective", None, ds, cfg, inputs=inputs, device="cpu")
            out[label]["loss_rel_vs_cpu"] = agree_with_cpu(f"legacy-200 {label}", gpu, cpu, ROUNDS)
            out[label]["cpu_f1"] = float(cpu["f1"])
            fused_loss = np.asarray(training["losses"])
            rel = float(np.max(np.abs(gpu["losses"].cpu().numpy() - fused_loss) / fused_loss))
            check(rel <= 0.01, f"legacy-200 loss differs from the fused trial by {rel:.3e}")
            check(abs(float(gpu["f1"]) - training["f1"]) <= 0.02,
                  f"legacy-200 F1 {float(gpu['f1']):.4f} vs fused {training['f1']:.4f}")
            out[label]["loss_rel_vs_fused"] = rel
        print(f"  {label:17s} hfl.train {', '.join(f'{v:.3f}' for v in r['round_ms'])} ms per "
              f"round, device {r['device_ms_per_round']:.3f} ms in "
              f"{r['device_ops_per_round']:.0f} ops per round, idle share {r['idle_share']:.3f}; trial {r['trial_s']:.3f} s, F1 {out[label]['f1']:.4f}, participation "
              f"{out[label]['participation']:.4f}, loss {out[label]['loss_first']:.4f} -> "
              f"{out[label]['loss_last']:.4f}, energy {out[label]['e_total']:.4f} J; launches "
              f"{launches}  on {name} ({smi})")
    first = out["fused=False int8"]
    print(f"    fused=False int8 vs the CPU: max rel loss diff {first['loss_rel_vs_cpu']:.2e}, "
          f"F1 {first['f1']:.4f} vs {first['cpu_f1']:.4f}; vs phase 8's fused trial: max rel "
          f"loss diff {first['loss_rel_vs_fused']:.2e}, F1 {first['f1']:.4f} vs "
          f"{training['f1']:.4f}")

    # Round 0's updates through both compressors, with one round of error
    # feedback in the buffers: the same EF state bitwise (so the same
    # survivors and codes), the fog sums re-associated.
    ds_dev = type(ds)(*(t.to(dev) for t in ds))
    params = [{k: v.to(dev) for k, v in layer.items()} for layer in inputs.params]
    deltas, _ = kops.local_train(params, ds_dev.train, inputs.draws.batches[0].to(dev), LR)
    fog_id = (torch.arange(TRAIN_N, device=dev) % TRAIN_FOG).to(torch.int32)
    weights = torch.full((TRAIN_N,), float(WINDOW), device=dev)
    _, _, err = agg.compress_and_accumulate(deltas, torch.zeros_like(deltas), fog_id, weights,
                                            TRAIN_FOG, base.compressor)
    fused = agg.compress_and_accumulate(deltas, err, fog_id, weights, TRAIN_FOG, base.compressor)
    legacy = agg.compress_and_accumulate(deltas, err, fog_id, weights, TRAIN_FOG,
                                         comp.CompressorConfig(fused=False))
    check(torch.equal(fused[2], legacy[2]), "fused and per-client error feedback differ")
    sums_diff = close_on_device(legacy[0], fused[0], 1e-5, 1e-4, "per-client vs fused fog sums")
    print(f"    round 0's updates: per-client and fused error feedback bitwise equal, fog sums "
          f"max |diff| {sums_diff:.3e}")

    kq8.reset_launches()
    q, scale, n = kops.quant8(deltas)
    recon = kops.dequant8(q, scale, n)
    torch.cuda.synchronize()
    codec_launches = kq8.LAUNCHES["quant8"]
    check(codec_launches == 1, f"the int8 codec launched quant8 {codec_launches} times")
    q_cpu, scale_cpu, _ = kops.quant8(deltas.cpu())
    check(torch.equal(q.cpu(), q_cpu) and torch.equal(scale.cpu(), scale_cpu),
          "the codec's codes differ from the CPU's")
    step = float((deltas - recon).abs().max() / scale.max())
    check(step <= 0.5 + 1e-6, f"int8 round trip off by {step:.4f} quantisation steps")
    print(f"    int8 codec (ops.quant8 / ops.dequant8) on round 0's {TRAIN_N} updates: "
          f"{codec_launches} launch, round trip within {step:.4f} of a step, equal to the CPU's")
    return dict(variants=out, codec_launches=codec_launches, fog_sum_diff_vs_fused=sums_diff)


def drift_fleet(exp, hfl, ae, topo, ch, DriftConfig, ds, lt, fa, dev, name, smi) -> dict:
    """Phase 13: drift-200, train-200 in the drift benchmark's world and
    its three cells on the card; the re-association cell on the CPU too
    (per-round participation exactly, energies to rtol=1e-5, loss within
    1%, F1 within 0.02)."""
    base = exp.make_config(
        TRAIN_N, TRAIN_FOG, ROUNDS,
        deployment=topo.DeploymentParams(n_sensors=TRAIN_N, n_fog=TRAIN_FOG, **DRIFT_BASIN),
        channel=ch.ChannelParams().replace(sl_max_db=DRIFT_SL_MAX_DB))
    cells = {
        "static": DriftConfig(active=True),
        "frozen": DriftConfig(sensor_current_m_s=DRIFT_CURRENT, reassoc_every=float("inf")),
        "reassoc": DriftConfig(sensor_current_m_s=DRIFT_CURRENT, reassoc_every=DRIFT_REASSOC),
    }
    inputs = exp.draw_trial(torch.Generator().manual_seed(0), ds, base)
    counters = {"local_train_f32": (lt.LAUNCHES, lt.reset_launches),
                "fused_agg": (fa.LAUNCHES, fa.reset_launches)}
    out = {}
    for cell, drift in cells.items():
        cfg = base.replace(drift=drift)
        r = train_variant(exp, hfl, ae, ds, cfg, inputs, counters, dev)
        check(r["launches"] == {"local_train_f32": ROUNDS, "fused_agg": 2 * ROUNDS},
              f"drift-200 {cell} launches {r['launches']}")
        gpu = r["trial"]
        part = r["metrics"].participation.cpu().numpy()
        out[cell] = dict(
            launches=r["launches"], trial_s=r["trial_s"], round_ms=r["round_ms"],
            device_ms_per_round=r["device_ms_per_round"],
            device_ops_per_round=r["device_ops_per_round"], idle_share=r["idle_share"],
            f1=float(gpu["f1"]), participation=float(gpu["participation"]),
            participation_by_round=[float(p) for p in part], e_total=float(gpu["e_total"]),
            loss_first=float(gpu["losses"][0]), loss_last=float(gpu["losses"][-1]))
        if cell == "reassoc":
            cpu = exp.trial_metrics("hfl-selective", None, ds, cfg, inputs=inputs, device="cpu")
            out[cell]["loss_rel_vs_cpu"] = agree_with_cpu("drift-200 reassoc", gpu, cpu, ROUNDS)
            out[cell]["cpu_f1"] = float(cpu["f1"])
            _, m_cpu = hfl.train(inputs.params, ae.loss, ds, cfg, inputs.dep, inputs.draws)
            check(np.array_equal(np.round(part * TRAIN_N), np.round(
                m_cpu.participation.numpy() * TRAIN_N)), "drift-200 per-round participation "
                  f"differs from the CPU run: {part} vs {m_cpu.participation.numpy()}")
            for field in ("e_s2f", "e_f2f", "e_f2g"):
                got = getattr(r["metrics"], field).cpu().to(torch.float64).numpy()
                want = getattr(m_cpu, field).to(torch.float64).numpy()
                check(np.allclose(got, want, rtol=1e-5, atol=0.0),
                      f"drift-200 per-round {field} differs from the CPU run")
        print(f"  {cell:8s} hfl.train {', '.join(f'{v:.3f}' for v in r['round_ms'])} ms per "
              f"round, device {r['device_ms_per_round']:.3f} ms in "
              f"{r['device_ops_per_round']:.0f} ops per round, idle share {r['idle_share']:.3f}; F1 {out[cell]['f1']:.4f}, participation {out[cell]['participation']:.4f} "
              f"(round 0 {part[0]:.3f}, last {part[-1]:.3f}), energy {out[cell]['e_total']:.4f} "
              f"J, loss {out[cell]['loss_first']:.4f} -> {out[cell]['loss_last']:.4f}  on "
              f"{name} ({smi})")
    p = {c: out[c]["participation"] for c in cells}
    ordered = p["frozen"] < p["reassoc"] <= p["static"]
    print(f"    reassoc vs the CPU: max rel loss diff {out['reassoc']['loss_rel_vs_cpu']:.2e}, F1 "
          f"{out['reassoc']['f1']:.4f} vs {out['reassoc']['cpu_f1']:.4f}; participation frozen "
          f"{p['frozen']:.4f} < reassoc {p['reassoc']:.4f} <= static {p['static']:.4f}: "
          f"{ordered} (recorded, not gated)")
    return dict(cells=out, participation_ordered=ordered)


# --- phases 14-16: LM decode serving and the swa_decode kernel -------------

SWA_KERNEL = ("src/repro/kernels/swa_attention.py:28", "src/repro_torch/kernels/csrc/swa_decode.cu")
SWA_DEVICE_KERNELS = ("swa_split_kernel", "swa_merge_kernel")   # one swa_decode call
SWA_SHAPES = ((8, 10, 1, 256), (8, 32, 8, 128), (2, 8, 2, 64), (2, 8, 8, 64), (2, 4, 1, 128))
SWA_SEQS = (64, 161, 321, 512, 2233, 4096)   # 161, 321: dense-decode's, hybrid-serve's caches
SWA_WINDOWS = (64, 2048, 2 ** 30)
SWA_F32_TOL = dict(rtol=1e-4, atol=2e-5)     # the reference's own (tests/test_kernels.py)
# hybrid-window's attention at its widest: batch 8, recurrentgemma's MQA
# (Hq 10, Hkv 1, d 256), a 2,233-slot cache at length 2,200, window 2,048, bf16.
SWA_TIME = dict(b=8, hq=10, hkv=1, d=256, s=2233, length=2200, window=2048)
# dense-decode's attention: batch 8, llama3-8b's GQA (Hq 32, Hkv 8, d 128), its
# 161-slot cache full, the "global" window, bf16.
SWA_TIME_DENSE = dict(b=8, hq=32, hkv=8, d=128, s=161, length=161, window=2 ** 30)
# hybrid-serve: recurrentgemma-2b's published config, batch 8, prompt 256 + 64 new.
HYBRID_ARCH, HYBRID_BATCH, HYBRID_PROMPT, HYBRID_NEW = "recurrentgemma-2b", 8, 256, 64
# hybrid-window: its first 3 layers (rec, rec, attn) at full width, 2,200 + 32.
WINDOW_LAYERS, WINDOW_PROMPT, WINDOW_NEW = 3, 2200, 32
# dense-decode: llama3-8b at full width cut to 2 layers, batch 8, 128 + 32.
DENSE_ARCH, DENSE_LAYERS, DENSE_BATCH, DENSE_PROMPT, DENSE_NEW = "llama3-8b", 2, 8, 128, 32
PROFILE_STEPS = 5
LM_GATE = 1e-3          # card vs CPU, f32: max |dlogit| <= LM_GATE * max |logit|
CPU_VS_CARD = {         # (layers or None for REDUCED, batch, steps)
    "hybrid full width": (3, 2, 48),
    "hybrid REDUCED": (None, 2, 160),
    "dense full width": (2, 2, 32),
    "gemma2 REDUCED": (None, 2, 64),
}


def swa_lens(b, s, window, case) -> list[int]:
    """Per-row cache lengths: a rotation of 1, window - 1, window, window
    + 1 and S (clamped writes past S), the last row S + window (an empty
    window)."""
    mix = [1, window - 1, window, window + 1, s]
    return [mix[(case + i) % len(mix)] for i in range(b - 1)] + [s + window]


def bf16_ulps_ok(got, want) -> bool:
    """Equal or one bf16 ulp apart; near zero, where the f32 rounding of
    the sums alone spans bf16 ulps, within f32's atol."""
    def ordered(x):
        bits = x.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(bits < 0, -(bits & 0x7FFF), bits & 0x7FFF)
    ulps = torch.abs(ordered(got) - ordered(want))
    near = torch.abs(got.float() - want.float()) <= SWA_F32_TOL["atol"]
    return bool(torch.all((ulps <= 1) | near))


def check_swa_kernel(dev, swa, kref) -> dict:
    """Phase 14: ``swa_decode`` against its plain version over the grid of
    (B, Hq, Hkv, d) x S x window x {f32, bf16}: f32 to rtol=1e-4 /
    atol=2e-5, bf16 equal or one ulp apart, the empty-window row zeros;
    then K/V outside the window perturbed leaves the output bitwise equal."""
    g = torch.Generator(device=dev).manual_seed(14)
    max_err, cases, case = {"f32": 0.0, "bf16": 0.0}, 0, 0
    for b, hq, hkv, d in SWA_SHAPES:
        for s in SWA_SEQS:
            for window in SWA_WINDOWS:
                lens = swa_lens(b, s, window, case)
                case += 1
                q32 = torch.randn((b, hq, d), generator=g, device=dev)
                k32 = torch.randn((b, s, hkv, d), generator=g, device=dev)
                v32 = torch.randn((b, s, hkv, d), generator=g, device=dev)
                ln = torch.tensor(lens, dtype=torch.int32, device=dev)
                for tag, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
                    q, k, v = (t.to(dev, dtype) for t in (q32, k32, v32))
                    got = swa.swa_decode(q, k, v, ln, window)
                    want = kref.sliding_window_decode_attention_ref(q, k, v, ln, window)
                    torch.cuda.synchronize()
                    what = f"swa_decode {tag} B={b} Hq={hq} Hkv={hkv} d={d} S={s} w={window}"
                    check(got.dtype == dtype and got.shape == q.shape, f"{what}: output type")
                    check(bool(torch.all(got[-1] == 0)), f"{what}: empty window not zero")
                    if tag == "f32":
                        e = close_on_device(got, want, what=what, **SWA_F32_TOL)
                    else:
                        check(bf16_ulps_ok(got, want), f"{what}: beyond one bf16 ulp")
                        e = float((got.float() - want.float()).abs().max())
                    max_err[tag] = max(max_err[tag], e)
                    cases += 1
    print(f"  {cases} cases within tolerance; max |diff| f32 {max_err['f32']:.3e}, "
          f"bf16 {max_err['bf16']:.3e}; empty windows zero")
    for b, hq, hkv, d in SWA_SHAPES[:2]:
        s, window = 2233, 2048
        lens = [2200, 77, 1, 2049][:b - 1] + [2233] * (b - 1 - 4) + [s + window]
        q, k, v = (torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
                   for shape in ((b, hq, d), (b, s, hkv, d), (b, s, hkv, d)))
        ln = torch.tensor(lens, dtype=torch.int32, device=dev)
        base = swa.swa_decode(q, k, v, ln, window)
        k2, v2 = k.clone(), v.clone()
        for row, n in enumerate(lens):
            k2[row, :max(0, n - window)] += 100.0
            v2[row, min(n, s):] = 1e4
        check(torch.equal(swa.swa_decode(q, k2, v2, ln, window), base),
              f"swa_decode reads K/V outside the window (Hq={hq})")
        for _ in range(3):
            check(torch.equal(swa.swa_decode(q, k, v, ln, window), base),
                  f"swa_decode: two calls differ (Hq={hq})")
    print("  K/V outside the window perturbed: output bitwise equal; repeated calls bitwise "
          "equal (the splits merge in a fixed order)")
    return dict(cases=cases, max_abs_err=max(max_err.values()), by_dtype=max_err)


def time_swa_kernel(dev, swa, kref, name, smi, c=None) -> dict:
    """Phase 14's timing at one shape (hybrid-window's by default): the
    kernel and its plain version (``time_cases``), and
    ``scaled_dot_product_attention`` with a boolean mask and ``enable_gqa``
    on the same inputs (the yardstick; the port never calls it)."""
    import torch.nn.functional as F

    c = SWA_TIME if c is None else c
    g = torch.Generator(device=dev).manual_seed(15)
    q = torch.randn((c["b"], c["hq"], c["d"]), generator=g, device=dev).to(torch.bfloat16)
    k, v = (torch.randn((c["b"], c["s"], c["hkv"], c["d"]), generator=g, device=dev)
            .to(torch.bfloat16) for _ in range(2))
    ln = torch.full((c["b"],), c["length"], dtype=torch.int32, device=dev)
    w = c["window"]
    pos = torch.arange(c["s"], device=dev)
    mask = ((pos < ln[:, None]) & (pos >= ln[:, None] - w))[:, None, None, :]
    qs, ks, vs = q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2)

    def run_library():
        return F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask, enable_gqa=True)

    lib = run_library()[:, :, 0].float()
    ker = swa.swa_decode(q, k, v, ln, w).float()
    torch.cuda.synchronize()
    lib_diff = float((lib - ker).abs().max())
    shape = (f"B={c['b']} Hq={c['hq']} Hkv={c['hkv']} d={c['d']} S={c['s']} len={c['length']} "
             f"w={w} bf16")
    t = time_cases({"swa_decode": (lambda: swa.swa_decode(q, k, v, ln, w),
                                   lambda: kref.sliding_window_decode_attention_ref(q, k, v, ln, w),
                                   swa.swa_decode_work(q, k, ln, w), (200, 50, 50, 20), shape)},
                   name, smi)["swa_decode"]
    library_ms, library_ops = device_ms(run_library, 50)
    t.update(library_ms=library_ms, library_call_ms=call_ms(run_library, 200),
             library_device_ops_per_call=library_ops, library_max_abs_diff=lib_diff)

    def fifty():
        for _ in range(50):
            swa.swa_decode(q, k, v, ln, w)
        torch.cuda.synchronize()

    dev = device_events(fifty)
    t["ms_by_device_kernel"] = {k: sum(e.time_range.elapsed_us() for e in dev if k in e.name)
                                / 1e3 / 50 for k in SWA_DEVICE_KERNELS}
    print("  swa_decode by device kernel: " + ", ".join(
        f"{k} {v * 1e3:.3f} us" for k, v in t["ms_by_device_kernel"].items()))
    print(f"  scaled_dot_product_attention: device time {library_ms * 1e3:9.3f} us "
          f"({library_ops:.0f} device ops), per call {t['library_call_ms'] * 1e3:9.3f} us; "
          f"max |diff| from the kernel {lib_diff:.3e}  on {name} ({smi})")
    return t


def cut(cfg, layers):
    """``cfg`` at full width cut to its first ``layers`` layers."""
    return cfg if layers is None else cfg.replace(n_layers=layers)


def profile_decode(api, cfg, params, cache, tok, n) -> tuple[float, float, int]:
    """(device ms per decode step, swa_decode device ms per step, device ops
    per step) over ``n`` steps of torch.profiler's CUPTI trace, after one
    untraced step, continuing from ``cache``."""
    step = api.make_serve_step(cfg)
    cache, _ = step(params, cache, tok)
    torch.cuda.synchronize()
    state = {"cache": cache}

    def run():
        for _ in range(n):
            state["cache"], state["logits"] = step(params, state["cache"], tok)
        torch.cuda.synchronize()

    dev = device_events(run)
    check(bool(torch.isfinite(state["logits"]).all()), "non-finite logits in the profiled steps")
    total = sum(e.time_range.elapsed_us() for e in dev) / 1e3 / n
    swa_ms = sum(e.time_range.elapsed_us() for e in dev
                 if any(k in e.name for k in SWA_DEVICE_KERNELS)) / 1e3 / n
    return total, swa_ms, round(len(dev) / n)


def check_swa_on_path(label, api, swa, kref, cfg, params, cache, tok) -> tuple[object, dict]:
    """One more decode step from the run's final cache, with every
    ``swa_decode`` call's inputs (the real q, K/V caches and lengths)
    recorded and its output held against the plain version at phase 14's
    tolerances (f32 rtol=1e-4 / atol=2e-5, bf16 equal or one ulp apart).
    Returns the cache after that step and the calls' count and max |diff|."""
    calls, launch = [], swa.swa_decode

    def recording(q, k, v, cache_len, window):
        out = launch(q, k, v, cache_len, window)
        calls.append((out, q, k, v, cache_len.clone(), window))
        return out

    swa.swa_decode = recording
    try:
        cache, logits = api.make_serve_step(cfg)(params, cache, tok)
    finally:
        swa.swa_decode = launch
    check(bool(torch.isfinite(logits).all()), f"{label}: non-finite logits in the checked step")
    worst, lens = 0.0, set()
    for i, (got, q, k, v, cache_len, window) in enumerate(calls):
        want = kref.sliding_window_decode_attention_ref(q, k, v, cache_len, window)
        what = (f"{label} swa_decode call {i} (B={q.shape[0]} Hq={q.shape[1]} S={k.shape[1]} "
                f"Hkv={k.shape[2]} d={q.shape[2]} w={window} {q.dtype})")
        if q.dtype == torch.float32:
            worst = max(worst, close_on_device(got, want, what=what, **SWA_F32_TOL))
        else:
            check(bf16_ulps_ok(got, want), f"{what}: beyond one bf16 ulp")
            worst = max(worst, float((got.float() - want.float()).abs().max()))
        lens.update(cache_len.tolist())
    return cache, dict(calls=len(calls), max_abs_err=worst, lengths=sorted(lens),
                       s=int(calls[0][2].shape[1]) if calls else 0)


def lm_serve(label, api, serve, swa, kref, cfg, dev, batch, prompt_len, new_tokens, name,
             smi) -> dict:
    """Serve ``cfg`` with random weights from seed 0: token-stepped prefill
    of random prompts, greedy decode (``launch/serve``), the ``swa_decode``
    launches of that run (zeroed just before it, read just after), prefill
    and decode tokens/s, ms per decode step, peak memory; then, continuing
    from the decode's final cache, one step whose ``swa_decode`` calls are
    held against the plain version (``check_swa_on_path``), and the device
    time and idle share of the steps after it."""
    g = torch.Generator(device=dev).manual_seed(0)
    params = api.init_params(g, cfg)
    cache = api.init_cache(cfg, batch, prompt_len + new_tokens + 1, device=dev)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len), generator=g, device=dev,
                            dtype=torch.int32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    swa.reset_launches()
    t0 = time.perf_counter()
    cache, logits = serve.prefill_into_cache(cfg, params, cache, prompts)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    t0 = time.perf_counter()
    cache, toks = serve.decode_tokens(cfg, params, cache, logits, new_tokens)
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    launches = swa.LAUNCHES["swa_decode"]
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    check(bool(torch.isfinite(logits).all()), f"{label}: non-finite prefill logits")
    check(toks.shape == (batch, new_tokens) and bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
          f"{label}: tokens out of range")
    n_attn = launches // (prompt_len + new_tokens)
    cache, path_check = check_swa_on_path(label, api, swa, kref, cfg, params, cache,
                                          toks[:, -1:])
    check(path_check["calls"] == n_attn,
          f"{label}: {path_check['calls']} swa_decode calls in the checked step, expected {n_attn}")
    # Tokens in the cache when the attention runs: the checked step's, then
    # the profile's untraced step and its traced steps.
    first = prompt_len + new_tokens + 1
    dev_ms, swa_ms, ops = profile_decode(api, cfg, params, cache, toks[:, -1:], PROFILE_STEPS)
    step_ms = t_decode / new_tokens * 1e3
    out = dict(
        config=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model, dtype=str(cfg.dtype),
        batch=batch, prompt_len=prompt_len, new_tokens=new_tokens, launches=launches,
        prefill_s=t_prefill, decode_s=t_decode,
        prefill_tok_s=batch * prompt_len / t_prefill, decode_tok_s=batch * new_tokens / t_decode,
        decode_step_ms=step_ms, peak_mib=peak_mib, step_device_ms=dev_ms,
        step_swa_device_ms=swa_ms, step_device_ops=ops, idle_share=1.0 - dev_ms / step_ms,
        profile_lengths=[first + 2, first + 1 + PROFILE_STEPS], path_check=path_check,
        sample=toks[0, :8].tolist(),
    )
    print(f"  {label}: {cfg.name} {cfg.n_layers} layers d={cfg.d_model} {cfg.dtype}, batch "
          f"{batch}, prompt {prompt_len} + {new_tokens} new: prefill {out['prefill_tok_s']:.1f} "
          f"tok/s ({t_prefill:.3f} s), decode {out['decode_tok_s']:.1f} tok/s, {step_ms:.3f} ms "
          f"per step; peak {peak_mib:.1f} MiB; a decode step: {dev_ms:.3f} ms device time in "
          f"{ops} ops (swa_decode {swa_ms * 1e3:.1f} us), idle share {out['idle_share']:.3f}; "
          f"swa_decode launches {launches}  on {name} ({smi})")
    print(f"  {label}: the next step's {path_check['calls']} swa_decode calls (cache lengths "
          f"{path_check['lengths']}, S={path_check['s']}) vs the plain version: max |diff| "
          f"{path_check['max_abs_err']:.3e}; profiled steps at lengths {first + 2}-"
          f"{first + 1 + PROFILE_STEPS} (writes past S={path_check['s']} clamp to the last slot)")
    del params, cache
    torch.cuda.empty_cache()
    return out


def card_vs_cpu(label, api, layers, swa, cfg, dev, batch, steps, gate: bool) -> dict:
    """Teacher-force the same tokens through the model on the card and on
    the CPU (same weights, drawn on the card from seed 1 and copied):
    max over steps of max |dlogit| / max |logit|, gated at ``LM_GATE``
    when ``gate``; the card's ``swa_decode`` launches."""
    gpu_params = api.init_params(torch.Generator(device=dev).manual_seed(1), cfg)
    cpu_params = layers.map_leaves(lambda t: t.cpu(), gpu_params)
    caches = [api.init_cache(cfg, batch, steps + 1, device=dev),
              api.init_cache(cfg, batch, steps + 1, device="cpu")]
    step = api.make_serve_step(cfg)
    toks = torch.randint(0, cfg.vocab_size, (steps, batch, 1),
                         generator=torch.Generator().manual_seed(2), dtype=torch.int32)
    worst, launches = 0.0, 0
    for t in range(steps):
        swa.reset_launches()
        caches[0], got = step(gpu_params, caches[0], toks[t].to(dev))
        launches += swa.LAUNCHES["swa_decode"]
        caches[1], want = step(cpu_params, caches[1], toks[t])
        got = got.cpu()
        check(bool(torch.isfinite(got).all()), f"{label}: non-finite logits at step {t}")
        worst = max(worst, float((got - want).abs().max() / want.abs().max()))
    if gate:
        check(worst <= LM_GATE, f"{label}: card vs CPU max rel |dlogit| {worst:.3e} > {LM_GATE}")
    print(f"  {label} card vs CPU ({cfg.name}, {cfg.n_layers} layers d={cfg.d_model} {cfg.dtype}, "
          f"batch {batch}, {steps} steps teacher-forced): max |dlogit| / max |logit| "
          f"{worst:.3e}{' (gate ' + str(LM_GATE) + ')' if gate else ' (recorded)'}; "
          f"swa_decode launches {launches}")
    del gpu_params, cpu_params, caches
    torch.cuda.empty_cache()
    return dict(max_rel_logit_diff=worst, launches=launches, steps=steps, batch=batch,
                layers=cfg.n_layers, dtype=str(cfg.dtype))


def hybrid_phase(configs, api, layers, serve, rglru, swa, kref, dev, name, smi) -> dict:
    """Phase 15: hybrid-serve (the main path), hybrid-window, and the card
    against the CPU at full width (3 layers, f32) and at REDUCED size (f32
    gated, bf16 recorded)."""
    full = configs.get(HYBRID_ARCH)
    n_attn = rglru.pattern(full).count("attn")
    serve_run = lm_serve("hybrid-serve", api, serve, swa, kref, full, dev, HYBRID_BATCH,
                         HYBRID_PROMPT, HYBRID_NEW, name, smi)
    want = n_attn * (HYBRID_PROMPT + HYBRID_NEW)
    check(serve_run["launches"] == want,
          f"hybrid-serve: {serve_run['launches']} swa_decode launches, expected {want}")
    wcfg = cut(full, WINDOW_LAYERS)
    window_run = lm_serve("hybrid-window", api, serve, swa, kref, wcfg, dev, HYBRID_BATCH,
                          WINDOW_PROMPT, WINDOW_NEW, name, smi)
    want = rglru.pattern(wcfg).count("attn") * (WINDOW_PROMPT + WINDOW_NEW)
    check(window_run["launches"] == want,
          f"hybrid-window: {window_run['launches']} swa_decode launches, expected {want}")
    lay, batch, steps = CPU_VS_CARD["hybrid full width"]
    _, r_batch, r_steps = CPU_VS_CARD["hybrid REDUCED"]
    runs = {"full width f32": (cut(full, lay).replace(dtype=torch.float32), batch, steps, True)}
    for tag, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        runs[f"REDUCED {tag}"] = (configs.get(HYBRID_ARCH, reduced=True).replace(dtype=dtype),
                                  r_batch, r_steps, tag == "f32")
    vs_cpu = {}
    for key, (cfg, batch, steps, gate) in runs.items():
        vs_cpu[key] = card_vs_cpu(f"hybrid {key}", api, layers, swa, cfg, dev, batch, steps, gate)
        want = rglru.pattern(cfg).count("attn") * steps
        check(vs_cpu[key]["launches"] == want,
              f"hybrid {key}: {vs_cpu[key]['launches']} swa_decode launches, expected {want}")
    return {"hybrid-serve": serve_run, "hybrid-window": window_run, "card_vs_cpu": vs_cpu}


def dense_phase(configs, api, layers, serve, swa, kref, dev, name, smi) -> dict:
    """Phase 16: dense-decode (llama3-8b at full width, 2 layers), the card
    against the CPU in f32, and gemma2-27b REDUCED (soft-capped layers:
    the plain branch, no swa_decode launch) against the CPU."""
    dcfg = cut(configs.get(DENSE_ARCH), DENSE_LAYERS)
    run = lm_serve("dense-decode", api, serve, swa, kref, dcfg, dev, DENSE_BATCH, DENSE_PROMPT,
                   DENSE_NEW, name, smi)
    want = DENSE_LAYERS * (DENSE_PROMPT + DENSE_NEW)
    check(run["launches"] == want, f"dense-decode: {run['launches']} swa_decode launches, "
          f"expected {want}")
    lay, batch, steps = CPU_VS_CARD["dense full width"]
    vs_cpu = {"llama3 full width f32": card_vs_cpu(
        "dense", api, layers, swa, cut(configs.get(DENSE_ARCH), lay).replace(dtype=torch.float32),
        dev, batch, steps, gate=True)}
    check(vs_cpu["llama3 full width f32"]["launches"] == lay * steps,
          "dense: swa_decode launches on the card vs CPU run")
    _, batch, steps = CPU_VS_CARD["gemma2 REDUCED"]
    vs_cpu["gemma2 REDUCED f32"] = card_vs_cpu(
        "gemma2 REDUCED", api, layers, swa,
        configs.get("gemma2-27b", reduced=True).replace(dtype=torch.float32), dev, batch, steps,
        gate=True)
    check(vs_cpu["gemma2 REDUCED f32"]["launches"] == 0,
          "gemma2's soft-capped layers launched swa_decode")
    return {"dense-decode": run, "card_vs_cpu": vs_cpu}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs the card",
              file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: {ROOT / 'src' / 'repro_torch'} is missing; run the script from "
              "a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import configs as lm_configs
    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.core import aggregation as agg
    from repro_torch.core import anomaly, hfl
    from repro_torch.core import channel as ch
    from repro_torch.core import compression as comp
    from repro_torch.core import topology as topo
    from repro_torch.core.drift import DriftConfig
    from repro_torch.core.faults import FaultConfig
    from repro_torch.data.pipeline import multi_epoch_indices
    from repro_torch.data.synthetic import SensorDataset, SyntheticConfig, generate, normalize
    from repro_torch.kernels import _build
    from repro_torch.kernels import fused_agg as fa
    from repro_torch.kernels import fused_score as fs
    from repro_torch.kernels import local_train as lt
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import quant8 as kq8
    from repro_torch.kernels import ref as kref
    from repro_torch.kernels import robust_agg as ra
    from repro_torch.kernels import swa_attention as swa
    from repro_torch.kernels import topk_ef as tk
    from repro_torch.launch import experiment as exp
    from repro_torch.launch import serve as lm_launch
    from repro_torch.loadgen import VirtualClock, gaussian_windows, mmpp_trace, replay
    from repro_torch.models import api as lm_api
    from repro_torch.models import autoencoder as ae
    from repro_torch.models import layers as lm_layers
    from repro_torch.models import rglru
    from repro_torch.serving import ScoringService, StreamingCalibrator

    # The serving package re-exports a function named ``score`` that
    # shadows the submodule.
    score_mod = importlib.import_module("repro_torch.serving.score")
    torch.backends.cuda.matmul.allow_tf32 = False    # plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False

    phase("1. device")
    dev = torch.device("cuda:0")
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi()
    print(f"device: {name}  capability {cap}  count {count}")
    print(f"nvidia-smi: {smi}")
    print(f"torch {torch.__version__}  cuda {torch.version.cuda}  python {sys.version.split()[0]}")
    check(tuple(cap) == (9, 0), f"capability {cap}, the kernels need (9, 0)")

    phase("2. build")
    t0 = time.perf_counter()
    built = _build.build()
    print(f"built {sorted(built)} in {time.perf_counter() - t0:.2f} s with "
          f"{' '.join(_build.NVCC_FLAGS)}")
    for src in sorted(built):
        for line in _build.ptxas_report(src).splitlines():
            if any(k in line for k in ("Compiling entry", "Used", "spill", "smem")):
                print(f"  {src}: {line.strip()}")

    phase("3. kernels against their plain versions")
    max_err = {k: 0.0 for k in KERNELS}
    for d, hidden in ((D, HIDDEN), WIDE):
        for rows in CHECK_ROWS:
            for q8, kname in ((False, "fused_score_f32"), (True, "fused_score_q8")):
                params, x, tau = kernel_case(
                    ae, score_mod.quantize_params, d, hidden, rows, q8, dev, rows + d
                )
                tensors = layer_tuples(params, q8)
                if q8:
                    out = fs.score_rows_q8(x, tau, *tensors)
                    ref = kref.fused_score_q8_ref(x, *tensors, tau)
                else:
                    out = fs.score_rows(x, tau, *tensors)
                    ref = kref.fused_score_ref(x, *tensors, tau)
                torch.cuda.synchronize()
                e = compare(*out, *ref, tau)
                max_err[kname] = max(max_err[kname], e)
                print(f"  {kname:16s} d={d:3d} rows={rows:6d} max|err diff|={e:.3e}  ok")

    phase("4. serving (main path)")
    ds = normalize(generate(
        torch.Generator().manual_seed(0),
        SyntheticConfig(n_sensors=N_SENSORS, val_len=VAL_LEN, test_len=TEST_LEN),
        device=dev,
    ))
    mods = (ae, anomaly, CheckpointStore, ScoringService, StreamingCalibrator, fs, score_mod)
    fs.reset_launches()
    summaries = {}
    global_tau = None
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=ROOT / "build") as tmp:
        workdir = Path(tmp)
        for weight_dtype in ("f32", "int8"):
            svc, launched, f1s = serve_fleet(mods, ds, weight_dtype, workdir)
            summaries[weight_dtype] = svc.stats.summary()
            if weight_dtype == "f32":
                global_tau = float(svc.calibrator.global_tau)
            print(f"  {weight_dtype}: {launched} launches, pointwise F1 (random weights) "
                  f"wave 1 {f1s[0]:.4f}, wave 2 {f1s[1]:.4f}")
            print(f"  {weight_dtype} summary: {json.dumps(summaries[weight_dtype])}")

        phase("5. load (MMPP trace, virtual clock)")
        store = CheckpointStore(str(workdir / "load"), keep=2)
        params = ae.init(torch.Generator().manual_seed(0), D, HIDDEN, device="cpu")
        store.publish(1, params)
        trace = mmpp_trace(1, rate_on_hz=2000.0, mean_on_s=0.3, mean_off_s=0.5,
                           duration_s=4.0, fleet=N_SENSORS, n_fog=N_FOG, rows=16)
        clock = VirtualClock()
        svc = ScoringService(store, params, buckets=BUCKETS, max_wait_s=MAX_WAIT_S,
                             tau=global_tau, clock=clock)
        rep = replay(svc, trace, clock, windows=gaussian_windows(trace, D), d=D)
        check(rep.completed == trace.n_events, "load replay left requests behind")
        load = rep.summary()
        print(f"  {trace.n_events} events, {load['samples']} rows on {name} ({smi}): "
              f"e2e p50 {load['e2e_p50_ms']:.3f} ms, p99 {load['e2e_p99_ms']:.3f} ms, "
              f"{load['samples_per_s']:.0f} samples/s over step time, "
              f"{load['steps']} steps, mean fill {load['mean_fill']:.1f}, "
              f"buckets used {load['compiles_by_bucket']}")
    main_path_launches = dict(fs.LAUNCHES)
    for kname, n in main_path_launches.items():
        check(n > 0, f"{kname} was not launched on the main path")
    print(f"  main-path launches: {main_path_launches}")

    phase("6. timing (profiler device time; CUDA events per call)")
    floor = launch_floor(_build, name, smi)
    g = torch.Generator().manual_seed(1)
    params = ae.init(g, D, HIDDEN, device=dev)
    qparams = score_mod.quantize_params(params)
    rows_table = {k: {} for k in KERNELS}
    for rows in TIME_ROWS:
        x = torch.randn((rows, D), generator=g).to(dev)
        tau = torch.full((rows,), 40.0, device=dev)
        n = 200 if rows <= 1024 else 100
        for q8, kname in ((False, "fused_score_f32"), (True, "fused_score_q8")):
            tensors = layer_tuples(qparams if q8 else params, q8)
            kernel = fs.score_rows_q8 if q8 else fs.score_rows
            plain = kref.fused_score_q8_ref if q8 else kref.fused_score_ref
            def run_kernel():
                return kernel(x, tau, *tensors)

            def run_plain():
                return plain(x, *tensors, tau)

            calls = {"call_ms": call_ms(run_kernel, n), "plain_call_ms": call_ms(run_plain, n)}
            (ms, _), (plain_ms, plain_kernels) = device_ms(run_kernel, 50), device_ms(run_plain, 50)
            bound_ms, bound_by = bound(D, HIDDEN, rows, q8)
            rows_table[kname][rows] = dict(
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                plain_device_ops_per_call=plain_kernels, **calls,
            )
            print(f"  {kname:16s} rows={rows:6d} device time: kernel {ms * 1e3:8.3f} us  "
                  f"plain {plain_ms * 1e3:8.3f} us  bound {bound_ms * 1e3:8.4f} us "
                  f"({bound_by}), launch floor {floor['ms'] * 1e3:.3f} us; per call by CUDA "
                  f"events: kernel "
                  f"{calls['call_ms'] * 1e3:8.3f} us, plain {calls['plain_call_ms'] * 1e3:8.3f} us"
                  f"  on {name} ({smi})")
    host_cost = wrapper_host_cost(dev, fs, fa, ae, kops, comp, name, smi)
    train_kmods = (lt, fa, kops, kref, ae, multi_epoch_indices)
    train_timing = time_training_kernels(dev, *train_kmods, name, smi)
    train_timing.update(time_new_kernels(dev, fa, ra, kops, kref, agg, comp, ae, name, smi))
    train_timing.update(time_compress_kernels(dev, kq8, tk, kops, kref, comp, ae, name, smi))

    phase("7. training kernels against their plain versions")
    train_err = check_training_kernels(dev, *train_kmods)
    train_err.update(check_new_kernels(dev, fa, ra, kref, agg, comp))
    for kname, e in check_fleet_kernels(dev, fa, ra, kops, kref, agg, comp, ae).items():
        train_err[kname] = max(train_err[kname], e)
    wire_edges = check_wire_edges(dev, fa, kref)

    phase("8. training (main path): hfl-selective at N=200, T=20")
    train_ds = normalize(generate(
        torch.Generator().manual_seed(0),
        SyntheticConfig(n_sensors=TRAIN_N, train_len=WINDOW, val_len=VAL_LEN, test_len=TEST_LEN),
        device="cpu",
    ))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=ROOT / "build") as tmp:
        training = train_fleet((exp, hfl, ae, CheckpointStore, SensorDataset, train_ds, lt, fa),
                               dev, name, smi, Path(tmp))

    phase("9. robust-200 (main path): Byzantine clients, trimmed mean on the card")
    robust = robust_fleet(exp, hfl, ae, SensorDataset, FaultConfig, train_ds, fa, ra, dev, name,
                          smi)

    phase("10. fleet-10k (main path): client-chunked rounds, N=10,000")
    fleet = fleet_scale(exp, hfl, ae, SensorDataset, generate, normalize, SyntheticConfig, fa,
                        dev, name, smi)

    phase("11. compressor kernels against their plain versions")
    comp_err, tied_blocks = check_compress_kernels(dev, kq8, tk, fa, kops, kref, comp)
    train_err.update(comp_err)

    phase("12. legacy-200 (main path): the per-client compressor, N=200, T=20")
    legacy = legacy_fleet(exp, hfl, ae, agg, comp, kops, train_ds, kq8, tk, fa, training, dev,
                          name, smi)

    phase("13. drift-200 (main path): the dynamic world, N=200, T=20")
    drift = drift_fleet(exp, hfl, ae, topo, ch, DriftConfig, train_ds, lt, fa, dev, name, smi)

    phase("14. swa_decode against its plain version; timing at hybrid-window's and "
          "dense-decode's shapes")
    swa_err = check_swa_kernel(dev, swa, kref)
    swa_timing = time_swa_kernel(dev, swa, kref, name, smi)
    swa_timing["dense_decode_shape"] = time_swa_kernel(dev, swa, kref, name, smi,
                                                       SWA_TIME_DENSE)

    phase("15. hybrid-serve (main path): recurrentgemma-2b decode serving")
    hybrid = hybrid_phase(lm_configs, lm_api, lm_layers, lm_launch, rglru, swa, kref, dev, name,
                          smi)

    phase("16. dense-decode (main path): llama3-8b at full width, 2 layers")
    dense = dense_phase(lm_configs, lm_api, lm_layers, lm_launch, swa, kref, dev, name, smi)
    phase("done")

    kernels = []
    for kname, replaces in KERNELS.items():
        head = rows_table[kname][HEADLINE_ROWS]
        kernels.append({
            "name": kname,
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/fused_score.cu",
            "replaces": replaces,
            "launches": main_path_launches[kname],
            "max_abs_err": max_err[kname],
            "ms": head["ms"],
            "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"],
            "library_ms": None,
            "call_ms": head["call_ms"],
            "rows": HEADLINE_ROWS,
            "by_rows": {str(r): v for r, v in rows_table[kname].items()},
        })
    launches = dict(training["launches"])
    launches["robust_agg"] = robust["launches"]["robust_agg"]
    launches.update({k: fleet["chunked"]["launches"][k] for k in ("wire_emit", "wire_agg")})
    launches["compress_q8"] = legacy["variants"]["fused=False int8"]["launches"]["compress_q8"]
    launches["topk_ef"] = legacy["variants"]["fused=False f32"]["launches"]["topk_ef"]
    launches["quant8"] = legacy["codec_launches"]
    for kname, (replaces, source) in {**TRAIN_KERNELS, **NEW_KERNELS,
                                      **COMPRESS_KERNELS}.items():
        check(launches[kname] > 0, f"{kname} was not launched on its main path")
        t = train_timing[kname]
        kernels.append({
            "name": kname,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches[kname],
            "max_abs_err": train_err[kname],
            "library_ms": None,
            **t,
        })
    print(json.dumps({"training": training}))
    print(json.dumps({"robust": robust}))
    print(json.dumps({"fleet": fleet}))
    print(json.dumps({"legacy": legacy, "tied_blocks": tied_blocks}))
    print(json.dumps({"drift": drift}))
    print(json.dumps({"launch_floor": floor, "wrapper_host_cost": host_cost,
                      "compress_q8_at_fleet_chunk": train_timing["compress_q8 @ fleet chunk"],
                      "wire_emit_edge_cases": wire_edges}))
    replaces, source = SWA_KERNEL
    kernels.append({
        "name": "swa_decode",
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": hybrid["hybrid-serve"]["launches"],
        "max_abs_err": max([swa_err["max_abs_err"]] + [
            run["path_check"]["max_abs_err"] for run in (hybrid["hybrid-serve"],
                                                         hybrid["hybrid-window"],
                                                         dense["dense-decode"])]),
        **swa_timing,
        "launches_by_path": {"hybrid-serve": hybrid["hybrid-serve"]["launches"],
                             "hybrid-window": hybrid["hybrid-window"]["launches"],
                             "dense-decode": dense["dense-decode"]["launches"]},
    })
    print(json.dumps({"lm": {"swa_check": swa_err, "hybrid": hybrid, "dense": dense}}))
    print("phase seconds: " + ", ".join(f"{k.split('.')[0]} {v:.1f}" for k, v in PHASE_S.items()
                                        if k != "done"))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
