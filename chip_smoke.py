#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one Hopper card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one sm_90 CUDA card, nvcc (``$CUDA_HOME`` or ``/usr/local/cuda``)
and nothing of JAX.  Phases, in order; any failure exits non-zero before
the result line:

1. device  — name, capability, count, ``nvidia-smi`` name and power limit;
2. build   — both fused score kernels from ``kernels/csrc`` with nvcc for
             sm_90a, printing ptxas's registers, shared memory and spills;
3. kernels — each kernel against its plain PyTorch version on the card at
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
6. timing  — each kernel at 128 / 1,024 / 65,536 rows beside its plain
             version and its bound: device time per call from
             torch.profiler (CUPTI; ``ms`` and ``plain_ms``, and the run
             fails when the profiler records no device time), and per-call
             time by CUDA events over back-to-back calls, host dispatch
             included (``call_ms`` and ``plain_call_ms``).

The launch counts reported are those of phases 4 and 5 (the counters are
zeroed just before phase 4 and read just after phase 5).  The last line is
``{"ok": true, "device": {...}}``; the line before it is the card's name
and power limit, and the one before that the ``kernels`` JSON.
"""
from __future__ import annotations

import importlib
import json
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


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def phase(name: str) -> None:
    print(f"\n=== {name}", flush=True)


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
    b, o = work(d, hidden, rows, q8)
    t_bytes, t_ops = b / PEAK_BYTES_S, o / PEAK_F32_FLOP_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


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


def device_ms(fn, n: int) -> tuple[float, float]:
    """(device ms per call, device activities per call) over ``n`` calls,
    from torch.profiler's CUPTI trace.  Fails when the profiler recorded
    no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    check(bool(dev), "torch.profiler recorded no device time")
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.core import anomaly
    from repro_torch.data.synthetic import SyntheticConfig, generate, normalize
    from repro_torch.kernels import _build
    from repro_torch.kernels import fused_score as fs
    from repro_torch.kernels import ref as kref
    from repro_torch.loadgen import VirtualClock, gaussian_windows, mmpp_trace, replay
    from repro_torch.models import autoencoder as ae
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
                  f"({bound_by}); per call by CUDA events: kernel "
                  f"{calls['call_ms'] * 1e3:8.3f} us, plain {calls['plain_call_ms'] * 1e3:8.3f} us"
                  f"  on {name} ({smi})")

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
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
