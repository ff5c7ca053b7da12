#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one Hopper card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one sm_90 CUDA card, nvcc (``$CUDA_HOME`` or ``/usr/local/cuda``),
the port's sources beside it (``src/repro_torch``; without them it exits 1)
and nothing of JAX.  ``python3 chip_smoke.py --timing`` runs phases 1, 2
and 6 alone (with the three per-client compressors timed on a Gaussian
row of federated-llm's 1.49e9 coordinates, phase 26's timing, and
``compress_q8`` on phase 21 (f)'s gradient row) and prints their
numbers without the result line: a copy of
the script run from an older checkout times that checkout's kernels the
same way (the A/B of two kernel designs).  Phases, in order; any failure
exits non-zero before the result line:

1. device  — name, capability, count, ``nvidia-smi`` name and power limit;
2. build   — every kernel source in ``kernels/csrc`` with nvcc for sm_90a,
             one nvcc each, all started together, printing ptxas's
             registers, shared memory and spills;
3. kernels — each score kernel against its plain PyTorch version on the card at
             rows 1..65,536, at the paper AE and at d=130 (64, 8, 64), with
             per-row tau and a NaN row (err to rtol=atol=1e-5, flags
             exactly away from tau); ``fused_score_q8`` bitwise equal to
             ``fused_score_f32`` on the dequantised weights at each case,
             and a row's err bitwise equal in 1-, 128-, 1,024- and
             65,537-row batches;
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
             new_err equal to ``compress_q8``'s (all of them select with
             ``team_threshold``, a team sized to the block's real width);
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
             layers: no ``swa_decode`` launch);
17. flat-200 — the paper's flat baselines at train-200's settings on
             phase 8's draws: fedavg, fedprox, fedadam (``local_train_f32``
             and ``fused_agg`` once a round each, ``n_fog = 1``), scaffold
             (the client scan in plain PyTorch: no kernel), fedavg under
             robust-200's attack (trimmed 0.45: ``robust_agg`` with one
             fog) and the centralised oracle cut to T = 1, E = 1 (1,600
             plain SGD steps over the pooled rows), each on the card with
             every training kernel's launches counted and against a CPU
             twin (participation and erasures exactly, energies to
             rtol=1e-5, loss within 1%, F1 within 0.02); ms per round and
             idle share of fedavg; its mean participation beside phase 8's;
18. engine-200 — the batched trial ``Engine`` (``repro_torch.engine``) on
             the card: ``Engine.run`` of train-200's hfl-selective over
             seeds 0-3 x 2 deployments (8 trials in one call, folded into
             the kernels' client and fog axes), fedavg and robust-200's
             attack under trim 0.45 over 2 x 2; each cell's launches equal
             to one sequential trial's (20 ``local_train_f32`` and 40
             ``fused_agg``; ``robust_agg`` 20 under attack) and each trial
             (s, 0) against a sequential card trial from seed s
             (participating sensor-rounds, coop links, erasures and
             non-finite deltas exactly, energies to rtol=1e-5, losses to
             rtol=1e-4, F1 within 1e-3; which metrics are bitwise is
             printed); ``Engine.audit`` of the four hfl methods and fedavg
             and ``Engine.reachability`` over seeds 0-7 against
             ``audit_method`` / ``participation.reachability`` (the
             direct-gateway fraction printed); ``Engine.score`` of the
             cell's published trial (0, 0) over serve-200's test rows (one
             ``fused_score_f32`` launch, bitwise ``serving.score``); ms per
             trial-round, device ops and idle share of the batched round
             loop at B = 1, 4 and 16 trials, and ``local_train_f32`` and
             ``fused_agg`` timed at B = 16 (3,200 clients, 320 fogs);
19. async-200 — the event-driven async family (``core/async_fl``,
             method ``hfl-async``) at train-200's width: the sync limit
             (``async_fl.sync_limit``, 20 events) on phase 8's draws
             against phase 8's trial (losses within 1%, participation
             exactly, energy to rtol=1e-5, F1 within 0.02, 20 merges,
             staleness 0, one trial's launches); ``async_bench``'s three
             staleness cells (alpha, buffer fraction (0, 0.5), (0.5, 0.25),
             (1, 0.25); fog_k 2; 60 events) through one ``Engine.sweep``
             over seeds 0-2, the sync baseline (``Engine.run`` of the sync
             limit) and the MMPP replay cell (per-sensor delays from
             ``mmpp_trace(1047, ...)``), robust-200's attack under trimmed
             0.45 on cell (0.5, 0.25): each Engine call's launches n_events
             x one event's (1 ``local_train_f32``, 2 ``fused_agg``, + 1
             ``robust_agg`` under attack) for all its folded trials (the
             sweep's 3 cells x 3 seeds too: one call); sim s
             per merge, ``speedup_vs_sync``, F1, staleness per cell; cell
             (0.5, 0.25)'s seed-0 trial (60 events) on the card against
             the CPU (merges, launches, arrivals, erasures
             and links exactly per event, energies and the clock to
             rtol=1e-5, losses within 1%); ms per event at B = 1 and per
             trial-event at B = 3, device ops and idle share, and host
             syncs per event under ``torch.cuda.set_sync_debug_mode``;
20. mesh-200 — the client-sharded round loop over ``torch.distributed``
             (``launch/sharding.ClientMesh``), ranks spawned (``spawn``,
             a ``file://`` rendezvous under ``build/``) after the earlier
             phases built the kernels: a mesh rank's ``local_train_f32``
             and ``fused_agg`` at 100 clients against their plain
             versions; (a) one NCCL rank, ``hfl.train`` on phase 8's
             draws bitwise equal to the unsharded card run (losses,
             params, counters, energies); (b) two gloo ranks sharing the
             card, ``hfl-selective`` and ``fedavg`` at train-200 against
             the unsharded card trials (participation, erasures and coop
             links exactly and equal to phases 8 / 17, energies rtol
             1e-5, losses within 1%, F1 within 0.02; the params after 20
             rounds reported), the ranks' params bitwise equal, each
             rank one trial's launches (20 ``local_train_f32``, 40
             ``fused_agg``) on 100 clients each; both families cut to 2
             rounds, the reference's test's depth, with params to atol
             1e-5 and losses to rtol 1e-4; ms per round and the ms per round in ``all_reduce``;
             (c) mesh-10k, phase 10's chunked fleet on the two ranks: ms
             per round and each rank's peak device memory beside phase
             10's; (d) ``Engine(shard_clients=True)`` and
             ``Engine(shard_trials=True)`` over train-200 cut to 2 rounds,
             seeds 0-1 x 2 deployments, against ``Engine()`` (losses rtol
             1e-4, F1 atol 1e-6, counters exactly);
21. lm-train — language-model training and the full-sequence forward, and
             the pod family: (a) hybrid-train, the main path:
             ``launch/train.main(["production", "--arch",
             "recurrentgemma-2b", "--full", "--steps", "5", "--batch",
             "4", "--seq", "512"])`` on the card (26 layers, d 2,560,
             vocab 256,000, bf16, remat): ms a step after the first,
             tokens/s, peak memory, finite losses; a REDUCED checkpoint
             saved and restored on the card bitwise, and the launcher
             resuming from its own; (b) dense-train, llama3-8b uncut, the
             same; (c) one train step on the card against the CPU from the
             same f32 weights and tokens (recurrentgemma-2b at full width
             cut to 3 layers, llama3-8b cut to 2, gemma2-27b and
             internvl2-26b REDUCED; batch 2 x 64, lr 1e-2): loss within
             1e-4 relative, every leaf's update within 1e-3 of the
             largest update coordinate; REDUCED bf16 recorded; (d)
             ``make_prefill_step`` at hybrid-serve's shape beside phase
             15's token-stepped prefill, and in f32 cut to 3 layers the
             forward's last hidden state through the tied embedding held
             to the token-stepped prefill's last logits (``LM_GATE``), the
             token-stepped side's ``swa_decode`` launches n_attn x 256;
             (e) ``mesh_fl``'s pod step, llama3-8b at full width cut to 2
             layers, int8, E = 1 and 2, 3 steps, as one NCCL rank and as
             the one-process 2-pod loop (ms a step, bytes a pod a step,
             peak memory), then two gloo ranks sharing the card at
             REDUCED in both modes, bitwise the 2-pod loop; (f) the
             federated-LLM example at REDUCED on the card against the CPU
             (f32 losses within 1e-4, bf16 recorded, 5 ``compress_q8``
             launches each), and one
             ``compress_update`` of llama3-8b cut to 2 layers (one f32 row
             of 1,486,901,248 coordinates): ``compress_q8``'s device time
             against its bound, peak memory, and whole-block slices (first,
             middle, last, and the last of the row cut by 4,113, a ragged
             block) bitwise the plain version;
22. lm-families — the moe, ssm and encdec families and qwen3 (random
             weights from seeds; cuts are depth only): (a) moe-serve,
             qwen2-moe-a2.7b uncut (24 layers, 1.43e10 params, bf16),
             batch 8, 128 prompt + 32 greedy tokens through
             ``launch/serve`` as phase 15's runs: ms a decode step,
             tokens/s, peak memory, the device time and idle share of 5
             profiled steps, ``swa_decode`` launches 24 x 160 and the next
             step's calls against the plain version; (b) moe-train, the
             same at full width cut to 12 of 24 layers, 4 x 512 (one
             dispatch group, capacity 170), bf16, remat, 5 steps: ms a
             step, tokens/s, peak memory, the router aux; (c)
             grok-decode, grok-1-314b at full width cut to 2 of 64 layers
             (d_ff 32,768, GQA groups of 6), 8 x (32 + 16); (d) mamba2-2.7b
             uncut: ``launch/train production --full`` 4 x 512, 5 steps;
             decode 8 x (128 + 32) and the decode state's bytes; prefill
             by ``forward`` at 8 x 256 beside the token-stepped prefill;
             (e) whisper-medium uncut: ``launch/train production --full``
             4 x 448 with (4, 1,500, 1,024) frames, 5 steps; decode 8 x
             (128 + 32) after ``precompute_cross_kv`` (``swa_decode``
             launches 24 x 160); prefill by ``forward`` at 8 x 128; (f)
             qwen3-14b at full width cut to 2 of 40 layers, 8 x (128 +
             32); (g) card vs CPU in f32: one train step (loss 1e-4
             relative, every update within 1e-3 of its largest coordinate
             at lr 1e-2) and 16 teacher-forced decode steps (logits within
             1e-3 of the largest) of qwen2-moe at full width cut to 2
             layers, mamba2 cut to 2, whisper cut to 2 + 2, and qwen3-14b,
             qwen3-32b and grok-1 at REDUCED; a MoE's expert ids recorded
             on both sides, the gates held where no token-slot differs and
             the error recorded where one does; then, on the card, whisper
             2 + 2 in f32: decode after ``precompute_cross_kv`` against
             ``forward``'s logits at 32 positions (1e-3);
23. launch-tooling — (a) the four examples of ``repro_torch.examples`` on
             the card at the reference's defaults: ``quickstart`` (four
             methods, 24 sensors), ``train_iout_hfl`` (10 rounds on SMD's
             surrogate, checkpoints kept 2), ``serve_anomaly`` (6 rounds,
             a hot-swap: swaps >= 1) and ``load_replay --duration 4
             --int8``, each with every counter zeroed just before it and
             read just after: ``local_train_f32`` and ``fused_agg`` launched
             by the three training examples, ``fused_score_f32`` by
             ``serve_anomaly`` and ``load_replay``, ``fused_score_q8`` by
             ``load_replay``; (b) three ``sgd.adam`` steps of llama3-8b
             REDUCED in f32 on the card against the CPU (each leaf within
             1e-6 of its largest value); (c) the dry run
             (``launch/dryrun.dryrun_one`` on a one-chip plan) of phase
             21's dense-train (llama3-8b uncut, 4 x 512, bf16, remat) and
             phase 22's grok-decode (2 of 64 layers, 8 x (32 + 16)): its
             parameter bytes equal to the bytes those phases held on the
             card, its planned peak beside their ``max_memory_allocated``,
             and the roofline's bound and dominant term (``launch/
             roofline`` on the H100's figures) beside their measured step,
             with the model-FLOP share 6 (train) or 2 (decode) x N x tokens
             / (step s x 989.4 TFLOP/s);
24. sweep-200 — ``Engine.sweep`` at train-200's width, each shape class
             one batched call over its cells' trials: (a) wind x shipping
             x eta_ea, 8 cells x seeds 0-1 (one class, B = 16); (b) the
             robustness benchmark's attack grid (mean / trimmed 0.45 /
             median x byz_frac 0, 0.25 x erasure 0, 0.3; 3 classes of 4
             cells); (c) the Fig. 6 N = 200 audit (four methods x
             compressed / dense, a method and payload a cell, seeds 0-2);
             (d) phase 19's three staleness cells at 20 events.  Each class launches
             as one of its cells does, each cell equals its own
             ``Engine.run`` / ``Engine.audit`` on the card (counters
             exactly, energies rtol=1e-5, losses 1e-4 and F1 1e-3; 1% and
             0.02 for the async and robust cells), the (a) and (b) calls'
             own kernel inputs are held to the plain versions, and the
             seconds of each sweep against its cells one after another,
             ms per trial-round and the device idle share are printed;
25. data-axis — the reference's ``data`` mesh axis, gloo ranks spawned on
             the one card (``mesh_rank``): (a) hybrid-train as 2 ranks
             (``launch/train.main production --full``, recurrentgemma-2b
             uncut, 4 x 512, 3 steps, data-parallel over the ranks' group):
             both ranks' params the same bits (``leaf_digests``), losses
             within 2^-8 relative of phase 21's one-process run; ms a step,
             the share of it in the f32 mean-reductions and the peak a
             rank; (b) recurrentgemma-2b at full width cut to 3 layers, f32,
             lr 1e-2, 2 ranks against one process on the whole batch:
             params the same bits on both ranks, loss to rtol 1e-5,
             gradients and update within 1e-4 of their largest; (c) the
             pod step over ``pod_data_mesh(2)``, 2 pods x 2 data ranks (4
             ranks) at llama3-8b REDUCED f32, int8 and topk, E = 1 and 2:
             the four ranks' params the same bits, a pod's data ranks'
             error buffers the same bits, params and error buffers within
             neighbouring int8 codes (at most 1e-3 of a leaf's
             coordinates, or two) of the one-process 2-pod loop; (d)
             qwen2-moe at full width cut to 2 layers, f32, 8 x 512 (one
             2,048-token dispatch group a rank), lr 1e-1, 2 ranks against
             one process, (b)'s gates where no expert slot differs; (e) the
             same model at 2 x 1,024 and capacity factor 0.25 (one row a
             rank: one dispatch group spanning both ranks, its queue
             places taken from the ranks' all-gathered selection counts;
             most selections dropped), at (b)'s gates whatever its
             differing expert slots, which are recorded, and with the
             selections kept over the ranks equal to the one-process
             forward's where none differs.  No kernel is on these paths;
26. long-row — the three per-client compressors on one row of 2^31 +
             8,209 coordinates (262,145 full blocks, one starting at 2^31,
             then a 17-wide one): ``compression.compress_update`` (the user
             entry) launching ``compress_q8`` once; then ``compress_q8``,
             ``quant8`` and ``topk_ef`` each on the row, bitwise their plain
             versions on whole-block slices (the first block, blocks
             262,143 and 262,144 on either side of 2^31, the last), timed
             by CUDA events beside their bytes bounds, each row's outputs
             freed before the next.  ``--timing`` times the three at
             federated-llm's row (d = 1,486,901,248) instead.

Phase 6 also times ``fused_agg`` at robust-200's identity call (N =
n_fog = 200), at one of its 64-client chunks and at fleet-10k's unchunked
call (N = 10,000 into 1,000 fogs), and with 66,000 identity fogs (kernel
only), each also by launch (``select``, ``sum``); ``robust_agg`` by launch
too (the member list, the reduce); and ``robust_agg``, ``wire_emit`` and
``wire_agg`` at the
shapes of phases 9 and 10 (``wire_agg`` also as one 10,000-client call,
and at a chunk as deep as that call's deepest fog: the difference is the
longer member scan), ``compress_q8`` and ``topk_ef`` at train-200's
shape and at N = 200, d = 8,209 (a block team and a small team a row),
``compress_q8`` again at fleet-10k's chunk (the rows ``wire_emit``
selects there) and at k = 1,352 (legacy-200's quantise-only trial), and
``quant8`` on a 2^20-coordinate vector, at the codec's shape (N = 200, d
= 1,352) and at N = 200, d = 8,209; phase 7 holds the robust and wire
kernels against their plain versions over a grid and at fleet-10k's shapes (``fused_agg`` at N =
10,000 into 1,000 fogs, its fog sums bitwise equal to the client-order
fold ``ref.dense_fold_ref`` there and over phase 7's grid, with its
thresholds and new_err bitwise the plain version's; ``robust_agg``'s
member lists on the card equal ``robust_agg.member_lists`` element for
element; the wire pair chunk by chunk into running sums
and ``wire_agg`` in one 10,000-client call, ``robust_agg`` at N = 30,000
with a fog of 3,000), the wire's slots, codes, scales and new_err
bitwise, ``wire_agg``'s sums bitwise equal to the client-order fold
(``ref.wire_fold_ref``), and ``wire_emit`` over its edges
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
after; phases 15–16 check the other runs' counts too, phase 17 every
training kernel's count in each flat trial, phase 18 every one in
each Engine cell, phase 19 every one in each async Engine call and
phase 20 each mesh rank's, beside the phase 8 count in
``launches_by_path``; phase 21 adds ``compress_q8``'s launches in the
federated-LLM example and ``swa_decode``'s in its token-stepped prefill
check there, and ``compress_q8``'s time at the example's d to its
``by_shape``; phase 22 adds ``swa_decode``'s launches in moe-serve,
grok-decode, encdec-decode and qwen3-decode, and their calls' errors;
phase 23 adds each score and training kernel's launches in its four
examples, phase 24 each training kernel's in one sweep class; phase 25
launches none; phase 26 adds the three compressors' times on its row to
their ``by_shape``).  The last line is
``{"ok": true, "device": {...}}``; the line before it is the card's name and power limit, and the
one before that the ``kernels`` JSON.
"""
from __future__ import annotations

import ctypes
import importlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

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
COMP_WIDE_D = 8209               # phase 6: a full block and a 17-wide one per row
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


def same_scores(a, b) -> bool:
    """Two (err, flag) results bitwise equal (NaN rows in the same places)."""
    (err_a, flag_a), (err_b, flag_b) = a, b
    fin = ~err_b.isnan()
    return (torch.equal(err_a.isnan(), ~fin) and torch.equal(flag_a, flag_b)
            and torch.equal(err_a[fin], err_b[fin]))


def dequantised(qws, sws):
    """The f32 weights ``q.to(f32) * s`` that ``fused_score_q8`` scores with."""
    return tuple(q.to(torch.float32) * s.reshape(1, -1) for q, s in zip(qws, sws))


def check_q8_any_batch(dev, fs, ae, quantize_params) -> int:
    """Phase 3: at the paper AE and at d=130, a row's ``fused_score_q8``
    err in a 65,537-row batch bitwise equal to its err in batches of 1,
    128 and 1,024 rows at other offsets.  Returns the batches checked."""
    checked = 0
    for d, hidden in ((D, HIDDEN), WIDE):
        params, x, tau = kernel_case(ae, quantize_params, d, hidden, 65_537, True, dev, d)
        tensors = layer_tuples(params, True)
        whole = fs.score_rows_q8(x, tau, *tensors)
        for lo, rows in ((7, 1), (301, 128), (1030, 1024)):
            part = fs.score_rows_q8(x[lo:lo + rows].contiguous(), tau[lo:lo + rows].contiguous(),
                                    *tensors)
            check(same_scores(part, tuple(t[lo:lo + rows] for t in whole)),
                  f"fused_score_q8 err differs in a {rows}-row batch at d={d}")
            checked += 1
    print(f"  fused_score_q8   a row's err bitwise equal in 1-, 128-, 1,024- and 65,537-row "
          f"batches at d={D} and d={WIDE[0]}  ok")
    return checked


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


def device_events(run, host: bool = True) -> list:
    """The device activities of torch.profiler's CUPTI trace of ``run()``
    (which ends in a ``torch.cuda.synchronize``); ``host=False`` traces the
    device alone (no host op events to collect: far less to process for a
    long run).  A trace that comes back without device activity is taken
    again, up to ``PROFILE_TRIES`` traces; the run fails when none
    recorded any."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if host else [
        ProfilerActivity.CUDA]
    for attempt in range(PROFILE_TRIES):
        with profile(activities=activities) as prof:
            run()
        dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if dev:
            return dev
        print(f"  torch.profiler recorded no device time (trace {attempt + 1} of "
              f"{PROFILE_TRIES})")
    check(False, "torch.profiler recorded no device time")


def device_ms(fn, n: int, warm: bool = True, host: bool = True) -> tuple[float, float]:
    """(device ms per call, device activities per call) over ``n`` calls,
    from torch.profiler's CUPTI trace (:func:`device_events`, ``host`` as
    there), after one untraced warm-up call unless ``warm`` is False."""
    if warm:
        fn()
        torch.cuda.synchronize()

    def run():
        for _ in range(n):
            fn()
        torch.cuda.synchronize()

    dev = device_events(run, host)
    return sum(e.time_range.elapsed_us() for e in dev) / 1e3 / n, len(dev) / n


def device_split(fn, n: int, parts: dict, rest: str | None = None) -> dict:
    """Device ms per call of ``fn`` by kernel name, over ``n`` calls
    (torch.profiler, :func:`device_events`): each label of ``parts`` (label
    -> a substring of the kernel's name) sums the activities whose name
    holds its substring, ``rest`` every other one; with the activities per
    call of each label under ``<label> ops``."""
    fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(n):
            fn()
        torch.cuda.synchronize()

    labels = [*parts, *([rest] if rest else [])]
    out = {**dict.fromkeys(labels, 0.0), **{f"{k} ops": 0.0 for k in labels}}
    for e in device_events(run):
        label = next((k for k, sub in parts.items() if sub in e.name), rest)
        if label is not None:
            out[label] += e.time_range.elapsed_us() / 1e3 / n
            out[f"{label} ops"] += 1.0 / n
    return out


# fused_agg's two launches and robust_agg's member list and reduce, by the
# kernels' names (the first designs' names too: the list was PyTorch ops).
FUSED_SPLIT = ({"select": "select_kernel", "sum": "sum_kernel"}, None)
ROBUST_SPLIT = ({"aggregate": "robust_kernel"}, "member list")


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


def wire_agg_work(idx, fog_id, d, quantize) -> tuple[int, int]:
    """(bytes, operations) of one wire aggregate into running sums, counted
    on this call's data: the slots, scales, ids and weights read once, and
    each fog coordinate the call touches read and written once; per slot
    within the real columns two multiplies and an add."""
    n, nb, k = (int(s) for s in idx.shape)
    col = torch.arange(nb, device=idx.device)[None, :, None] * 8192 + idx.long()
    real = col < d
    touched = int(torch.unique((fog_id.long()[:, None, None] * d + col)[real]).numel())
    return (n * nb * k * (5 if quantize else 8) + 4 * n * nb + 8 * n + 8 * touched,
            3 * int(real.sum()))


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
    card (``fused_agg``'s thresholds and new_err bitwise, its fog sums
    bitwise equal to the client-order fold, ``ref.dense_fold_ref``);
    returns the max |kernel - plain| per kernel."""
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
                check(torch.equal(thr_k, thr_r) and torch.equal(ne_k, ne_r),
                      f"fused_agg thresholds or new_err differ bitwise at d={d}, N={n}")
                check(torch.equal(fs_k, kref.dense_fold_ref(deltas, err, fog_id, weights,
                                                             TRAIN_FOG, k, quantize)),
                      f"fused_agg fog sums differ from the client-order fold at d={d}, N={n}")
                check(not bool(fs_k[1].any()), "the empty fog got a nonzero sum")
                e = max(close_on_device(ne_k, ne_r, 0.0, 1e-5, "fused_agg new_err"),
                        close_on_device(fs_k, fs_r, 1e-5, 1e-4, "fused_agg fog sums"))
                max_err["fused_agg"] = max(max_err["fused_agg"], e)
                print(f"  fused_agg       d={d:5d} N={n:4d} int8={quantize!s:5s} survivors, "
                      f"thresholds, new_err and the client-order fold equal, "
                      f"max|diff|={e:.3e}  ok")
            del deltas, err, absv
    return max_err


def time_training_kernels(dev, lt, fa, kops, kref, ae, multi_epoch_indices, name, smi) -> dict:
    """Phase 6 for the training kernels at the train-200 shapes (the
    compress-aggregate keep count is the round's: rho_s 0.05 of d), and
    ``fused_agg`` at its other main-path calls: robust-200's identity
    segments (N = n_fog = 200: ``aggregation.client_compress``), one of its
    chunks at ``client_chunk=64`` (N = n_fog = 64) and fleet-10k's
    unchunked round (N = 10,000 into 1,000 fogs); ``fused_agg`` also by
    its two launches (select, sum)."""
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
    ids = torch.arange(TRAIN_N, dtype=torch.int32, device=dev)
    ones = torch.ones((TRAIN_N,), device=dev)
    c = ROBUST_CHUNK
    fd = torch.randn((FLEET_N, d), generator=g).to(dev)
    fe = (0.1 * torch.randn((FLEET_N, d), generator=g)).to(dev)
    ffog = torch.randint(0, FLEET_FOG, (FLEET_N,), generator=g, dtype=torch.int32).to(dev)
    fw = (WINDOW * (torch.rand((FLEET_N,), generator=g) > 0.3).to(torch.float32)).to(dev)
    cases.update({
        "fused_agg @ robust-200 identity": (
            lambda: fa.compress_aggregate_blocks(deltas, err, ids, ones, TRAIN_N, k),
            lambda: kref.compress_aggregate_ref(deltas, err, ids, ones, TRAIN_N, k),
            agg_work(TRAIN_N, d, TRAIN_N),
            (200, 20, 50, 5),
            f"N=n_fog={TRAIN_N} d={d} k={k} int8, identity segments",
        ),
        "fused_agg @ robust-200 chunk": (
            lambda: fa.compress_aggregate_blocks(deltas[:c], err[:c], ids[:c], ones[:c], c, k),
            lambda: kref.compress_aggregate_ref(deltas[:c], err[:c], ids[:c], ones[:c], c, k),
            agg_work(c, d, c),
            (200, 20, 50, 5),
            f"N=n_fog={c} d={d} k={k} int8, identity segments (client_chunk={c})",
        ),
        "fused_agg @ fleet-10k": (
            lambda: fa.compress_aggregate_blocks(fd, fe, ffog, fw, FLEET_FOG, k),
            lambda: kref.compress_aggregate_ref(fd, fe, ffog, fw, FLEET_FOG, k),
            agg_work(FLEET_N, d, FLEET_FOG),
            (50, 3, 20, 2),
            f"N={FLEET_N} d={d} n_fog={FLEET_FOG} k={k} int8, unchunked",
        ),
    })
    return time_cases(cases, name, smi, splits={"fused_agg": FUSED_SPLIT})


IDENTITY_N, IDENTITY_D = 66_000, 64     # identity segments past the grid's 65,535 rows


def time_identity_fogs(dev, fa, name, smi) -> dict:
    """Phase 6: ``fused_agg`` with 66,000 identity segments (n_fog = N =
    66,000, d = 64, k = 3: the card test's case past the grid's rows), where
    finding each fog's members reads N^2 fog ids; device time by launch and
    per call, beside the bound (no plain time: its one-hot product would be
    66,000^2 floats)."""
    g = torch.Generator().manual_seed(66)
    deltas = torch.randn((IDENTITY_N, IDENTITY_D), generator=g).to(dev)
    err = (0.1 * torch.randn((IDENTITY_N, IDENTITY_D), generator=g)).to(dev)
    ids = torch.arange(IDENTITY_N, dtype=torch.int32, device=dev)
    weights = torch.ones((IDENTITY_N,), device=dev)

    def run():
        fa.compress_aggregate_blocks(deltas, err, ids, weights, IDENTITY_N, 3)

    per_call = call_ms(run, 3)
    by_name = device_split(run, 3, *FUSED_SPLIT)
    ms = sum(v for k, v in by_name.items() if not k.endswith(" ops"))
    bound_ms, bound_by = bound_from(*agg_work(IDENTITY_N, IDENTITY_D, IDENTITY_N))
    print(f"  fused_agg @ 66,000 identity fogs (N=n_fog={IDENTITY_N} d={IDENTITY_D} k=3): device "
          f"time {ms * 1e3:.3f} us (select {by_name['select'] * 1e3:.3f}, sum "
          f"{by_name['sum'] * 1e3:.3f}); bound {bound_ms * 1e3:.4f} us ({bound_by}); per call "
          f"by CUDA events {per_call * 1e3:.3f} us  on {name} ({smi})")
    return dict(ms=ms, call_ms=per_call, bound_ms=bound_ms, bound_by=bound_by, split=by_name)


def time_cases(cases, name, smi, splits=None) -> dict:
    """Time each kernel beside its plain version: CUDA-event per-call time
    and torch.profiler device time, with the bound from its work; a kernel
    named in ``splits`` (name -> :func:`device_split`'s parts and rest)
    also by its kernels' names."""
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
        split = (splits or {}).get(kname.split(" @ ")[0])
        if split:
            out[kname]["split"] = by_name = device_split(run_kernel, prof_k, *split)
            print(f"  {kname:16s} by device kernel: " + ", ".join(
                f"{k} {v * 1e3:.3f} us ({by_name[k + ' ops']:.0f} ops)"
                for k, v in by_name.items() if not k.endswith(" ops")) + f"  on {name} ({smi})")
    return out


def time_new_kernels(dev, fa, ra, kops, kref, agg, comp, ae, name, smi) -> dict:
    """Phase 6 for the robust and wire kernels: ``robust_agg`` at
    robust-200's reduce (N = 200 compressed reconstructions of d = 1,352,
    20 fogs, integer weights with 30% erased, trim 0.45), the wire pair at
    one fleet-10k chunk (512 clients, k = 68, int8, into 1,000 fogs).
    ``wire_agg`` also as one call of all 10,000 clients (the member scan
    reads 10,000 ids per (fog, block)), and at a chunk whose deepest fog
    has as many members as that call's: the two share their longest chain
    of member adds, so their difference is the longer scan's.  ``robust_agg``
    also by its two launches (the member list, the reduce)."""
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
    big = fa.compress_wire_blocks(torch.randn((FLEET_N, d), generator=g).to(dev),
                                  (0.1 * torch.randn((FLEET_N, d), generator=g)).to(dev), k)[:3]
    big_fog = torch.randint(0, FLEET_FOG, (FLEET_N,), generator=g, dtype=torch.int32).to(dev)
    big_w = torch.full((FLEET_N,), float(WINDOW), device=dev)
    depth = int(torch.bincount(big_fog.long(), minlength=FLEET_FOG).max())
    deep_fog = torch.randint(1, FLEET_FOG, (FLEET_CHUNK,), generator=g, dtype=torch.int32)
    deep_fog[torch.randperm(FLEET_CHUNK, generator=g)[:depth]] = 0
    deep_fog = deep_fog.to(dev)
    deep = tuple(t[:FLEET_CHUNK] for t in big)
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
            wire_agg_work(wire[0], cfog, d, True),
            (200, 20, 50, 5),
            f"N={FLEET_CHUNK} d={d} k={k} int8 into n_fog={FLEET_FOG}",
        ),
        "wire_agg @ 10k call": (
            lambda: fa.wire_aggregate_blocks(*big, big_fog, big_w, FLEET_FOG, d, out=fog_sum),
            lambda: kref.wire_aggregate_ref(*big, big_fog, big_w, FLEET_FOG, d),
            wire_agg_work(big[0], big_fog, d, True),
            (200, 10, 50, 3),
            f"N={FLEET_N} d={d} k={k} int8 into n_fog={FLEET_FOG} in one call, deepest fog "
            f"{depth} members",
        ),
        "wire_agg @ chunk, 10k depth": (
            lambda: fa.wire_aggregate_blocks(*deep, deep_fog, cw, FLEET_FOG, d, out=fog_sum),
            lambda: kref.wire_aggregate_ref(*deep, deep_fog, cw, FLEET_FOG, d),
            wire_agg_work(deep[0], deep_fog, d, True),
            (200, 20, 50, 5),
            f"N={FLEET_CHUNK} d={d} k={k} int8 into n_fog={FLEET_FOG}, fog 0 holding {depth}",
        ),
    }
    return time_cases(cases, name, smi, splits={"robust_agg": ROBUST_SPLIT})


def time_compress_kernels(dev, kq8, tk, kops, kref, comp, ae, name, smi) -> dict:
    """Phase 6 for the per-client compressor kernels: ``compress_q8`` and
    ``topk_ef`` at train-200's shape (N = 200 updates of d = 1,352, rho_s
    0.05: k = 68: 200 two-warp teams), ``compress_q8`` again at fleet-10k's
    chunk (N = 512, the same rows ``wire_emit`` selects) and at
    legacy-200's quantise-only trial (rho_s 1: k = 1,352), both at N = 200,
    d = 8,209 (rho_s 0.05: k = 393; a block team and a 17-wide small team
    per row), ``quant8`` on one 2^20-coordinate vector, on train-200's
    updates (N = 200, d = 1,352: the codec's shape) and at N = 200, d =
    8,209."""
    g = torch.Generator(device=dev).manual_seed(12)
    d = ae.param_count(D, HIDDEN)
    deltas = torch.randn((TRAIN_N, d), generator=g, device=dev)
    err = 0.1 * torch.randn((TRAIN_N, d), generator=g, device=dev)
    x = torch.randn((1, QUANT8_D), generator=g, device=dev)
    k = kops.block_k(comp.blockwise_k_frac(d, 0.05))
    k_all = kops.block_k(comp.blockwise_k_frac(d, 1.0))
    cd = torch.randn((FLEET_CHUNK, d), generator=g, device=dev)
    ce = 0.1 * torch.randn((FLEET_CHUNK, d), generator=g, device=dev)
    k_chunk = kops.wire_k(comp.blockwise_k_frac(d, 0.05))
    wd = torch.randn((TRAIN_N, COMP_WIDE_D), generator=g, device=dev)
    we = 0.1 * torch.randn((TRAIN_N, COMP_WIDE_D), generator=g, device=dev)
    k_wide = kops.block_k(comp.blockwise_k_frac(COMP_WIDE_D, 0.05))
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
            f"N={FLEET_CHUNK} d={d} k={k_chunk} int8, the rows wire_emit selects",
        ),
        "compress_q8 @ k=1,352": (
            lambda: kq8.compress_blocks(deltas, err, k_all),
            lambda: kref.compress_ref(deltas, err, k_all),
            compress_work(TRAIN_N, d, True),
            (200, 20, 50, 5),
            f"N={TRAIN_N} d={d} k={k_all} int8, legacy-200's rho_s=1 trial",
        ),
        "compress_q8 @ d=8,209": (
            lambda: kq8.compress_blocks(wd, we, k_wide),
            lambda: kref.compress_ref(wd, we, k_wide),
            compress_work(TRAIN_N, COMP_WIDE_D, True),
            (200, 10, 50, 3),
            f"N={TRAIN_N} d={COMP_WIDE_D} k={k_wide} int8, a block team and a small team a row",
        ),
        "topk_ef @ d=8,209": (
            lambda: tk.topk_ef_blocks(wd, we, k_wide),
            lambda: kref.blockwise_topk_ef_ref(wd, we, k_wide),
            compress_work(TRAIN_N, COMP_WIDE_D, False),
            (200, 10, 50, 3),
            f"N={TRAIN_N} d={COMP_WIDE_D} k={k_wide}, a block team and a small team a row",
        ),
        "quant8": (
            lambda: kq8.quant8_blocks(x),
            lambda: kref.quant8_ref(x),
            quant8_work(1, QUANT8_D),
            (200, 20, 50, 5),
            f"N=1 d={QUANT8_D}",
        ),
        "quant8 @ N=200 d=1,352": (
            lambda: kq8.quant8_blocks(deltas),
            lambda: kref.quant8_ref(deltas),
            quant8_work(TRAIN_N, d),
            (200, 20, 50, 5),
            f"N={TRAIN_N} d={d}, the codec's shape",
        ),
        "quant8 @ N=200 d=8,209": (
            lambda: kq8.quant8_blocks(wd),
            lambda: kref.quant8_ref(wd),
            quant8_work(TRAIN_N, COMP_WIDE_D),
            (200, 20, 50, 5),
            f"N={TRAIN_N} d={COMP_WIDE_D}, a full block and a 17-wide one a row",
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
        fs._args.clear()
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


def check_member_lists(ra, fog_id, weights, n_fog, what) -> None:
    """``robust_agg``'s member lists built on the card equal the plain
    ``member_lists`` element for element (members and offsets)."""
    got, want = ra.member_lists_blocks(fog_id, weights, n_fog), ra.member_lists(fog_id, weights,
                                                                               n_fog)
    check(all(torch.equal(a, b) for a, b in zip(got, want)),
          f"robust_agg's member lists on the card differ from the plain version's at {what}")


def check_new_kernels(dev, fa, ra, kref, agg, comp) -> dict:
    """Phase 7 for the robust and wire kernels against their plain
    versions; returns the max |kernel - plain| per kernel.

    ``robust_agg``: N 1 / 13 / 200 / 2,000, d 1,352 / 8,209, one fog / 20
    fogs / one fog holding half the fleet, trimmed 0 / 0.2 / 0.45 and the
    median, on real compressed reconstructions with integer weights:
    rtol=1e-5, atol=1e-6; its member lists on the card equal the plain
    ``member_lists`` element for element on each layout, and with ids
    outside [0, n_fog).  The wire pair: phase 7's d x N grid, int8 on and
    off, k 68 / 410, written at a row offset of larger buffers (rows
    outside untouched): slots, codes, scales and new_err exactly;
    ``wire_agg`` into running sums bitwise equal to the client-order fold
    (``ref.wire_fold_ref``) and to rtol=1e-5 / atol=1e-4 of the plain
    version, the empty fog's row untouched."""
    max_err = dict.fromkeys(NEW_KERNELS, 0.0)
    g = torch.Generator().manual_seed(17)
    for d in ROBUST_DS:
        for n in ROBUST_NS:
            deltas = torch.randn((n, d), generator=g).to(dev)
            err = (0.1 * torch.randn((n, d), generator=g)).to(dev)
            recon, _ = agg.client_compress(deltas, err, comp.CompressorConfig())
            weights = (WINDOW * (torch.rand((n,), generator=g) > 0.3).to(torch.float32)).to(dev)
            for lname, fog_id in robust_layouts(n, g, dev).items():
                check_member_lists(ra, fog_id, weights, TRAIN_FOG, f"N={n} {lname}")
                outside = fog_id.clone()
                outside[::7], outside[3::11] = -2, TRAIN_FOG + 3
                check_member_lists(ra, outside, weights, TRAIN_FOG, f"N={n} {lname}, ids outside")
                e = 0.0
                for mode, beta in ROBUST_MODES:
                    out = ra.robust_aggregate_blocks(recon, fog_id, weights, TRAIN_FOG, beta, mode)
                    want, _ = kref.robust_aggregate_ref(recon, fog_id, weights, TRAIN_FOG, beta,
                                                        mode)
                    e = max(e, close_on_device(out, want, 1e-5, 1e-6,
                                               f"robust_agg {mode} {beta} N={n} d={d} {lname}"))
                max_err["robust_agg"] = max(max_err["robust_agg"], e)
                print(f"  robust_agg      d={d:5d} N={n:4d} {lname:15s} member lists equal; "
                      f"trimmed 0/0.2/0.45 + median max|diff|={e:.3e}  ok")
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
                    check(torch.equal(got, kref.wire_fold_ref(*view[:3], fog_id, weights,
                                                              base.clone())),
                          f"wire_agg differs from the client-order fold at d={d}, N={n}, k={k}, "
                          f"int8={quantize}")
                    e2 = close_on_device(got, want, 1e-5, 1e-4, "wire_agg fog sums")
                    max_err["wire_emit"] = max(max_err["wire_emit"], e1)
                    max_err["wire_agg"] = max(max_err["wire_agg"], e2)
                    print(f"  wire_emit/agg   d={d:5d} N={n:4d} k={k:3d} int8={quantize!s:5s} "
                          f"slots, new_err and the client-order fold equal, max|fog diff|="
                          f"{e2:.3e}  ok")
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
    sums bitwise equal to the client-order fold and to rtol=1e-5 /
    atol=1e-4 of the plain version); ``wire_agg`` again as one call of all
    10,000 clients, bitwise equal to the fold.  ``robust_agg`` at N =
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
    check(torch.equal(fs_k, kref.dense_fold_ref(deltas, err, fog_id, weights, FLEET_FOG, k)),
          f"fused_agg fog sums differ from the client-order fold at N={FLEET_N}")
    max_err["fused_agg"] = max(close_on_device(ne_k, ne_r, 0.0, 1e-5, "fused_agg new_err"),
                               close_on_device(fs_k, fs_r, 1e-5, 1e-4, "fused_agg fog sums"))
    print(f"  fused_agg       d={d:5d} N={FLEET_N} n_fog={FLEET_FOG} k={k} int8 survivors and the "
          f"client-order fold equal, max|diff|={max_err['fused_agg']:.3e}  ok")
    del absv, thr_k, thr_r

    nb = -(-d // 8192)
    wire = (torch.empty((FLEET_CHUNK, nb, k), dtype=torch.int32, device=dev),
            torch.empty((FLEET_CHUNK, nb, k), dtype=torch.int8, device=dev),
            torch.empty((FLEET_CHUNK, nb), device=dev))
    new_err = torch.empty((FLEET_N, d), device=dev)
    run_k = torch.zeros((FLEET_FOG, d), device=dev)
    run_r = torch.zeros((FLEET_FOG, d), device=dev)
    run_f = torch.zeros((FLEET_FOG, d), device=dev)
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
        kref.wire_fold_ref(*view[:3], fog_id[s:e], weights[s:e], run_f)
        check(torch.equal(run_k, run_f),
              f"wire_agg running sums differ from the client-order fold in the chunk at {s}")
        e2 = close_on_device(run_k, run_r, 1e-5, 1e-4, "wire_agg running fog sums")
        max_err["wire_emit"] = max(max_err["wire_emit"], e1)
        max_err["wire_agg"] = max(max_err["wire_agg"], e2)
    print(f"  wire_emit/agg   d={d:5d} N={FLEET_N} in chunks of {FLEET_CHUNK} into "
          f"n_fog={FLEET_FOG}, k={k} int8: slots, new_err and the client-order fold equal, "
          f"max|running fog diff|={max_err['wire_agg']:.3e}  ok")
    idx, q, scale, _ = fa.compress_wire_blocks(deltas, err, k)
    base = torch.randn((FLEET_FOG, d), generator=g).to(dev)
    got = fa.wire_aggregate_blocks(idx, q, scale, fog_id, weights, FLEET_FOG, d, out=base.clone())
    check(torch.equal(got, kref.wire_fold_ref(idx, q, scale, fog_id, weights, base.clone())),
          f"wire_agg differs from the client-order fold at one call of N={FLEET_N}")
    max_err["wire_agg"] = max(max_err["wire_agg"], close_on_device(
        got, base + kref.wire_aggregate_ref(idx, q, scale, fog_id, weights, FLEET_FOG, d),
        1e-5, 1e-4, "wire_agg at one 10k call"))
    print(f"  wire_agg        d={d:5d} N={FLEET_N} in one call into n_fog={FLEET_FOG}: the "
          f"client-order fold equal  ok")
    del idx, q, scale, got, base
    del deltas, err, new_err, wire, fs_k, ne_k, fs_r, ne_r

    n = BIG_ROBUST_N
    deltas = torch.randn((n, d), generator=g).to(dev)
    err = (0.1 * torch.randn((n, d), generator=g)).to(dev)
    recon, _ = agg.client_compress(deltas, err, comp.CompressorConfig())
    fog_id = torch.randint(1, FLEET_FOG, (n,), generator=g, dtype=torch.int32)
    fog_id[:BIG_ROBUST_FOG0] = 0
    fog_id = fog_id.to(dev)
    weights = (WINDOW * (torch.rand((n,), generator=g) > 0.3).to(torch.float32)).to(dev)
    check_member_lists(ra, fog_id, weights, FLEET_FOG, f"N={n}, fog 0 holding {BIG_ROBUST_FOG0}")
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


# --- phase 17: flat-200, the paper's flat baselines ------------------------

CENTRAL_ROUNDS, CENTRAL_EPOCHS = 1, 1   # centralised cut: T * E = 1 epoch of 1,600 steps


def kernel_counters(lt, fa, ra, kq8, tk) -> dict:
    """Every kernel of a training path: name -> (its LAUNCHES dict, reset)."""
    return {"local_train_f32": (lt.LAUNCHES, lt.reset_launches),
            "fused_agg": (fa.LAUNCHES, fa.reset_launches),
            "wire_emit": (fa.LAUNCHES, fa.reset_launches),
            "wire_agg": (fa.LAUNCHES, fa.reset_launches),
            "robust_agg": (ra.LAUNCHES, ra.reset_launches),
            "compress_q8": (kq8.LAUNCHES, kq8.reset_launches),
            "topk_ef": (tk.LAUNCHES, tk.reset_launches)}


def flat_fleet(exp, flat_fl, ae, FaultConfig, ds, counters, training, dev, name, smi) -> dict:
    """Phase 17: flat-200, the flat baselines at train-200's settings on
    phase 8's draws, each trial on the card with every kernel's launches
    counted (zeroed just before it, read just after) and held to a CPU
    twin on identical draws (participation and erasures exactly,
    energies to rtol=1e-5, loss within 1%, F1 within 0.02): fedavg,
    fedprox, fedadam, scaffold, fedavg under robust-200's attack (trimmed
    0.45) and the centralised oracle cut to T = 1, E = 1; then ms per
    round and the idle share of fedavg's ``train_flat``."""
    base = exp.make_config(TRAIN_N, TRAIN_FOG, ROUNDS)
    robust = base.replace(faults=FaultConfig(**ROBUST_FAULTS), robust="trimmed",
                          trim_frac=ROBUST_TRIM)
    central = base.replace(rounds=CENTRAL_ROUNDS, local_epochs=CENTRAL_EPOCHS)
    kernels = {"local_train_f32": ROUNDS, "fused_agg": 2 * ROUNDS}
    trials = {   # label -> (method, config, the launches it must make)
        "fedavg": ("fedavg", base, kernels),
        "fedprox": ("fedprox", base, kernels),
        "fedadam": ("fedadam", base, kernels),
        "scaffold": ("scaffold", base, {}),
        "fedavg robust": ("fedavg", robust, {**kernels, "robust_agg": ROUNDS}),
        "centralised": ("centralised", central, {}),
    }
    out = {}
    for label, (method, cfg, want) in trials.items():
        inputs = exp.draw_trial(torch.Generator().manual_seed(0), ds, cfg, method=method)
        for _, reset in counters.values():
            reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gpu = exp.trial_metrics(method, None, ds, cfg, inputs=inputs)
        torch.cuda.synchronize()
        trial_s = time.perf_counter() - t0
        launches = {k: launches_of[k] for k, (launches_of, _) in counters.items()}
        check(launches == {k: want.get(k, 0) for k in counters},
              f"flat-200 {label} launches {launches}, expected {want}")
        check(gpu["losses"].device.type == "cuda", f"flat-200 {label} did not run on the card")
        check(all(bool(torch.isfinite(v).all()) for v in gpu.values()),
              f"non-finite flat-200 {label} metrics")
        t1 = time.perf_counter()
        cpu = exp.trial_metrics(method, None, ds, cfg, inputs=inputs, device="cpu")
        cpu_s = time.perf_counter() - t1
        rounds = 1 if method == "centralised" else cfg.rounds
        loss_rel = agree_with_cpu(f"flat-200 {label}", gpu, cpu, rounds)
        check(float(gpu["erased_total"]) == float(cpu["erased_total"]),
              f"flat-200 {label}: erasures {float(gpu['erased_total'])} vs CPU "
              f"{float(cpu['erased_total'])}")
        out[label] = dict(
            method=method, launches=launches, trial_s=trial_s, cpu_trial_s=cpu_s,
            f1=float(gpu["f1"]), cpu_f1=float(cpu["f1"]),
            participation=float(gpu["participation"]), e_total=float(gpu["e_total"]),
            erased_total=float(gpu["erased_total"]), loss_first=float(gpu["losses"][0]),
            loss_last=float(gpu["losses"][-1]), loss_rel_vs_cpu=loss_rel,
            rounds=cfg.rounds, local_epochs=cfg.local_epochs)
        print(f"  {label:14s} T={cfg.rounds} E={cfg.local_epochs}: trial {trial_s:.3f} s (CPU "
              f"twin {cpu_s:.3f} s); F1 {out[label]['f1']:.4f} (CPU "
              f"{out[label]['cpu_f1']:.4f}), "
              f"participation {out[label]['participation']:.4f}, energy "
              f"{out[label]['e_total']:.4f} J, erasures {out[label]['erased_total']:.0f}, loss "
              f"{out[label]['loss_first']:.4f} -> {out[label]['loss_last']:.4f} (max rel vs CPU "
              f"{loss_rel:.2e}); launches {launches}  on {name} ({smi})")

    # ms per round and the idle share of fedavg's rounds on the card.
    inputs = exp.draw_trial(torch.Generator().manual_seed(0), ds, base)
    ds_dev = type(ds)(*(t.to(dev) for t in ds))
    dep, draws = inputs.dep.to(dev), inputs.draws.to(dev)
    params = [{k: v.to(dev) for k, v in layer.items()} for layer in inputs.params]

    def train_on_card():
        return flat_fl.train_flat(params, ae.loss, ds_dev, base, dep, draws)

    round_ms = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_on_card()
        torch.cuda.synchronize()
        round_ms.append((time.perf_counter() - t0) * 1e3 / ROUNDS)
    train_ms, train_ops = device_ms(train_on_card, 1)
    timing = dict(round_ms=round_ms, device_ms_per_round=train_ms / ROUNDS,
                  device_ops_per_round=train_ops / ROUNDS,
                  idle_share=max(0.0, 1.0 - train_ms / ROUNDS / min(round_ms)))
    print(f"  fedavg train_flat {', '.join(f'{v:.3f}' for v in round_ms)} ms per round, device "
          f"{timing['device_ms_per_round']:.3f} ms in {timing['device_ops_per_round']:.0f} ops "
          f"per round, idle share {timing['idle_share']:.3f}  on {name} ({smi})")
    print(f"    mean participation: fedavg {out['fedavg']['participation']:.4f} (direct links "
          f"to the gateway) vs phase 8's hfl-selective {training['participation']:.4f}; F1 "
          f"fedavg {out['fedavg']['f1']:.4f} vs hfl-selective {training['f1']:.4f}; "
          f"centralised cut to T={CENTRAL_ROUNDS}, E={CENTRAL_EPOCHS}")
    return dict(trials=out, fedavg_timing=timing,
                hfl_selective_participation=training["participation"],
                cut=dict(centralised_rounds=CENTRAL_ROUNDS,
                         centralised_local_epochs=CENTRAL_EPOCHS))


# --- phase 18: engine-200, the batched trial Engine ------------------------

ENGINE_SEEDS, ENGINE_P = (0, 1, 2, 3), 2    # engine-200: 8 trials of train-200 in one call
ENGINE_FAMILY_SEEDS = (0, 1)                # fedavg and robust-200's attack: 2 x 2 trials
ENGINE_AUDIT_SEEDS = tuple(range(8))
ENGINE_AUDIT_METHODS = ("hfl-nocoop", "hfl-selective", "hfl-nearest", "hfl-adam", "fedavg")
ENGINE_TIME_B = (1, 4, 16)                  # trials per batched round loop (P = 1)


def engine_cell(Engine, exp, ds, cfg, method, seeds, counters, label, dev, name, smi,
                store=None) -> dict:
    """One ``Engine.run`` cell on the card (``ENGINE_P`` deployments a
    seed), every training kernel's launches zeroed just before it and read
    just after; each trial (s, 0) held against a sequential card trial
    from ``torch.Generator().manual_seed(s)``, whose launches the cell's
    must equal: participating sensor-rounds, coop links, erasures and
    non-finite deltas exactly, energies to rtol=1e-5, losses to rtol=1e-4,
    F1 within 1e-3; and which metrics came out bitwise equal."""
    eng = Engine()
    for _, reset in counters.values():
        reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run = eng.run(method, cfg, seeds, ds, n_deployments=ENGINE_P, store=store)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = {k: launches_of[k] for k, (launches_of, _) in counters.items()}
    check(eng.take_log()[0]["launches"] == {k: v for k, v in launches.items() if v},
          f"{label}: the Engine's log disagrees with the launch counters")
    check(all(bool(torch.isfinite(v).all()) for v in run.metrics.values()),
          f"{label}: non-finite metrics")
    check(run.f1.device == dev, f"{label} did not run on the card")
    rcfg = eng.resolve_config(cfg)
    bitwise, worst = {}, {"e_total": 0.0, "losses": 0.0, "f1": 0.0}
    n_sensors = cfg.deployment.n_sensors
    for s, seed in enumerate(seeds):
        for _, reset in counters.values():
            reset()
        seq = exp.trial_metrics(method, torch.Generator().manual_seed(seed), ds, rcfg)
        torch.cuda.synchronize()
        one = {k: launches_of[k] for k, (launches_of, _) in counters.items()}
        check(one == launches, f"{label}: the cell launched {launches}, one trial {one}")
        got = {k: v[s, 0] for k, v in run.metrics.items()}
        for key, per in (("participation", n_sensors * cfg.rounds), ("coop_links", cfg.rounds),
                         ("erased_total", 1), ("nonfinite_total", 1)):
            check(round(float(got[key]) * per) == round(float(seq[key]) * per),
                  f"{label} trial ({seed}, 0): {key} {float(got[key])} vs sequential "
                  f"{float(seq[key])}")
        for key in ("e_total", "e_s2f", "e_f2f", "e_f2g"):
            check(np.isclose(float(got[key]), float(seq[key]), rtol=1e-5, atol=0.0),
                  f"{label} trial ({seed}, 0): {key} {float(got[key])} vs {float(seq[key])}")
        worst["e_total"] = max(worst["e_total"], abs(float(got["e_total"] - seq["e_total"]))
                               / abs(float(seq["e_total"])))
        lg, ls = got["losses"].cpu().numpy(), seq["losses"].cpu().numpy()
        loss_rel = float(np.max(np.abs(lg - ls) / np.abs(ls)))
        check(loss_rel <= 1e-4, f"{label} trial ({seed}, 0): losses differ by {loss_rel:.3e}")
        worst["losses"] = max(worst["losses"], loss_rel)
        f1_diff = abs(float(got["f1"]) - float(seq["f1"]))
        check(f1_diff <= 1e-3, f"{label} trial ({seed}, 0): F1 {float(got['f1']):.5f} vs "
                               f"{float(seq['f1']):.5f}")
        worst["f1"] = max(worst["f1"], f1_diff)
        for key, v in seq.items():
            bitwise[key] = bitwise.get(key, True) and torch.equal(got[key], v)
    same = sorted(k for k, v in bitwise.items() if v)
    apart = sorted(k for k, v in bitwise.items() if not v)
    print(f"  {label}: {method} {len(seeds)} seeds x {ENGINE_P} deployments = "
          f"{len(seeds) * ENGINE_P} trials in one call, {wall:.3f} s, peak memory "
          f"{peak / 2**20:.1f} MiB; launches {launches} (one sequential trial's too)  on "
          f"{name} ({smi})")
    print(f"    trials (s, 0) vs sequential card trials: max rel e_total {worst['e_total']:.2e}, "
          f"max rel loss {worst['losses']:.2e}, max |dF1| {worst['f1']:.2e}; bitwise: "
          f"{', '.join(same) or 'none'}; within tolerance only: {', '.join(apart) or 'none'}")
    print(f"    mean over the {len(seeds) * ENGINE_P} trials: F1 "
          f"{run.seed_mean_std('f1')[0]:.4f} +- {run.seed_mean_std('f1')[1]:.4f}, "
          f"participation {run.seed_mean_std('participation')[0]:.4f}, energy "
          f"{run.seed_mean_std('e_total')[0]:.4f} J")
    return dict(method=method, seeds=list(seeds), deployments=ENGINE_P, wall_s=wall,
                peak_bytes=peak, launches=launches, bitwise=same, within_tolerance=apart,
                worst=worst, f1_mean_std=run.seed_mean_std("f1"),
                participation_mean=run.seed_mean_std("participation")[0],
                e_total_mean=run.seed_mean_std("e_total")[0])


def time_engine_rounds(exp, hfl, ae, ds_dev, cfg, name, smi) -> dict:
    """ms per trial-round and the device idle share of the batched round
    loop (``hfl.run_rounds`` on ``hfl.start_trials``' state and draws, on the
    card) at B = 1, 4 and 16 trials (seeds 0..B-1, P = 1): the best of two
    timed loops, device time and ops by torch.profiler, peak memory."""
    inputs = [exp.draw_trial(torch.Generator().manual_seed(s), ds_dev, cfg)
              for s in range(max(ENGINE_TIME_B))]
    out = {}
    for b in ENGINE_TIME_B:
        ds_b = hfl.stack_datasets([ds_dev] * b)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        state, draws = hfl.start_trials([i.params for i in inputs[:b]], ds_b, cfg,
                                        [i.dep for i in inputs[:b]],
                                        [i.draws for i in inputs[:b]])
        round_fn = hfl.make_round_fn(ae.loss, ds_b, cfg)

        def loop():
            return hfl.run_rounds(round_fn, state, draws, cfg.rounds)

        walls = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loop()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated()
        dev_ms, ops = device_ms(loop, 1)
        best = min(walls)
        out[b] = dict(round_ms=best / cfg.rounds, trial_round_ms=best / cfg.rounds / b,
                      loop_ms=walls, device_ms_per_round=dev_ms / cfg.rounds,
                      device_ops_per_round=ops / cfg.rounds,
                      idle_share=max(0.0, 1.0 - dev_ms / best), peak_bytes=peak)
        print(f"  B={b:2d} trials: {out[b]['round_ms']:.3f} ms per round, "
              f"{out[b]['trial_round_ms']:.3f} ms per trial-round; device "
              f"{out[b]['device_ms_per_round']:.3f} ms in {out[b]['device_ops_per_round']:.0f} "
              f"ops per round, idle share {out[b]['idle_share']:.3f}; peak memory "
              f"{peak / 2**20:.1f} MiB  on {name} ({smi})")
    return out


def engine_kernels(dev, lt, fa, ra, kops, kref, agg, comp, ae, multi_epoch_indices, name,
                   smi) -> dict:
    """``local_train_f32``, ``fused_agg`` and ``robust_agg`` at the engine's
    B = 16 shapes: 3,200 clients of 16 trials (one start vector each),
    their fog ids offset into 320 fogs.  Each is held against its plain
    version first, at phase 7's tolerances: ``local_train_f32`` with and
    without FedProx (deltas rtol=1e-4 / atol=1e-6, loss rtol=1e-5);
    ``fused_agg``'s thresholds and new_err bitwise, its fog sums bitwise
    equal to the client-order fold (``ref.dense_fold_ref``), within
    rtol=1e-5 / atol=1e-4 of the plain version, and each trial's 20 fogs
    bitwise equal to a launch on that trial's 200 clients alone;
    ``robust_agg`` on the folded fogs in every mode (rtol=1e-5, atol=1e-6),
    its member lists equal to the plain ones.  Then each is timed beside
    its plain version (``fused_agg`` and ``robust_agg`` also by launch);
    every entry carries its ``max_abs_err``."""
    from repro_torch.core.compression import blockwise_k_frac

    b = max(ENGINE_TIME_B)
    n = b * TRAIN_N
    g = torch.Generator().manual_seed(18)
    dims = (D, *HIDDEN, D)
    trials = [ae.init(g, D, HIDDEN, device="cpu") for _ in range(b)]
    params = [{k: torch.stack([t[i][k] for t in trials]).to(dev) for k in ("w", "b")}
              for i in range(len(dims) - 1)]
    ws, bs = tuple(p["w"] for p in params), tuple(p["b"] for p in params)
    theta = ae.ravel(params)
    x = torch.randn((n, WINDOW, D), generator=g).to(dev)
    idx = multi_epoch_indices(g, n, WINDOW, BATCH, EPOCHS).to(dev)
    steps = int(idx.shape[1])
    max_err = {}
    for mu in (0.0, 0.01):
        deltas, loss = lt.train_clients(x, idx, theta, dims, LR, mu)
        d_ref, l_ref = kref.local_train_ref(x, idx, ws, bs, LR, mu)
        e = close_on_device(deltas, d_ref, 1e-4, 1e-6, f"local_train deltas, theta ({b}, d)")
        close_on_device(loss, l_ref, 1e-5, 0.0, f"local_train loss, theta ({b}, d)")
        max_err["local_train_f32"] = max(max_err.get("local_train_f32", 0.0), e)
        print(f"  local_train_f32 N={n} theta ({b}, {int(theta.shape[1])}) mu={mu:4.2f} "
              f"max|delta diff|={e:.3e}  ok")
    deltas, _ = lt.train_clients(x, idx, theta, dims, LR, 0.0)
    d = int(deltas.shape[1])
    err = (0.1 * torch.randn((n, d), generator=g)).to(dev)
    offset = torch.arange(b, dtype=torch.int32).repeat_interleave(TRAIN_N) * TRAIN_FOG
    fog_id = (torch.randint(0, TRAIN_FOG, (n,), generator=g, dtype=torch.int32)
              + offset).to(dev)
    weights = torch.full((n,), float(WINDOW))
    weights[::17] = 0.0                              # non-participants
    weights = weights.to(dev)
    n_fog = b * TRAIN_FOG
    k = kops.block_k(blockwise_k_frac(d, 0.05))

    fs_k, ne_k, thr_k = fa.compress_aggregate_blocks(deltas, err, fog_id, weights, n_fog, k)
    fs_r, ne_r, thr_r = kref.compress_aggregate_ref(deltas, err, fog_id, weights, n_fog, k)
    check(torch.equal(thr_k, thr_r) and torch.equal(ne_k, ne_r),
          f"fused_agg thresholds or new_err differ bitwise at {n} clients, {n_fog} fogs")
    check(torch.equal(fs_k, kref.dense_fold_ref(deltas, err, fog_id, weights, n_fog, k, True)),
          f"fused_agg fog sums differ from the client-order fold at {n} clients, {n_fog} fogs")
    max_err["fused_agg"] = max(close_on_device(ne_k, ne_r, 0.0, 1e-5, "fused_agg new_err"),
                               close_on_device(fs_k, fs_r, 1e-5, 1e-4, "fused_agg fog sums"))
    for t in range(b):
        rows, fogs = slice(t * TRAIN_N, (t + 1) * TRAIN_N), slice(t * TRAIN_FOG,
                                                                  (t + 1) * TRAIN_FOG)
        fs_t, _, _ = fa.compress_aggregate_blocks(deltas[rows], err[rows],
                                                  fog_id[rows] - t * TRAIN_FOG, weights[rows],
                                                  TRAIN_FOG, k)
        check(torch.equal(fs_t, fs_k[fogs]),
              f"fused_agg: trial {t}'s folded fog sums differ from its own launch")
    print(f"  fused_agg       N={n} n_fog={n_fog} ({b} trials x {TRAIN_FOG}) thresholds, new_err "
          f"and the client-order fold equal, each trial's fogs bitwise its own launch, "
          f"max|diff|={max_err['fused_agg']:.3e}  ok")

    recon, _ = agg.client_compress(deltas, err, comp.CompressorConfig())
    check_member_lists(ra, fog_id, weights, n_fog, f"{n} clients in {n_fog} folded fogs")
    max_err["robust_agg"] = 0.0
    for mode, beta in ROBUST_MODES:
        out = ra.robust_aggregate_blocks(recon, fog_id, weights, n_fog, beta, mode)
        want, _ = kref.robust_aggregate_ref(recon, fog_id, weights, n_fog, beta, mode)
        max_err["robust_agg"] = max(max_err["robust_agg"], close_on_device(
            out, want, 1e-5, 1e-6, f"robust_agg {mode} {beta} on {n_fog} folded fogs"))
    print(f"  robust_agg      N={n} n_fog={n_fog} member lists equal; trimmed 0/0.2/0.45 + median "
          f"max|diff|={max_err['robust_agg']:.3e}  ok")

    lt_bytes, lt_ops = train_work(dims, n, WINDOW, steps, BATCH, False)
    cases = {
        f"local_train_f32 @ engine B={b}": (
            lambda: lt.train_clients(x, idx, theta, dims, LR, 0.0),
            lambda: kref.local_train_ref(x, idx, ws, bs, LR, 0.0),
            (lt_bytes + 4 * (b - 1) * d, lt_ops),      # B start vectors read once
            (10, 2, 5, 1),
            f"N={n} ({b} trials x {TRAIN_N}) window={WINDOW} {steps} steps x {BATCH} rows, "
            f"theta ({b}, {d})",
        ),
        f"fused_agg @ engine B={b}": (
            lambda: fa.compress_aggregate_blocks(deltas, err, fog_id, weights, n_fog, k),
            lambda: kref.compress_aggregate_ref(deltas, err, fog_id, weights, n_fog, k),
            agg_work(n, d, n_fog),
            (50, 3, 20, 2),
            f"N={n} d={d} n_fog={n_fog} ({b} trials x {TRAIN_FOG}) k={k} int8",
        ),
        f"robust_agg @ engine B={b}": (
            lambda: ra.robust_aggregate_blocks(recon, fog_id, weights, n_fog, ROBUST_TRIM,
                                               "trimmed"),
            lambda: kref.robust_aggregate_ref(recon, fog_id, weights, n_fog, ROBUST_TRIM,
                                              "trimmed"),
            robust_work(fog_id, weights, n_fog, d),
            (50, 2, 20, 1),
            f"N={n} d={d} n_fog={n_fog} ({b} trials x {TRAIN_FOG}) trimmed {ROBUST_TRIM}, "
            f"compressed recon",
        ),
    }
    out = time_cases(cases, name, smi, splits={"fused_agg": FUSED_SPLIT,
                                               "robust_agg": ROBUST_SPLIT})
    for key, entry in out.items():
        entry["max_abs_err"] = max_err[key.split(" @ ")[0]]
    return out


def engine_fleet(mods, train_ds, counters, training, dev, name, smi, workdir) -> dict:
    """Phase 18: engine-200.  ``Engine.run`` cells on the card (train-200's
    hfl-selective over 4 seeds x 2 deployments; fedavg and robust-200's
    attack under the trimmed mean over 2 x 2), each trial (s, 0) against a
    sequential card trial, launches equal to one trial's; ``Engine.audit``
    for the hfl methods and fedavg and ``Engine.reachability`` at N = 200,
    M = 20 over seeds 0-7 against their sequential twins;
    ``Engine.score`` of the cell's trial (0, 0) params over serve-200's
    test rows against ``serving.score``; then ms per trial-round and the
    idle share at B = 1, 4 and 16, and the three kernels of the folded
    round at B = 16, each against its plain version (:func:`engine_kernels`)."""
    (Engine, exp, hfl, ae, part, topo, anomaly, score_mod, CheckpointStore, FaultConfig,
     SyntheticConfig, generate, normalize, lt, fa, ra, fs, kops, kref, agg, comp,
     multi_epoch_indices) = mods
    cfg = exp.make_config(TRAIN_N, TRAIN_FOG, ROUNDS)
    robust = cfg.replace(faults=FaultConfig(**ROBUST_FAULTS), robust="trimmed",
                         trim_frac=ROBUST_TRIM)
    store = CheckpointStore(str(workdir / "engine"), keep=2)
    cells = {"engine-200": engine_cell(Engine, exp, train_ds, cfg, "hfl-selective",
                                       ENGINE_SEEDS, counters, "engine-200", dev, name, smi,
                                       store=store)}
    want = {"local_train_f32": ROUNDS, "fused_agg": 2 * ROUNDS}
    got = {k: cells["engine-200"]["launches"][k] for k in want}
    check(got == want == training["launches"],
          f"engine-200 launched {got}; one train-200 trial {training['launches']}")
    cells["fedavg"] = engine_cell(Engine, exp, train_ds, cfg, "fedavg", ENGINE_FAMILY_SEEDS,
                                  counters, "engine fedavg", dev, name, smi)
    cells["robust trimmed"] = engine_cell(Engine, exp, train_ds, robust, "hfl-selective",
                                          ENGINE_FAMILY_SEEDS, counters, "engine robust", dev,
                                          name, smi)
    check(cells["robust trimmed"]["launches"]["robust_agg"] == ROUNDS,
          "robust_agg did not run once a round on the folded fogs")

    eng = Engine()
    audits = {}
    for method in ENGINE_AUDIT_METHODS:
        out = eng.audit(method, cfg, ENGINE_AUDIT_SEEDS)
        for s, seed in enumerate(ENGINE_AUDIT_SEEDS):
            want_a = exp.audit_method(method, cfg, seed=seed)
            for key in ("e_s2f", "e_f2f", "e_f2g", "e_total", "participation", "coop_links"):
                check(np.isclose(float(out[key][s, 0]), want_a[key], rtol=1e-5, atol=1e-9),
                      f"audit {method} seed {seed}: {key} {float(out[key][s, 0])} vs "
                      f"{want_a[key]}")
        audits[method] = {k: float(v.mean()) for k, v in out.items()}
        print(f"  audit {method:13s} {len(ENGINE_AUDIT_SEEDS)} seeds in one call: mean energy "
              f"{audits[method]['e_total']:.4f} J, participation "
              f"{audits[method]['participation']:.4f}, coop links "
              f"{audits[method]['coop_links']:.2f}/round (each seed = audit_method)")
    reach = eng.reachability(cfg, ENGINE_AUDIT_SEEDS)
    for s, seed in enumerate(ENGINE_AUDIT_SEEDS):
        dep = topo.sample_deployment(torch.Generator().manual_seed(seed), cfg.deployment)
        r = part.reachability(dep, cfg.channel)
        check(float(reach["direct_gateway"][s, 0]) == float(r.direct_gateway),
              f"reachability seed {seed}: {float(reach['direct_gateway'][s, 0])} vs "
              f"{float(r.direct_gateway)}")
    reach_mean = {k: float(v.mean()) for k, v in reach.items()}
    print(f"  reachability N={TRAIN_N} M={TRAIN_FOG}, {len(ENGINE_AUDIT_SEEDS)} deployments: "
          f"direct gateway {reach_mean['direct_gateway']:.4f} (the paper's ~48%), fog-assisted "
          f"{reach_mean['fog_assisted']:.4f}, fog to gateway {reach_mean['fog_to_gateway']:.4f}")

    # Engine.score on the cell's published trial (0, 0) over serve-200's rows.
    params, step = store.latest(ae.init(torch.Generator().manual_seed(0), D, HIDDEN,
                                        device=dev))
    check(step == ROUNDS, f"the engine published step {step}, not {ROUNDS}")
    serve = normalize(generate(torch.Generator().manual_seed(0), SyntheticConfig(
        n_sensors=N_SENSORS, val_len=VAL_LEN, test_len=TEST_LEN), device=dev))
    tau = anomaly.calibrate_threshold(
        anomaly.reconstruction_errors(ae.apply, params, serve.val.reshape(-1, D)), 99.0)
    fs.reset_launches()
    got_s = eng.score(params, serve.test, tau)
    torch.cuda.synchronize()
    score_launches = fs.LAUNCHES["fused_score_f32"]
    want_s = score_mod.score(params, serve.test, tau)
    check(score_launches == 1, f"Engine.score launched fused_score_f32 {score_launches} times")
    check(torch.equal(got_s.error, want_s.error) and torch.equal(got_s.flag, want_s.flag),
          "Engine.score differs from serving.score")
    f1 = float(anomaly.pointwise_f1(got_s.flag.cpu(), serve.test_label.cpu()).f1)
    print(f"  Engine.score of trial (0, 0) over serve-200's {serve.test.shape[0]} x "
          f"{serve.test.shape[1]} test rows: 1 fused_score_f32 launch, bitwise serving.score; "
          f"F1 {f1:.4f}")

    ds_dev = type(train_ds)(*(t.to(dev) for t in train_ds))
    timing = time_engine_rounds(exp, hfl, ae, ds_dev, cfg, name, smi)
    for b in ENGINE_TIME_B:
        print(f"    B={b}: {timing[b]['trial_round_ms']:.3f} ms per trial-round against phase "
              f"8's {min(training['round_ms']):.3f} ms per round of one trial")
    kernels = engine_kernels(dev, lt, fa, ra, kops, kref, agg, comp, ae, multi_epoch_indices,
                             name, smi)
    return dict(cells=cells, audit=audits, reachability=reach_mean,
                score=dict(launches=score_launches, f1=f1), timing=timing, kernels=kernels)


# --- phase 19: async-200, the event-driven async family --------------------

ASYNC_CELLS = ((0.0, 0.5), (0.5, 0.25), (1.0, 0.25))   # async_bench's (alpha, buffer fraction)
ASYNC_EVENTS, ASYNC_FOG_K, ASYNC_SEEDS = 60, 2.0, (0, 1, 2)
ASYNC_CPU_EVENTS = 60       # the card-vs-CPU trial: the whole cell
ASYNC_TIME_EVENTS = 20      # events per timed loop at B = 1 and B = 3
ASYNC_PATH = ("local_train_f32", "fused_agg", "robust_agg")


def async_cell(async_fl, base, alpha, frac, n_events=None):
    """One of ``async_bench``'s staleness cells at ``base``'s fleet
    (``ASYNC_EVENTS`` events unless ``n_events``)."""
    n = base.deployment.n_sensors
    return async_fl.AsyncFLConfig(base=base, n_events=n_events or ASYNC_EVENTS,
                                  buffer_k=max(2.0, frac * n),
                                  fog_k=ASYNC_FOG_K, alpha=alpha)


def mmpp_delays(mmpp_trace, n, n_fog):
    """``async_bench``'s replay: each sensor's launch-to-arrival delay is
    its mean inter-event gap in an MMPP trace (seed 1047, 0.5 N events/s
    on, 10 / 20 s sojourns, 120 s)."""
    trace = mmpp_trace(1047, rate_on_hz=0.5 * n, mean_on_s=10.0, mean_off_s=20.0,
                       duration_s=120.0, fleet=n, n_fog=n_fog)
    counts = torch.zeros(n).index_add_(0, torch.as_tensor(trace.sensor, dtype=torch.long),
                                       torch.ones(trace.n_events))
    return trace, torch.tensor(trace.duration_s, dtype=torch.float32) / torch.clamp_min(counts, 1.0)


ASYNC_FLOATS = ("e_total", "e_s2f", "e_f2f", "e_f2g", "sim_time_s", "staleness")


def async_vs_sequential(exp, eng, ds, cfg, got, per_cell, counters, label) -> dict:
    """Each trial (s, 0) of an async Engine cell (``got``: (S, P) leaves)
    against a sequential card trial of the resolved ``cfg`` from
    ``torch.Generator().manual_seed(s)``, whose launches must equal the
    cell's (``per_cell``): merges, participating sensor-events, coop
    links, erasures and non-finite counts exactly; energies, the clock
    and staleness to rtol=1e-5; losses within 1% and F1 within 0.02, the
    family's card tolerances: the fog buffers' ``index_add_`` adds in no
    fixed order on the card, so even one trial run twice drifts apart
    (seed 0's trial is, and that drift is reported as ``repeat_losses``).
    Returns the largest relative difference of each."""
    rcfg = eng.resolve_config(cfg)
    n, t = rcfg.base.deployment.n_sensors, rcfg.n_events
    worst = {k: 0.0 for k in (*ASYNC_FLOATS, "losses", "f1", "repeat_losses")}

    def trial(seed):
        return exp.trial_metrics("hfl-async", torch.Generator().manual_seed(seed), ds, rcfg)

    def loss_rel(a, b):
        a, b = a["losses"].cpu().numpy(), b["losses"].cpu().numpy()
        return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))

    for s, seed in enumerate(ASYNC_SEEDS):
        for _, reset in counters.values():
            reset()
        seq = trial(seed)
        torch.cuda.synchronize()
        one = {k: counters[k][0][k] for k in ASYNC_PATH if counters[k][0][k]}
        check(one == per_cell, f"{label}: a cell launched {per_cell}, one trial {one}")
        if s == 0:
            worst["repeat_losses"] = loss_rel(trial(seed), seq)
        mine = {k: v[s, 0] for k, v in got.items()}
        for key, per in (("merges", 1), ("participation", n * t), ("coop_links", t),
                         ("erased_total", 1), ("nonfinite_total", 1), ("nonfinite_rounds", 1)):
            check(round(float(mine[key]) * per) == round(float(seq[key]) * per),
                  f"{label} trial ({seed}, 0): {key} {float(mine[key])} vs sequential "
                  f"{float(seq[key])}")
        for key in ASYNC_FLOATS:
            a, b = float(mine[key]), float(seq[key])
            check(np.isclose(a, b, rtol=1e-5, atol=0.0),
                  f"{label} trial ({seed}, 0): {key} {a} vs sequential {b}")
            worst[key] = max(worst[key], abs(a - b) / max(abs(b), 1e-30))
        rel = loss_rel(mine, seq)
        check(rel <= 0.01, f"{label} trial ({seed}, 0): losses differ by {rel:.3e}")
        worst["losses"] = max(worst["losses"], rel)
        f1_diff = abs(float(mine["f1"]) - float(seq["f1"]))
        check(f1_diff <= 0.02, f"{label} trial ({seed}, 0): F1 {float(mine['f1']):.5f} vs "
                               f"{float(seq['f1']):.5f}")
        worst["f1"] = max(worst["f1"], f1_diff)
    return worst


def async_engine_cell(eng, exp, ds, run, label, counters, cfgs, robust=False) -> tuple:
    """One Engine call on the card over ``cfgs``' cells and
    ``ASYNC_SEEDS``, every count zeroed just before it and read just
    after, checked against one trial's per event: each event one
    ``local_train_f32`` and one ``fused_agg`` call (two launches) for all
    its folded trials, the cells' too (a sweep's class is one call), plus
    one ``robust_agg`` with the trimmed reduce.  Then
    each cell's trials (s, 0) against sequential card trials
    (:func:`async_vs_sequential`).  Returns (the result, its launches, the
    worst relative differences over its cells, the call's seconds)."""
    for _, reset in counters.values():
        reset()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: launches_of[k] for k, (launches_of, _) in counters.items()}
    check(eng.take_log()[-1]["launches"] == {k: v for k, v in launches.items() if v},
          f"{label}: the Engine's log disagrees with the launch counters")
    n_events = cfgs[0].n_events
    per_cell = {k: v for k, v in (("local_train_f32", n_events), ("fused_agg", 2 * n_events),
                                  ("robust_agg", n_events if robust else 0)) if v}
    got = {k: launches[k] for k in ASYNC_PATH if launches[k]}
    check(got == per_cell, f"{label}: launched {got}, one cell launches {per_cell}")
    cells = [out.cell(i) for i in range(len(cfgs))] if hasattr(out, "cell") else [out.metrics]
    worst: dict[str, float] = {}
    for i, (cfg, metrics) in enumerate(zip(cfgs, cells)):
        for k, v in async_vs_sequential(exp, eng, ds, cfg, metrics, per_cell, counters,
                                        f"{label} cell {i}").items():
            worst[k] = max(worst.get(k, 0.0), v)
    print(f"    {label}: every trial (s, 0) of {len(cfgs)} cell(s) vs its sequential card trial: "
          f"counts equal, launches per cell {per_cell} as one trial's; max rel "
          + ", ".join(f"{k} {v:.2e}" for k, v in worst.items() if k not in ("f1", "repeat_losses"))
          + f", max |dF1| {worst['f1']:.2e}; seed 0's sequential trial twice: max rel loss "
          f"{worst['repeat_losses']:.2e}")
    return out, got, worst, wall


class KernelCalls:
    """Inside ``with``, every call of ``local_train_f32``'s,
    ``fused_agg``'s and ``robust_agg``'s wrappers is made as usual (its
    launches counted as usual) and its arguments and outputs are kept:
    the first call of the first two, every call of ``robust_agg``."""

    def __init__(self, lt, fa, ra):
        self.sites = ((lt, "train_clients", False), (fa, "compress_aggregate_blocks", False),
                      (ra, "robust_aggregate_blocks", True))
        self.calls = {name: [] for _, name, _ in self.sites}

    def __enter__(self):
        self.saved = [getattr(mod, name) for mod, name, _ in self.sites]
        for (mod, name, every), launch in zip(self.sites, self.saved):
            def recording(*args, _launch=launch, _calls=self.calls[name], _every=every):
                out = _launch(*args)
                if _every or not _calls:
                    _calls.append((out, args))
                return out
            setattr(mod, name, recording)
        return self

    def __exit__(self, *exc):
        for (mod, name, _), launch in zip(self.sites, self.saved):
            setattr(mod, name, launch)


def check_recorded_kernels(calls, kref, ra, ae, dev, label) -> dict:
    """The kernels on the inputs that an Engine call gave them
    (:class:`KernelCalls`), each output held against its plain version on
    the same inputs: ``local_train_f32``'s first call (deltas rtol=1e-4 /
    atol=1e-6, loss rtol=1e-5); ``fused_agg``'s first call (thresholds
    and new_err bitwise, fog sums bitwise the client-order fold and within
    rtol=1e-5 / atol=1e-4); and every ``robust_agg`` call (for the async
    family the merge input: the per-client means, the folded ``cli_fog``
    of the latest arrivals, ``cli_w`` with the zero weights of clients
    that did not arrive) at rtol=1e-5 / atol=1e-6, member lists equal.
    Returns the max |diff| per kernel recorded and what the inputs held."""
    (deltas, loss), (x, idx, theta, dims, lr, mu) = calls["train_clients"][0]
    layers = ae.unravel(theta, ae.init(torch.Generator().manual_seed(0), D, HIDDEN, device=dev))
    d_ref, l_ref = kref.local_train_ref(x, idx, tuple(p["w"] for p in layers),
                                        tuple(p["b"] for p in layers), lr, mu)
    err = {"local_train_f32": close_on_device(
        deltas, d_ref, 1e-4, 1e-6, f"{label} local_train, theta {tuple(theta.shape)}")}
    close_on_device(loss, l_ref, 1e-5, 0.0, f"{label} local_train loss")
    (fs_k, ne_k, thr_k), args = calls["compress_aggregate_blocks"][0]
    fs_r, ne_r, thr_r = kref.compress_aggregate_ref(*args)
    n_rows, n_seg = int(args[0].shape[0]), int(args[4])
    check(torch.equal(thr_k, thr_r) and torch.equal(ne_k, ne_r),
          f"{label} fused_agg thresholds or new_err differ bitwise on {n_seg} segments")
    check(torch.equal(fs_k, kref.dense_fold_ref(*args)),
          f"{label} fused_agg fog sums differ from the client-order fold")
    err["fused_agg"] = max(
        close_on_device(ne_k, ne_r, 0.0, 1e-5, f"{label} fused_agg new_err"),
        close_on_device(fs_k, fs_r, 1e-5, 1e-4, f"{label} fused_agg fog sums"))
    members, zeros, n_fog = 0, 0, 0
    for i, (out, (recon, fog_id, weights, n_fog, beta, mode)) in enumerate(
            calls["robust_aggregate_blocks"]):
        want, _ = kref.robust_aggregate_ref(recon, fog_id, weights, n_fog, beta, mode)
        err["robust_agg"] = max(err.get("robust_agg", 0.0), close_on_device(
            out, want, 1e-5, 1e-6, f"{label} robust_agg {mode} {beta} call {i}, {n_fog} fogs"))
        check_member_lists(ra, fog_id, weights, n_fog, f"{label} robust_agg input of call {i}")
        held = int((weights > 0).sum())
        if held > members:
            members, zeros = held, int((weights == 0).sum())
    n_robust = len(calls["robust_aggregate_blocks"])
    print(f"  {label}'s own kernel inputs vs the plain versions: local_train_f32 "
          f"N={int(x.shape[0])} theta {tuple(theta.shape)} max|delta diff|="
          f"{err['local_train_f32']:.3e}; fused_agg N={n_rows} into {n_seg} segments, "
          f"thresholds, new_err and the fold equal, max|diff|={err['fused_agg']:.3e}"
          + (f"; robust_agg on {n_robust} calls' inputs into {n_fog} folded fogs (fullest "
             f"{members} rows of weight > 0, {zeros} of weight 0), member lists equal, "
             f"max|diff|={err['robust_agg']:.3e}" if n_robust else "") + "  ok")
    return dict(max_abs_err=err, robust_calls=n_robust, fullest_members=members,
                fullest_zero_weight=zeros)


def async_row(run, i, sync_s_per_round) -> dict:
    """A staleness cell's trial means: sim s per merge, speedup over the
    sync limit's sim s per round, F1, staleness."""
    m = run.cell(i) if i is not None else run.metrics
    sim, merges = float(m["sim_time_s"].mean()), float(m["merges"].mean())
    s_per_merge = sim / max(merges, 1.0)
    return dict(sim_time_s=sim, merges=merges, sim_s_per_merge=s_per_merge,
                speedup_vs_sync=sync_s_per_round / max(s_per_merge, 1e-9),
                f1_mean=float(m["f1"].mean()), f1_std=float(m["f1"].std(correction=0)),
                staleness_mean=float(m["staleness"].mean()),
                participation=float(m["participation"].mean()),
                e_total=float(m["e_total"].mean()))


def async_card_vs_cpu(async_fl, exp, ae, ds, ds_dev, base) -> dict:
    """Cell (0.5, 0.25) (``ASYNC_CPU_EVENTS`` events) on the card and on
    the CPU from identical draws: every event's merge, launches, arrivals,
    erasures and links exactly, energies and the clock to rtol=1e-5,
    losses within 1%; the trial must merge."""
    cfg = async_cell(async_fl, base, *ASYNC_CELLS[1], n_events=ASYNC_CPU_EVENTS)
    inputs = exp.draw_trial(torch.Generator().manual_seed(0), ds, cfg, method="hfl-async")
    _, m_g = async_fl.train(inputs.params, ae.loss, ds_dev, cfg, inputs.dep, inputs.draws)
    t0 = time.perf_counter()
    _, m_c = async_fl.train(inputs.params, ae.loss, ds, cfg, inputs.dep, inputs.draws)
    cpu_s = time.perf_counter() - t0
    check(bool(m_c.merged.any()), "async card vs CPU: the compared trial never merged")
    for field in ("merged", "n_launched", "n_arrived", "n_erased", "coop_links", "n_nonfinite"):
        check(torch.equal(getattr(m_g, field).cpu(), getattr(m_c, field)),
              f"async card vs CPU: {field} differs per event")
    worst = {}
    for field in ("e_s2f", "e_f2f", "e_f2g", "e_total", "t_sim", "staleness"):
        got = getattr(m_g, field).cpu().to(torch.float64).numpy()
        want = getattr(m_c, field).to(torch.float64).numpy()
        check(np.allclose(got, want, rtol=1e-5, atol=0.0),
              f"async card vs CPU: {field} {got} vs {want}")
        worst[field] = float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-30)))
    lg, lc = m_g.loss.cpu().numpy(), m_c.loss.numpy()
    worst["loss"] = float(np.max(np.abs(lg - lc) / np.abs(lc)))
    check(worst["loss"] <= 0.01, f"async card vs CPU: loss differs by {worst['loss']:.3e}")
    return dict(events=ASYNC_CPU_EVENTS, merges=int(m_c.merged.sum()),
                arrivals=int(m_c.n_arrived.sum()), max_rel=worst, cpu_s=cpu_s)


def sync_chain(frames) -> str:
    """Where a host sync came from: the innermost Python frame (the call
    that synchronised) and the frames of the repository that led to it."""
    frames = [f for f in frames if not f.filename.endswith("warnings.py")]
    mine = [f for f in frames if "repro_torch" in f.filename or f.filename.endswith("chip_smoke.py")]
    return " <- ".join(f"{'/'.join(Path(f.filename).parts[-2:])}:{f.lineno}"
                       for f in [frames[-1]] + mine[::-1][:3])


def time_async_events(async_fl, exp, hfl, ae, ds_dev, base, name, smi) -> dict:
    """ms per event of cell (0.5, 0.25) at B = 1 and per trial-event at
    B = 3 (seeds 0..B-1; best of two ``ASYNC_TIME_EVENTS``-event loops of
    ``hfl.run_rounds`` over ``async_fl``'s event), device time and ops per
    event by torch.profiler, the idle share, and the host syncs per event:
    the warnings ``torch.cuda.set_sync_debug_mode("warn")`` raises over one
    loop, each by the call that synchronised and the repository's frames
    that led to it.  The loop must make none: an event reads nothing back.
    Those raised while the mode turns on (the process's first switch to
    "warn" raises one, before the loop) are reported apart."""
    import traceback
    import warnings

    cfg = async_cell(async_fl, base, *ASYNC_CELLS[1], n_events=ASYNC_TIME_EVENTS)
    out = {}
    for b in (1, 3):
        inputs = [exp.draw_trial(torch.Generator().manual_seed(s), ds_dev, cfg,
                                 method="hfl-async") for s in range(b)]
        if b == 1:
            ds_b = ds_dev
            params, dep, draws = hfl.place(inputs[0].params, inputs[0].dep, inputs[0].draws,
                                           ds_dev.train.device)
        else:
            ds_b = hfl.stack_datasets([ds_dev] * b)
            params, dep, draws = hfl.place_trials([i.params for i in inputs],
                                                  [i.dep for i in inputs],
                                                  [i.draws for i in inputs], ds_dev.train.device)
        state = async_fl.init_state(params, dep, cfg)
        event_fn = async_fl.make_event_fn(ae.loss, ds_b, cfg)

        def loop():
            return hfl.run_rounds(event_fn, state, draws, cfg.n_events)

        walls = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loop()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        dev_ms, ops = device_ms(loop, 1)
        sites: dict[str, int] = {}
        switch: dict[str, int] = {}     # raised while the mode turns on, before the loop

        def seen(message, category, filename, lineno, file=None, line=None):
            if "synchroniz" in str(message):
                site = sync_chain(traceback.extract_stack()[:-1])
                into = sites if looping else switch
                into[site] = into.get(site, 0) + 1

        looping = False
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = seen
            torch.cuda.set_sync_debug_mode("warn")
            try:
                looping = True
                loop()
                looping = False
            finally:
                torch.cuda.set_sync_debug_mode("default")
        syncs = sum(sites.values())
        check(syncs == 0, f"the async event loop at B={b} synchronised with the card {syncs} "
                          f"times: {sites}")
        best = min(walls)
        out[b] = dict(event_ms=best / cfg.n_events, trial_event_ms=best / cfg.n_events / b,
                      loop_ms=walls, device_ms_per_event=dev_ms / cfg.n_events,
                      device_ops_per_event=ops / cfg.n_events,
                      idle_share=max(0.0, 1.0 - dev_ms / best),
                      host_syncs_per_event=syncs / cfg.n_events, host_sync_sites=sites,
                      syncs_turning_the_mode_on=switch)
        print(f"  B={b}: {out[b]['event_ms']:.3f} ms per event, {out[b]['trial_event_ms']:.3f} ms "
              f"per trial-event; device {out[b]['device_ms_per_event']:.3f} ms in "
              f"{out[b]['device_ops_per_event']:.0f} ops per event, idle share "
              f"{out[b]['idle_share']:.3f}; host syncs per event "
              f"{out[b]['host_syncs_per_event']:.2f}"
              + (f" (turning the mode on: {', '.join(f'{k} x{v}' for k, v in switch.items())})"
                 if switch else "")
              + f"  on {name} ({smi})")
    return out


def async_fleet(mods, train_ds, counters, training, dev, name, smi) -> dict:
    """Phase 19: async-200.  The sync limit (20 events) against phase 8's
    hfl-selective trial on the same draws; ``async_bench``'s three
    staleness cells (60 events, fog_k 2) through one ``Engine.sweep`` over
    seeds 0-2, its sync baseline and its MMPP replay cell; robust-200's
    attack under trimmed 0.45 on cell (0.5, 0.25), with the kernels'
    inputs of that call held against their plain versions
    (:func:`check_recorded_kernels`); every Engine trial (s, 0) against its
    sequential card trial; cell (0.5, 0.25)'s trial on the card against
    its CPU twin; ms per event, device ops, idle share and host syncs per
    event (:func:`time_async_events`)."""
    Engine, exp, async_fl, hfl, ae, FaultConfig, mmpp_trace, lt, fa, ra, kref = mods
    cfg = exp.make_config(TRAIN_N, TRAIN_FOG, ROUNDS)
    sync = async_fl.sync_limit(cfg)
    inputs = exp.draw_trial(torch.Generator().manual_seed(0), train_ds, cfg)   # phase 8's draws
    for _, reset in counters.values():
        reset()
    got = exp.trial_metrics("hfl-async", None, train_ds, sync, inputs=inputs)
    torch.cuda.synchronize()
    launches = {k: counters[k][0][k] for k in ASYNC_PATH}
    check(launches == {**training["launches"], "robust_agg": 0},
          f"sync limit launched {launches}; phase 8's trial {training['launches']}")
    loss_g = got["losses"].cpu().numpy()
    loss_rel = float(np.max(np.abs(loss_g - np.array(training["losses"]))
                            / np.abs(np.array(training["losses"]))))
    check(loss_rel <= 0.01, f"sync limit: losses differ from phase 8's by {loss_rel:.3e}")
    per = TRAIN_N * ROUNDS
    check(round(float(got["participation"]) * per) == round(training["participation"] * per),
          f"sync limit: participation {float(got['participation'])} vs "
          f"{training['participation']}")
    check(np.isclose(float(got["e_total"]), training["e_total"], rtol=1e-5, atol=0.0),
          f"sync limit: energy {float(got['e_total'])} vs {training['e_total']}")
    f1_diff = abs(float(got["f1"]) - training["f1"])
    check(f1_diff <= 0.02, f"sync limit: F1 {float(got['f1']):.4f} vs {training['f1']:.4f}")
    check(float(got["merges"]) == ROUNDS and float(got["staleness"]) == 0.0,
          f"sync limit: {float(got['merges'])} merges, staleness {float(got['staleness'])}")
    sync_trial = dict(launches=launches, loss_rel_vs_hfl=loss_rel, f1=float(got["f1"]),
                      f1_hfl=training["f1"], e_total=float(got["e_total"]),
                      sim_time_s=float(got["sim_time_s"]))
    print(f"  sync limit ({ROUNDS} events) vs phase 8's hfl-selective trial on its draws: max rel loss "
          f"{loss_rel:.2e}, participation equal, energy {sync_trial['e_total']:.4f} J, F1 "
          f"{sync_trial['f1']:.4f} vs {training['f1']:.4f}; {ROUNDS} merges, staleness 0; launches "
          f"{launches}")

    eng = Engine()
    cells = [async_cell(async_fl, cfg, a, f) for a, f in ASYNC_CELLS]
    sync_run, sync_l, sync_w, sync_wall = async_engine_cell(
        eng, exp, train_ds, lambda: eng.run("hfl-async", sync, ASYNC_SEEDS, train_ds),
        "async sync baseline", counters, [sync])
    sync_s = float(sync_run["sim_time_s"].mean()) / max(float(sync_run["merges"].mean()), 1.0)
    sw, sweep_l, sweep_w, sweep_wall = async_engine_cell(
        eng, exp, train_ds, lambda: eng.sweep("hfl-async", cells, ASYNC_SEEDS, train_ds),
        "async sweep", counters, cells)
    check(sw.n_classes == 1, f"the staleness sweep split into {sw.n_classes} classes")
    rows = {f"alpha {a} buffer {f}": async_row(sw, i, sync_s)
            for i, (a, f) in enumerate(ASYNC_CELLS)}
    trace, delays = mmpp_delays(mmpp_trace, TRAIN_N, TRAIN_FOG)
    replay_cfg = cells[1].replace(arrival_delay_s=delays)
    mm, mm_l, mm_w, mm_wall = async_engine_cell(
        eng, exp, train_ds, lambda: eng.run("hfl-async", replay_cfg, ASYNC_SEEDS, train_ds),
        "async mmpp replay", counters, [replay_cfg])
    rows["mmpp replay, alpha 0.5 buffer 0.25"] = async_row(mm, None, sync_s)
    robust_cfg = cells[1].replace(base=cfg.replace(faults=FaultConfig(**ROBUST_FAULTS),
                                                   robust="trimmed", trim_frac=ROBUST_TRIM))
    recorded = KernelCalls(lt, fa, ra)

    def run_robust():
        with recorded:
            return eng.run("hfl-async", robust_cfg, ASYNC_SEEDS, train_ds)

    rb, robust_l, robust_w, robust_wall = async_engine_cell(
        eng, exp, train_ds, run_robust, "async robust", counters, [robust_cfg], robust=True)
    rows["robust trimmed 0.45, alpha 0.5 buffer 0.25"] = async_row(rb, None, sync_s)
    check(float(rb["erased_total"].sum()) > 0, "the robust cell erased nothing")
    for run in (sync_run, sw, mm, rb):
        check(all(bool(torch.isfinite(v).all()) for v in run.metrics.values()),
              "non-finite async metrics")
        check(run["f1"].device == dev, "an async cell did not run on the card")
    kernel_checks = check_recorded_kernels(recorded.calls, kref, ra, ae, dev,
                                           "the async robust cell")
    cells_s = sync_wall + sweep_wall + mm_wall + robust_wall
    print(f"  sync baseline (sync_limit, {ROUNDS} events, seeds {ASYNC_SEEDS}): {sync_s:.3f} sim s per "
          f"round, F1 {float(sync_run['f1'].mean()):.4f}; launches {sync_l}")
    print(f"  staleness sweep: 1 class, {len(cells)} cells x {len(ASYNC_SEEDS)} trials x "
          f"{ASYNC_EVENTS} events (fog_k {ASYNC_FOG_K:g}), launches {sweep_l}; replay launches "
          f"{mm_l} (trace {trace.n_events} events, {trace.mean_rate_hz():.1f} /s); robust "
          f"launches {robust_l}; the four Engine calls {cells_s:.1f} s  on {name} ({smi})")
    for label, r in rows.items():
        print(f"    {label:42s} {r['sim_s_per_merge']:.3f} sim s per merge (speedup vs sync "
              f"{r['speedup_vs_sync']:.2f}), {r['merges']:.1f} merges, F1 {r['f1_mean']:.4f} +- "
              f"{r['f1_std']:.4f}, staleness {r['staleness_mean']:.3f}, participation "
              f"{r['participation']:.4f}, energy {r['e_total']:.3f} J")

    ds_dev = type(train_ds)(*(t.to(dev) for t in train_ds))
    versus = async_card_vs_cpu(async_fl, exp, ae, train_ds, ds_dev, cfg)
    print(f"  cell (0.5, 0.25), {versus['events']} events, card vs CPU ({versus['cpu_s']:.1f} s "
          f"on the CPU): merges, launches, arrivals, erasures, links equal per event "
          f"({versus['merges']} merges, {versus['arrivals']} arrivals); max rel "
          + ", ".join(f"{k} {v:.2e}" for k, v in versus["max_rel"].items()))
    timing = time_async_events(async_fl, exp, hfl, ae, ds_dev, cfg, name, smi)
    return dict(sync_limit=sync_trial, sync_s_per_round=sync_s, rows=rows,
                launches={"sync baseline": sync_l, "sweep (3 cells)": sweep_l, "mmpp replay": mm_l,
                          "robust": robust_l},
                vs_sequential={"sync baseline": sync_w, "sweep (3 cells)": sweep_w,
                               "mmpp replay": mm_w, "robust": robust_w},
                kernel_checks=kernel_checks, card_vs_cpu=versus, timing=timing, cells_s=cells_s,
                trace=dict(n_events=trace.n_events, mean_rate_hz=trace.mean_rate_hz()))


# --- phase 20: mesh-200, the client-sharded round loop ---------------------

MESH_WORLD = 2                 # (b)-(d): two gloo ranks sharing the one card
MESH_TIMEOUT_S = 240.0         # per spawn of ranks
MESH_ENGINE_SEEDS = (0, 1)     # (d): 2 seeds x ENGINE_P deployments
MESH_TIME_REPS = 3             # timed 20-round hfl.train runs per rank
# The reference's sharded-vs-unsharded test runs 2 rounds
# (tests/test_fused_agg.py:195-228); its tolerances (params atol 1e-5,
# losses rtol 1e-4) hold the mesh's rounds and its Engine cells there.
# Over train-200's 20 rounds the reassociated fog sums flip a block's
# survivor set once in a while (phase 8's draws on the CPU: params within
# 3.6e-7 through round 12, 2.3e-3 from round 13 on), so at 20 rounds the
# losses take the port's summation-order gate (1%, phases 8 and 17) and
# the params are reported, not gated.
MESH_SHORT_ROUNDS = 2


def mesh_rank(rank: int, world: int, backend: str, workdir: str) -> None:
    """One rank of phase 20, in a spawned process: meets the others in a
    ``file://`` rendezvous in ``workdir``, runs the jobs of
    ``workdir/jobs.pt`` on its card (``cuda:rank % count``) with the client
    mesh of the default group, and writes ``rank<r>.pt``."""
    from repro_torch.launch import sharding
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(rank % torch.cuda.device_count())
    dev = torch.device("cuda", torch.cuda.current_device())
    work = Path(workdir)
    spec = torch.load(work / "jobs.pt", weights_only=False)
    spec["seen"] = _mesh_clients()
    dist.init_process_group(backend, init_method=f"file://{work / 'rendezvous'}",
                            world_size=world, rank=rank)
    try:
        if "wait_for" in spec:   # started early: the context is made, the jobs wait
            torch.ones(1, device=dev).sum().item()
            while not Path(spec["wait_for"]).exists():
                time.sleep(0.2)
        mesh = sharding.client_mesh()
        out = {}
        for job in spec["jobs"]:
            out[job[0]] = MESH_JOBS[job[0].split(":")[0]](job, spec, mesh, dev)
        torch.save(out, work / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _mesh_clients():
    """Wrap the launch wrappers of the mesh's round so that each call
    records its client count (rows of its first argument); returns the
    record, kernel name -> list, and a function that clears it."""
    from repro_torch.kernels import fused_agg as fa
    from repro_torch.kernels import local_train as lt
    seen = {"local_train_f32": [], "fused_agg": [], "wire_emit": []}
    for mod, attr, kernel in ((lt, "train_clients", "local_train_f32"),
                              (fa, "compress_aggregate_blocks", "fused_agg"),
                              (fa, "compress_wire_blocks", "wire_emit")):
        def wrapped(x, *args, _launch=getattr(mod, attr), _seen=seen[kernel], **kw):
            _seen.append(int(x.shape[0]))
            return _launch(x, *args, **kw)
        setattr(mod, attr, wrapped)
    return seen


def _mesh_counts():
    from repro_torch.kernels import fused_agg as fa
    from repro_torch.kernels import local_train as lt
    return {**lt.LAUNCHES, **fa.LAUNCHES}


def _mesh_reset(seen):
    from repro_torch.kernels import fused_agg as fa
    from repro_torch.kernels import local_train as lt
    lt.reset_launches()
    fa.reset_launches()
    for v in seen.values():
        v.clear()
    torch.cuda.synchronize()


def mesh_train_job(job, spec, mesh, dev) -> dict:
    """``hfl.train`` of train-200 on phase 8's draws with the mesh (job
    ``train``, (a)), or ``hfl.train`` / ``flat_fl.train_flat`` cut to
    ``MESH_SHORT_ROUNDS`` (``short:hfl``, ``short:flat``, (b)): final
    params, metrics, launches and clients per launch."""
    from repro_torch.core import flat_fl, hfl
    from repro_torch.models import autoencoder as ae
    seen = spec["seen"]
    ds, cfg, inputs = spec["ds"], spec["cfg"], spec["inputs"]
    train = hfl.train
    if job[0].startswith("short:"):
        cfg = cfg.replace(rounds=MESH_SHORT_ROUNDS)
        train = flat_fl.train_flat if job[0] == "short:flat" else hfl.train
    ds_dev = type(ds)(*(t.to(dev) for t in ds))
    _mesh_reset(seen)
    params, m = train(inputs.params, ae.loss, ds_dev, cfg, inputs.dep, inputs.draws,
                      client_mesh=mesh)
    torch.cuda.synchronize()
    return dict(params=ae.ravel(params).cpu(), metrics={k: v.cpu() for k, v in
                                                        m._asdict().items()},
                launches=_mesh_counts(), clients={k: list(v) for k, v in seen.items()})


def mesh_trial_job(job, spec, mesh, dev) -> dict:
    """``experiment.trial_metrics`` of ``job``'s method at train-200 with
    the mesh (b): its metrics, final params, launches, clients per launch."""
    from repro_torch.launch import experiment as exp
    from repro_torch.models import autoencoder as ae
    method = job[0].split(":")[1]
    seen = spec["seen"]
    _mesh_reset(seen)
    out = exp.trial_metrics(method, None, spec["ds"], spec["cfg"], inputs=spec["inputs"],
                            client_mesh=mesh, return_params=True)
    torch.cuda.synchronize()
    params = out.pop("params")
    return dict(metrics={k: v.cpu() for k, v in out.items()}, params=ae.ravel(params).cpu(),
                launches=_mesh_counts(), clients={k: list(v) for k, v in seen.items()})


def mesh_time_job(job, spec, mesh, dev) -> dict:
    """ms per round of train-200's ``hfl.train`` with the mesh, then one
    more run with every ``all_reduce`` of the round timed between two
    synchronisations: the ms per round spent in them."""
    from repro_torch.core import hfl
    from repro_torch.launch import sharding
    from repro_torch.models import autoencoder as ae
    ds, cfg, inputs = spec["ds"], spec["cfg"], spec["inputs"]
    ds_dev = type(ds)(*(t.to(dev) for t in ds))
    dep, draws = inputs.dep.to(dev), inputs.draws.to(dev)
    params = [{k: v.to(dev) for k, v in layer.items()} for layer in inputs.params]

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hfl.train(params, ae.loss, ds_dev, cfg, dep, draws, client_mesh=mesh)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / cfg.rounds

    round_ms = [run() for _ in range(MESH_TIME_REPS)]
    plain_sum, spent = sharding.ClientMesh.sum_, []

    def timed_sum(self, t):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = plain_sum(self, t)
        torch.cuda.synchronize()
        spent.append(time.perf_counter() - t0)
        return out

    sharding.ClientMesh.sum_ = timed_sum
    try:
        instrumented = run()
    finally:
        sharding.ClientMesh.sum_ = plain_sum
    return dict(round_ms=round_ms, instrumented_round_ms=instrumented,
                all_reduce_ms_per_round=sum(spent) * 1e3 / cfg.rounds,
                all_reduces_per_round=len(spent) / cfg.rounds)


def mesh_fleet_job(job, spec, mesh, dev) -> dict:
    """(c) mesh-10k: phase 10's chunked fleet (N = 10,000, M = 1,000, T =
    5, client_chunk 512) with the mesh, its data made on the card and its
    draws from seed 0 on every rank; ms per round and this rank's peak
    device memory over the ``hfl.train`` run, measured as phase 10 does."""
    from repro_torch.core import hfl
    from repro_torch.data.synthetic import SyntheticConfig, generate, normalize
    from repro_torch.launch import experiment as exp
    from repro_torch.models import autoencoder as ae
    seen = spec["seen"]
    ds = normalize(generate(
        torch.Generator().manual_seed(0),
        SyntheticConfig(n_sensors=FLEET_N, train_len=WINDOW, val_len=VAL_LEN, test_len=TEST_LEN),
        device=dev,
    ))
    cfg = exp.make_config(FLEET_N, FLEET_FOG, FLEET_ROUNDS, client_chunk=FLEET_CHUNK)
    inputs = exp.draw_trial(torch.Generator().manual_seed(0), ds, cfg)
    dep, draws = inputs.dep.to(dev), inputs.draws.to(dev)
    params = [{k: v.to(dev) for k, v in layer.items()} for layer in inputs.params]
    _mesh_reset(seen)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    _, m = hfl.train(params, ae.loss, ds, cfg, dep, draws, client_mesh=mesh)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / FLEET_ROUNDS
    return dict(ms_per_round=ms, peak_bytes=torch.cuda.max_memory_allocated(dev),
                metrics={k: v.cpu() for k, v in m._asdict().items()}, launches=_mesh_counts(),
                clients={k: list(v) for k, v in seen.items()})


def mesh_engine_job(job, spec, mesh, dev) -> dict:
    """(d) ``Engine(shard_clients=True)`` or ``Engine(shard_trials=True)``
    over train-200's cell cut to ``MESH_SHORT_ROUNDS``, seeds 0-1 x
    ``ENGINE_P`` deployments."""
    from repro_torch.engine import Engine
    mode = job[0].split(":")[1]
    seen = spec["seen"]
    eng = Engine(shard_clients=mode == "clients", shard_trials=mode == "trials")
    _mesh_reset(seen)
    run = eng.run("hfl-selective", spec["cfg"].replace(rounds=MESH_SHORT_ROUNDS),
                  MESH_ENGINE_SEEDS, spec["ds"], n_deployments=ENGINE_P)
    torch.cuda.synchronize()
    return dict(metrics={k: v.cpu() for k, v in run.metrics.items()}, log=eng.take_log(),
                clients={k: list(v) for k, v in seen.items()})


MESH_JOBS = {"train": mesh_train_job, "short": mesh_train_job, "trial": mesh_trial_job,
             "time": mesh_time_job, "fleet": mesh_fleet_job, "engine": mesh_engine_job}


def start_mesh(jobs, world, backend, spec, workdir: Path):
    """Start ``world`` spawned ranks (``mesh_rank``) on ``jobs``; their
    process context, for :func:`join_mesh`."""
    import torch.multiprocessing as mp
    workdir.mkdir(parents=True)
    torch.save({**spec, "jobs": jobs}, workdir / "jobs.pt")
    return mp.start_processes(mesh_rank, args=(world, backend, str(workdir)), nprocs=world,
                              join=False, start_method="spawn")


def stop_mesh(ctx) -> None:
    for p in ctx.processes:
        if p.is_alive():
            p.terminate()
        p.join(10)


def join_mesh(ctx, workdir: Path, timeout_s: float = MESH_TIMEOUT_S) -> list[dict]:
    """Each rank's results of :func:`start_mesh`'s ranks.  A rank that
    raises, or ranks that outlive ``timeout_s``, fail the phase; every
    rank is stopped."""
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            check(time.monotonic() < deadline,
                  f"{len(ctx.processes)} ranks did not finish in {timeout_s} s")
    finally:
        stop_mesh(ctx)
    return [torch.load(workdir / f"rank{r}.pt", weights_only=False)
            for r in range(len(ctx.processes))]


def spawn_mesh(jobs, world, backend, spec, workdir: Path) -> list[dict]:
    """Run ``jobs`` on ``world`` spawned ranks (``mesh_rank``); each rank's
    results (:func:`join_mesh`)."""
    return join_mesh(start_mesh(jobs, world, backend, spec, workdir), workdir)


def mesh_kernels(dev, lt, fa, kops, kref, ae, ds, inputs) -> dict:
    """The two kernels of a mesh rank's round at its shapes (the first
    rank's 100 of train-200's clients, round 0's windows and index table;
    100 clients into 20 fogs), each against its plain version at phase 7's
    tolerances; max |diff| per kernel."""
    n = TRAIN_N // MESH_WORLD
    params = [{k: v.to(dev) for k, v in layer.items()} for layer in inputs.params]
    x, idx = ds.train[:n].to(dev), inputs.draws.batches[0][:n].to(dev)
    deltas, loss = lt.train_clients(x, idx, ae.ravel(params), (D, *HIDDEN, D), LR, 0.0)
    d_ref, l_ref = kref.local_train_ref(x, idx, tuple(p["w"] for p in params),
                                        tuple(p["b"] for p in params), LR, 0.0)
    errs = {"local_train_f32": close_on_device(deltas, d_ref, 1e-4, 1e-6,
                                               "mesh local_train deltas")}
    close_on_device(loss, l_ref, 1e-5, 0.0, "mesh local_train loss")
    g = torch.Generator().manual_seed(20)
    err = (0.1 * torch.randn(deltas.shape, generator=g)).to(dev)
    fog_id = torch.randint(0, TRAIN_FOG, (n,), generator=g, dtype=torch.int32).to(dev)
    weights = torch.full((n,), float(WINDOW), device=dev)
    k = kops.block_k(0.05)
    fs_k, ne_k, thr_k = fa.compress_aggregate_blocks(deltas, err, fog_id, weights, TRAIN_FOG, k,
                                                     True)
    fs_r, ne_r, thr_r = kref.compress_aggregate_ref(deltas, err, fog_id, weights, TRAIN_FOG, k,
                                                    True)
    check(torch.equal(thr_k, thr_r) and torch.equal(ne_k, ne_r),
          "mesh fused_agg thresholds or new_err differ bitwise")
    check(torch.equal(fs_k, kref.dense_fold_ref(deltas, err, fog_id, weights, TRAIN_FOG, k,
                                                 True)),
          "mesh fused_agg fog sums differ from the client-order fold")
    errs["fused_agg"] = close_on_device(fs_k, fs_r, 1e-5, 1e-4, "mesh fused_agg fog sums")
    print(f"  the mesh rank's kernels at {n} clients: local_train_f32 max|delta diff| "
          f"{errs['local_train_f32']:.3e}, fused_agg into {TRAIN_FOG} fogs bitwise the "
          f"client-order fold, max|diff| {errs['fused_agg']:.3e}  ok")
    return errs


def _bitwise(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def mesh_phase(mods, train_ds, training, flat, fleet, dev, name, smi, workdir) -> dict:
    """Phase 20: mesh-200, the client-sharded round loop over
    ``torch.distributed`` (``launch/sharding.ClientMesh``), its ranks
    spawned after the earlier phases built the kernels.  The mesh rank's
    two kernels at its shapes against their plain versions; then
    (a) one NCCL rank: ``hfl.train`` with the mesh on phase 8's draws
    bitwise equal to the unsharded card run (losses, params, counters,
    energies), ms per round; (b) two gloo ranks sharing the card:
    ``hfl-selective`` and ``fedavg`` trials with the mesh against the
    unsharded card trials (participation, erasures and coop links exactly
    and equal to phases 8 / 17, energies rtol 1e-5, losses within 1%, F1
    within 0.02; params reported), the ranks' params bitwise equal, each
    rank one trial's launches on 100 clients a launch; both families at
    ``MESH_SHORT_ROUNDS`` with params to atol 1e-5 and losses to rtol
    1e-4; ms per round and the
    ms per round in ``all_reduce``; (c) mesh-10k: phase 10's chunked fleet
    on the two ranks, ms per round and each rank's peak device memory
    beside phase 10's; (d) ``Engine(shard_clients=True)`` and
    ``Engine(shard_trials=True)`` against ``Engine()`` over seeds 0-1 x 2
    deployments at ``MESH_SHORT_ROUNDS`` (losses rtol 1e-4, F1 atol 1e-6,
    counters exactly)."""
    exp, hfl, flat_fl, ae, Engine, lt, fa, kops, kref = mods
    cfg = exp.make_config(TRAIN_N, TRAIN_FOG, ROUNDS)
    inputs = exp.draw_trial(torch.Generator().manual_seed(0), train_ds, cfg)   # phase 8's draws
    kernel_err = mesh_kernels(dev, lt, fa, kops, kref, ae, train_ds, inputs)

    # The unsharded references, on the card in this process.
    ds_dev = type(train_ds)(*(t.to(dev) for t in train_ds))
    params_u, m_u = hfl.train(inputs.params, ae.loss, ds_dev, cfg, inputs.dep, inputs.draws)
    m_u = {k: v.cpu() for k, v in m_u._asdict().items()}
    check([float(x) for x in m_u["loss"]] == training["losses"],
          "the unsharded hfl.train's losses differ from phase 8's trial")
    dep, draws = inputs.dep.to(dev), inputs.draws.to(dev)
    params_dev = [{k: v.to(dev) for k, v in layer.items()} for layer in inputs.params]
    unsharded_ms = []
    for _ in range(MESH_TIME_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hfl.train(params_dev, ae.loss, ds_dev, cfg, dep, draws)
        torch.cuda.synchronize()
        unsharded_ms.append((time.perf_counter() - t0) * 1e3 / ROUNDS)
    trials_u = {m: exp.trial_metrics(m, None, train_ds, cfg, inputs=inputs, return_params=True)
                for m in ("hfl-selective", "fedavg")}
    earlier = {"hfl-selective": training, "fedavg": flat["trials"]["fedavg"]}
    for method, t in trials_u.items():
        check(float(t["participation"]) == earlier[method]["participation"],
              f"the unsharded {method} trial's participation differs from its earlier phase's")
    check(float(trials_u["hfl-selective"]["coop_links"]) == training["coop_links"],
          "the unsharded hfl-selective trial's coop links differ from phase 8's")
    short = cfg.replace(rounds=MESH_SHORT_ROUNDS)
    short_u = {}
    for family, train in (("hfl", hfl.train), ("flat", flat_fl.train_flat)):
        p, m = train(inputs.params, ae.loss, ds_dev, short, inputs.dep, inputs.draws)
        short_u[family] = (ae.ravel(p).cpu(), {k: v.cpu() for k, v in m._asdict().items()})
    eng_u = Engine().run("hfl-selective", short, MESH_ENGINE_SEEDS, train_ds,
                         n_deployments=ENGINE_P).metrics
    spec = {"ds": train_ds, "cfg": cfg, "inputs": inputs}
    path = {"local_train_f32": ROUNDS, "fused_agg": 2 * ROUNDS}

    # (a) one rank, NCCL: bitwise the unsharded card run.
    t0 = time.perf_counter()
    (one,) = spawn_mesh([("train",), ("time",)], 1, "nccl", spec, workdir / "nccl")
    nccl_s = time.perf_counter() - t0
    a = one["train"]
    check(torch.equal(a["params"], ae.ravel(params_u).cpu()),
          "(a) one NCCL rank: params differ from the unsharded card run")
    check(_bitwise(a["metrics"], m_u), "(a) one NCCL rank: per-round metrics differ from the "
          "unsharded card run: " + ", ".join(k for k in m_u
                                             if not torch.equal(a["metrics"][k], m_u[k])))
    check({k: a["launches"][k] for k in path} == path, f"(a) launches {a['launches']}")
    check(a["clients"]["local_train_f32"] == [TRAIN_N] * ROUNDS
          and a["clients"]["fused_agg"] == [TRAIN_N] * ROUNDS, f"(a) clients {a['clients']}")
    print(f"  (a) 1 NCCL rank: hfl.train on phase 8's draws bitwise the unsharded card run "
          f"(losses, params, counters, energies); {ROUNDS} local_train_f32 + {ROUNDS} "
          f"fused_agg calls of {TRAIN_N} clients; "
          f"{', '.join(f'{v:.3f}' for v in one['time']['round_ms'])} ms per round, of which "
          f"{one['time']['all_reduce_ms_per_round']:.3f} ms in "
          f"{one['time']['all_reduces_per_round']:.0f} all_reduces (unsharded "
          f"{', '.join(f'{v:.3f}' for v in unsharded_ms)} ms); spawn to results {nccl_s:.1f} s"
          f"  on {name} ({smi})")

    # (b)-(d): two gloo ranks on the one card.
    jobs = [("trial:hfl-selective",), ("trial:fedavg",), ("short:hfl",), ("short:flat",),
            ("time",), ("fleet",), ("engine:clients",), ("engine:trials",)]
    t0 = time.perf_counter()
    ranks = spawn_mesh(jobs, MESH_WORLD, "gloo", spec, workdir / "gloo")
    gloo_s = time.perf_counter() - t0
    half = TRAIN_N // MESH_WORLD
    trials = {}
    for method, want in trials_u.items():
        got = [r[f"trial:{method}"] for r in ranks]
        for other in got[1:]:
            check(torch.equal(other["params"], got[0]["params"])
                  and _bitwise(other["metrics"], got[0]["metrics"]),
                  f"(b) {method}: the ranks' params or metrics differ")
        for r, g in enumerate(got):
            check({k: g["launches"][k] for k in path} == path,
                  f"(b) {method} rank {r}: launches {g['launches']}")
            check(g["clients"]["local_train_f32"] == [half] * ROUNDS
                  and g["clients"]["fused_agg"] == [half] * ROUNDS,
                  f"(b) {method} rank {r}: clients per launch {g['clients']}")
        g = got[0]["metrics"]
        for key in ("participation", "coop_links", "erased_total", "nonfinite_total"):
            check(torch.equal(g[key], want[key].cpu()),
                  f"(b) {method}: {key} {float(g[key])} vs unsharded {float(want[key])}")
        check(float(g["participation"]) == earlier[method]["participation"]
              and float(g["erased_total"]) == earlier[method].get("erased_total", 0.0),
              f"(b) {method}: participation or erasures differ from the earlier phase's")
        for key in ("e_total", "e_s2f", "e_f2f", "e_f2g"):
            check(np.isclose(float(g[key]), float(want[key]), rtol=1e-5, atol=0.0),
                  f"(b) {method}: {key} {float(g[key])} vs unsharded {float(want[key])}")
        lg, lu = g["losses"].numpy(), want["losses"].cpu().numpy()
        loss_rel = float(np.max(np.abs(lg - lu) / np.abs(lu)))
        check(loss_rel <= 0.01, f"(b) {method}: losses differ by {loss_rel:.3e}")
        p_diff = float((got[0]["params"] - ae.ravel(want["params"]).cpu()).abs().max())
        f1_diff = abs(float(g["f1"]) - float(want["f1"]))
        check(f1_diff <= 0.02, f"(b) {method}: F1 {float(g['f1']):.4f} vs unsharded "
                               f"{float(want['f1']):.4f}")
        trials[method] = dict(loss_rel=loss_rel, max_param_diff=p_diff, f1=float(g["f1"]),
                              unsharded_f1=float(want["f1"]),
                              participation=float(g["participation"]),
                              e_total=float(g["e_total"]), launches_per_rank=path,
                              clients_per_launch=half)
        print(f"  (b) {MESH_WORLD} gloo ranks, {method}: both ranks' params bitwise equal; "
              f"participation, coop links, erasures exactly; max rel loss {loss_rel:.2e}, "
              f"max |dparam| after {ROUNDS} rounds {p_diff:.2e} (not gated), F1 "
              f"{float(g['f1']):.4f} (unsharded "
              f"{float(want['f1']):.4f}); each rank {ROUNDS} local_train_f32 + {ROUNDS} "
              f"fused_agg calls of {half} clients")
    for family, (p_u, m_s) in short_u.items():
        got = [r[f"short:{family}"] for r in ranks]
        check(all(torch.equal(o["params"], got[0]["params"]) for o in got[1:]),
              f"(b) {family} at {MESH_SHORT_ROUNDS} rounds: the ranks' params differ")
        p_diff = float((got[0]["params"] - p_u).abs().max())
        check(p_diff <= 1e-5, f"(b) {family} at {MESH_SHORT_ROUNDS} rounds: params differ by "
                              f"{p_diff:.3e}")
        for k, v in m_s.items():
            g = got[0]["metrics"][k]
            if k == "loss":
                ok = bool(torch.allclose(g, v, rtol=1e-4, atol=0.0))
            elif v.dtype.is_floating_point and k != "participation":
                ok = bool(torch.allclose(g, v, rtol=1e-5, atol=0.0))
            else:
                ok = torch.equal(g, v)
            check(ok, f"(b) {family} at {MESH_SHORT_ROUNDS} rounds: {k} {g} vs {v}")
        trials[f"{family} at {MESH_SHORT_ROUNDS} rounds"] = dict(max_param_diff=p_diff)
        print(f"  (b) {family} at {MESH_SHORT_ROUNDS} rounds (the reference's depth): max "
              f"|dparam| {p_diff:.2e} (gate 1e-5), per-round metrics at rtol 1e-5 (losses "
              f"1e-4), counters exactly")
    timing = [r["time"] for r in ranks]
    print(f"      hfl.train ms per round by rank: "
          + "; ".join(f"rank {i} {', '.join(f'{v:.3f}' for v in t['round_ms'])} "
                      f"({t['all_reduce_ms_per_round']:.3f} ms in "
                      f"{t['all_reduces_per_round']:.0f} all_reduces, instrumented run "
                      f"{t['instrumented_round_ms']:.3f})" for i, t in enumerate(timing))
          + f"  on {name} ({smi})")

    # (c) mesh-10k.
    fl = [r["fleet"] for r in ranks]
    chunks = -(-(FLEET_N // MESH_WORLD) // FLEET_CHUNK)
    for r, f in enumerate(fl):
        check(f["launches"]["wire_emit"] == chunks * FLEET_ROUNDS
              and f["launches"]["wire_agg"] == chunks * FLEET_ROUNDS
              and sum(f["clients"]["wire_emit"]) == FLEET_N // MESH_WORLD * FLEET_ROUNDS,
              f"(c) rank {r}: launches {f['launches']}")
    check(_bitwise(fl[0]["metrics"], fl[1]["metrics"]), "(c) the ranks' metrics differ")
    m10 = fl[0]["metrics"]
    part10 = float(torch.mean(m10["participation"]))
    check(part10 == fleet["chunked"]["participation"],
          f"(c) participation {part10} vs phase 10's {fleet['chunked']['participation']}")
    loss10 = [float(m10["loss"][0]), float(m10["loss"][-1])]
    want10 = [fleet["chunked"]["loss_first"], fleet["chunked"]["loss_last"]]
    rel10 = max(abs(g - w) / abs(w) for g, w in zip(loss10, want10))
    check(rel10 <= 0.01, f"(c) losses {loss10} vs phase 10's {want10}")
    peaks = [f["peak_bytes"] for f in fl]
    print(f"  (c) mesh-10k N={FLEET_N} M={FLEET_FOG} T={FLEET_ROUNDS} chunk {FLEET_CHUNK} on "
          f"{MESH_WORLD} gloo ranks: "
          + ", ".join(f"rank {i} {f['ms_per_round']:.3f} ms per round, peak "
                      f"{f['peak_bytes'] / 2**20:.1f} MiB" for i, f in enumerate(fl))
          + f" (phase 10 unsharded, same chunk: {fleet['chunked']['ms_per_round']:.3f} ms, "
          f"{fleet['chunked']['peak_bytes'] / 2**20:.1f} MiB); participation as phase 10's, "
          f"max rel loss {rel10:.2e}; each rank {chunks} wire_emit + {chunks} wire_agg a round"
          f"  on {name} ({smi})")

    # (d) the Engine.
    engine = {}
    for mode in ("clients", "trials"):
        got = [r[f"engine:{mode}"] for r in ranks]
        check(_bitwise(got[0]["metrics"], got[1]["metrics"]), f"(d) {mode}: ranks differ")
        (entry,) = got[0]["log"]
        check(entry["client_sharded"] is (mode == "clients")
              and entry["trial_sharded"] is (mode == "trials"), f"(d) {mode}: log {entry}")
        g = got[0]["metrics"]
        for key in ("participation", "coop_links", "erased_total", "nonfinite_total",
                    "nonfinite_rounds"):
            check(torch.equal(g[key], eng_u[key].cpu()), f"(d) {mode}: {key} differs")
        lg, lu = g["losses"].numpy(), eng_u["losses"].cpu().numpy()
        loss_rel = float(np.max(np.abs(lg - lu) / np.abs(lu)))
        check(loss_rel <= 1e-4, f"(d) {mode}: losses differ by {loss_rel:.3e}")
        f1_diff = float((g["f1"] - eng_u["f1"].cpu()).abs().max())
        check(f1_diff <= 1e-6, f"(d) {mode}: F1 differs by {f1_diff:.3e}")
        engine[mode] = dict(loss_rel=loss_rel, f1_diff=f1_diff, launches=entry["launches"],
                            wall_s=entry["wall_s"])
        print(f"  (d) Engine(shard_{mode}=True), T={MESH_SHORT_ROUNDS}, over seeds "
              f"{MESH_ENGINE_SEEDS} x {ENGINE_P} on "
              f"{MESH_WORLD} gloo ranks vs Engine(): counters exactly, max rel loss "
              f"{loss_rel:.2e}, max |dF1| {f1_diff:.2e}; rank 0 launched {entry['launches']} "
              f"in {entry['wall_s']:.3f} s")
    print(f"    spawn to results: {gloo_s:.1f} s for the {MESH_WORLD} gloo ranks")
    return dict(kernel_max_abs_err=kernel_err, unsharded_round_ms=unsharded_ms,
                nccl_one_rank=dict(time=one["time"], launches={k: a["launches"][k]
                                                               for k in path}),
                gloo_two_ranks=dict(trials=trials, time=timing, launches_per_rank=path),
                mesh_10k=dict(ms_per_round=[f["ms_per_round"] for f in fl],
                              peak_bytes=peaks, chunks_per_rank_round=chunks,
                              loss_rel_vs_phase_10=rel10,
                              phase_10_peak_bytes=fleet["chunked"]["peak_bytes"],
                              wire_launches_per_rank={k: fl[0]["launches"][k]
                                                      for k in ("wire_emit", "wire_agg")}),
                engine=engine, spawn_s=dict(nccl=nccl_s, gloo=gloo_s))


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
             smi, prepare=None) -> dict:
    """Serve ``cfg`` with random weights from seed 0: token-stepped prefill
    of random prompts, greedy decode (``launch/serve``), the ``swa_decode``
    launches of that run (zeroed just before it, read just after), prefill
    and decode tokens/s, ms per decode step, peak memory, the cache's
    bytes; then, continuing from the decode's final cache, one step whose
    ``swa_decode`` calls are held against the plain version
    (``check_swa_on_path``), and the device time and idle share of the
    steps after it.  ``prepare(params, cache) -> cache`` runs before the
    timed prefill (an enc-dec model's cross K/V)."""
    g = torch.Generator(device=dev).manual_seed(0)
    params = api.init_params(g, cfg)
    cache = api.init_cache(cfg, batch, prompt_len + new_tokens + 1, device=dev)
    if prepare is not None:
        cache = prepare(params, cache)
    from repro_torch.models.layers import leaves
    cache_bytes = sum(t.numel() * t.element_size() for t in leaves(cache))
    param_bytes = sum(t.numel() * t.element_size() for t in leaves(params))
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
        sample=toks[0, :8].tolist(), cache_bytes=cache_bytes, param_bytes=param_bytes,
    )
    print(f"  {label}: {cfg.name} {cfg.n_layers} layers d={cfg.d_model} {cfg.dtype}, batch "
          f"{batch}, prompt {prompt_len} + {new_tokens} new: prefill {out['prefill_tok_s']:.1f} "
          f"tok/s ({t_prefill:.3f} s), decode {out['decode_tok_s']:.1f} tok/s, {step_ms:.3f} ms "
          f"per step; peak {peak_mib:.1f} MiB, cache {cache_bytes:,} bytes; a decode step: "
          f"{dev_ms:.3f} ms device time in "
          f"{ops} ops (swa_decode {swa_ms * 1e3:.1f} us), idle share {out['idle_share']:.3f}; "
          f"swa_decode launches {launches}  on {name} ({smi})")
    print(f"  {label}: the next step's {path_check['calls']} swa_decode calls (cache lengths "
          f"{path_check['lengths']}, S={path_check['s']}) vs the plain version: max |diff| "
          f"{path_check['max_abs_err']:.3e}; profiled steps at lengths {first + 2}-"
          f"{first + 1 + PROFILE_STEPS} (writes past S={path_check['s']} clamp to the last slot)")
    del params, cache
    torch.cuda.empty_cache()
    return out


class RouteRecorder:
    """While active, every ``models/moe.top_k`` call's expert ids, copied to
    the host (a MoE model's routing, to compare two runs slot by slot), and
    every ``models/moe._slot_one_hots`` call's (selections that kept a
    slot, selections): the dispatch's drops at capacity."""

    def __init__(self, moe):
        self.moe, self.ids, self.kept = moe, [], []

    def __enter__(self):
        self.plain, self.plain_slots = self.moe.top_k, self.moe._slot_one_hots

        def record(probs, k):
            vals, ids = self.plain(probs, k)
            self.ids.append(ids.cpu())
            return vals, ids

        def record_slots(pos, sel, cap):
            out = self.plain_slots(pos, sel, cap)
            self.kept.append((int(out.sum()), int(sel.sum())))
            return out

        self.moe.top_k, self.moe._slot_one_hots = record, record_slots
        return self

    def __exit__(self, *exc):
        self.moe.top_k, self.moe._slot_one_hots = self.plain, self.plain_slots


def slot_diffs(a: RouteRecorder, b: RouteRecorder) -> int:
    """Token-slots whose expert id differs between two recorded runs."""
    check(len(a.ids) == len(b.ids), "the two runs routed a different number of times")
    return sum(int((x != y).sum()) for x, y in zip(a.ids, b.ids))


def card_vs_cpu(label, api, layers, swa, cfg, dev, batch, steps, gate: bool, moe=None) -> dict:
    """Teacher-force the same tokens through the model on the card and on
    the CPU (same weights, drawn on the card from seed 1 and copied):
    max over steps of max |dlogit| / max |logit|, gated at ``LM_GATE``
    when ``gate``; the card's ``swa_decode`` launches.  With ``moe`` (the
    ``models/moe`` module, for a MoE model) the two runs' expert ids are
    recorded and counted where they differ; the gate then holds only where
    none differ (a differing slot is a router near-tie, and the logits
    after it part), and the error is recorded."""
    gpu_params = api.init_params(torch.Generator(device=dev).manual_seed(1), cfg)
    cpu_params = layers.map_leaves(lambda t: t.cpu(), gpu_params)
    caches = [api.init_cache(cfg, batch, steps + 1, device=dev),
              api.init_cache(cfg, batch, steps + 1, device="cpu")]
    step = api.make_serve_step(cfg)
    toks = torch.randint(0, cfg.vocab_size, (steps, batch, 1),
                         generator=torch.Generator().manual_seed(2), dtype=torch.int32)
    worst, launches = 0.0, 0
    routes = (RouteRecorder(moe), RouteRecorder(moe)) if moe is not None else None
    for t in range(steps):
        swa.reset_launches()
        if routes:
            with routes[0]:
                caches[0], got = step(gpu_params, caches[0], toks[t].to(dev))
        else:
            caches[0], got = step(gpu_params, caches[0], toks[t].to(dev))
        launches += swa.LAUNCHES["swa_decode"]
        if routes:
            with routes[1]:
                caches[1], want = step(cpu_params, caches[1], toks[t])
        else:
            caches[1], want = step(cpu_params, caches[1], toks[t])
        got = got.cpu()
        check(bool(torch.isfinite(got).all()), f"{label}: non-finite logits at step {t}")
        worst = max(worst, float((got - want).abs().max() / want.abs().max()))
    diffs = slot_diffs(*routes) if routes else None
    gated = gate and not diffs
    if gated:
        check(worst <= LM_GATE, f"{label}: card vs CPU max rel |dlogit| {worst:.3e} > {LM_GATE}")
    print(f"  {label} card vs CPU ({cfg.name}, {cfg.n_layers} layers d={cfg.d_model} {cfg.dtype}, "
          f"batch {batch}, {steps} steps teacher-forced): max |dlogit| / max |logit| "
          f"{worst:.3e}{' (gate ' + str(LM_GATE) + ')' if gated else ' (recorded)'}; "
          f"swa_decode launches {launches}"
          + (f"; expert slots differing {diffs}" if routes else ""))
    del gpu_params, cpu_params, caches
    torch.cuda.empty_cache()
    return dict(max_rel_logit_diff=worst, launches=launches, steps=steps, batch=batch,
                layers=cfg.n_layers, dtype=str(cfg.dtype), expert_slots_differing=diffs,
                gated=gated)


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


# --- phase 21: lm-train --------------------------------------------------------------

TRAIN_FULL = ["--full", "--steps", "5", "--batch", "4", "--seq", "512"]   # (a), (b)
HYBRID_TRAIN_ARCH, DENSE_TRAIN_ARCH = "recurrentgemma-2b", "llama3-8b"
# (c) one train step on the card against the CPU, f32, same weights and
# tokens: (arch, layers at full width or None for REDUCED).
TRAIN_VS_CPU = {"hybrid full width": ("recurrentgemma-2b", 3),
                "dense full width": ("llama3-8b", 2),
                "gemma2 REDUCED": ("gemma2-27b", None),
                "internvl2 REDUCED": ("internvl2-26b", None)}
TRAIN_VS_CPU_BATCH, TRAIN_VS_CPU_SEQ = 2, 64
# The f32 params round each new value to one ulp of |p|; at the configs'
# lr 3e-4 that is ~4e-4 of the largest update coordinate on either side
# (CPU against the JAX package, tests/test_torch_lm_train.py), so the
# update is compared at lr 1e-2, the reference's pod tests' rate.
TRAIN_VS_CPU_LR = 1e-2
TRAIN_LOSS_GATE, TRAIN_UPDATE_GATE = 1e-4, 1e-3
PREFILL_CHECK_LAYERS = 3        # (d) forward vs token-stepped prefill, f32
POD_ARCH, POD_LAYERS, POD_BATCH, POD_SEQ, POD_STEPS = "llama3-8b", 2, 4, 128, 3
FED_STEPS, FED_LOSS_GATE = 5, 1e-4
FED_SLICE_BLOCKS = 4            # (f) blocks a slice held bitwise to the plain version
FED_TAIL = 4113                 # (f) the row cut by this much leaves an 8,175-wide last block
                                # (d = 1,486,901,248 is 4,096 past its last whole block)


def train_run(label, train, arch, name, smi, argv=TRAIN_FULL) -> dict:
    """``launch/train.main`` production at the published config (``argv``:
    ``TRAIN_FULL`` unless given) on the card: ms a step (the first
    excluded), tokens/s, peak memory; the losses must be finite."""
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = train.main(["production", "--arch", arch, *argv])
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    check(out["finite"], f"{label}: non-finite losses {out['losses']}")
    step_ms = [s * 1e3 for s in out["step_s"]]
    res = dict(arch=arch, losses=out["losses"], step_ms=step_ms,
               ms_per_step=sum(step_ms[1:]) / len(step_ms[1:]), tokens_per_s=out["tokens_per_s"],
               peak_gib=peak_gib, param_bytes=out["param_bytes"])
    shape = dict(zip(argv[1::2], argv[2::2]))
    print(f"  {label}: {arch} published config, batch {shape['--batch']} x {shape['--seq']}, "
          f"{shape['--steps']} steps: "
          f"{res['ms_per_step']:.1f} ms a step after the first ({step_ms[0]:.1f} ms), "
          f"{res['tokens_per_s']:.0f} tokens/s, peak {peak_gib:.2f} GiB, losses "
          f"{[round(x, 4) for x in out['losses']]}  on {name} ({smi})")
    torch.cuda.empty_cache()
    return res


def checkpoint_on_card(train, configs, api, sgd, CheckpointStore, dev, workdir) -> dict:
    """At REDUCED on the card: a train step's params saved and restored
    bitwise, and ``launch/train`` resuming from its own checkpoint."""
    cfg = configs.get(HYBRID_TRAIN_ARCH, reduced=True)
    g = torch.Generator(device=dev).manual_seed(0)
    params = api.init_params(g, cfg)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 32), generator=g, device=dev)}
    params, _ = api.make_train_step(cfg)(params, batch)
    store = CheckpointStore(str(workdir / "store"))
    store.save(1, params)
    back, step = store.restore(api.init_params(torch.Generator(device=dev).manual_seed(9), cfg))
    same = all(a.dtype == b.dtype and a.device == b.device and torch.equal(a, b)
               for a, b in zip(sgd.tree_leaves(back), sgd.tree_leaves(params)))
    check(step == 1 and same, "a REDUCED checkpoint restored on the card differs from the saved")
    argv = ["production", "--arch", HYBRID_TRAIN_ARCH, "--batch", "2", "--seq", "32",
            "--ckpt-dir", str(workdir / "launch"), "--steps"]
    first, second = train.main(argv + ["2"]), train.main(argv + ["1"])
    check(first["start"] == 0 and second["start"] == 2,
          f"launch/train resumed at {second['start']}, expected 2")
    print(f"  checkpoint: {cfg.name} ({cfg.dtype}) params restored on the card bitwise; "
          f"launch/train resumed at step {second['start']}")
    return dict(bitwise=same, resumed_at=second["start"])


def train_card_vs_cpu(label, api, layers, sgd, cfg, dev, moe=None) -> dict:
    """One ``make_train_step`` on the card and on the CPU from the same
    weights (drawn on the card from seed 1, copied) and tokens (and frames,
    for an enc-dec model): loss within ``TRAIN_LOSS_GATE`` relative and
    every leaf's update (new - old) within ``TRAIN_UPDATE_GATE`` of the
    largest update coordinate, in f32.  With ``moe`` a forward on each
    side records the expert ids, and the gates hold only where no
    token-slot's id differs (``card_vs_cpu``)."""
    gpu = api.init_params(torch.Generator(device=dev).manual_seed(1), cfg)
    cpu = layers.map_leaves(lambda t: t.cpu(), gpu)
    g = torch.Generator().manual_seed(2)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (TRAIN_VS_CPU_BATCH, TRAIN_VS_CPU_SEQ),
                                     generator=g, dtype=torch.int32)}
    if cfg.n_visual_tokens:
        batch["visual_embeds"] = torch.randn((TRAIN_VS_CPU_BATCH, cfg.n_visual_tokens,
                                              cfg.d_model), generator=g).to(cfg.dtype)
    if cfg.family == "encdec":
        batch["audio_embeds"] = torch.randn((TRAIN_VS_CPU_BATCH, cfg.n_audio_frames,
                                             cfg.d_model), generator=g).to(cfg.dtype)
    diffs = None
    if moe is not None:
        routes = (RouteRecorder(moe), RouteRecorder(moe))
        with torch.no_grad():
            with routes[0]:
                moe.forward(gpu, {k: v.to(dev) for k, v in batch.items()}, cfg)
            with routes[1]:
                moe.forward(cpu, batch, cfg)
        diffs = slot_diffs(*routes)
    step = api.make_train_step(cfg)
    new_g, loss_g = step(gpu, {k: v.to(dev) for k, v in batch.items()})
    new_c, loss_c = step(cpu, batch)
    loss_rel = abs(float(loss_g) - float(loss_c)) / abs(float(loss_c))
    worst, biggest = 0.0, 0.0
    for pg, ng, pc, nc in zip(*(sgd.tree_leaves(t) for t in (gpu, new_g, cpu, new_c))):
        uc = nc.float() - pc.float()
        ug = (ng.float() - pg.float()).cpu()
        worst = max(worst, float((ug - uc).abs().max()))
        biggest = max(biggest, float(uc.abs().max()))
    upd_rel = worst / biggest
    gate = cfg.dtype == torch.float32 and not diffs
    if gate:
        check(math.isfinite(float(loss_g)) and loss_rel <= TRAIN_LOSS_GATE,
              f"{label}: card loss {float(loss_g)} vs CPU {float(loss_c)} ({loss_rel:.3e})")
        check(upd_rel <= TRAIN_UPDATE_GATE,
              f"{label}: update max |diff| {worst:.3e} > {TRAIN_UPDATE_GATE} * {biggest:.3e}")
    print(f"  {label} card vs CPU ({cfg.name}, {cfg.n_layers} layers d={cfg.d_model} "
          f"{cfg.dtype}, batch {TRAIN_VS_CPU_BATCH} x {TRAIN_VS_CPU_SEQ}, lr "
          f"{cfg.learning_rate:g}): loss {float(loss_g):.6f} vs {float(loss_c):.6f} (rel "
          f"{loss_rel:.3e}), update max |diff| / max |update| {upd_rel:.3e}"
          + (f" (gates {TRAIN_LOSS_GATE}, {TRAIN_UPDATE_GATE})" if gate else " (recorded)")
          + (f"; expert slots differing {diffs}" if moe is not None else ""))
    del gpu, cpu, new_g, new_c
    torch.cuda.empty_cache()
    return dict(loss_card=float(loss_g), loss_cpu=float(loss_c), loss_rel=loss_rel,
                update_rel=upd_rel, layers=cfg.n_layers, dtype=str(cfg.dtype),
                expert_slots_differing=diffs, gated=gate)


def prefill_phase(configs, api, serve, rglru, swa, hybrid_serve, dev, name, smi) -> dict:
    """(d) ``make_prefill_step`` at hybrid-serve's shape (its params and
    prompts: seed 0 on the card) beside phase 15's token-stepped prefill;
    then, in f32 cut to ``PREFILL_CHECK_LAYERS`` layers, the forward's last
    hidden state through the tied embedding held to the token-stepped
    prefill's last logits (``LM_GATE``), whose ``swa_decode`` launches
    must be n_attn x the prompt."""
    full = configs.get(HYBRID_ARCH)
    g = torch.Generator(device=dev).manual_seed(0)
    params = api.init_params(g, full)
    prompts = torch.randint(0, full.vocab_size, (HYBRID_BATCH, HYBRID_PROMPT), generator=g,
                            device=dev, dtype=torch.int32)
    prefill = api.make_prefill_step(full)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(4):
        t0 = time.perf_counter()
        h = prefill(params, {"tokens": prompts})
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    check(h.shape == (HYBRID_BATCH, full.d_model) and bool(torch.isfinite(h.float()).all()),
          "prefill: bad last hidden state")
    ms = sum(times[1:]) / len(times[1:])
    tok_s = HYBRID_BATCH * HYBRID_PROMPT / (ms / 1e3)
    stepped = hybrid_serve["prefill_s"] * 1e3
    del params
    torch.cuda.empty_cache()

    cfg = cut(full, PREFILL_CHECK_LAYERS).replace(dtype=torch.float32)
    g = torch.Generator(device=dev).manual_seed(1)
    params = api.init_params(g, cfg)
    prompts32 = torch.randint(0, cfg.vocab_size, (HYBRID_BATCH, HYBRID_PROMPT), generator=g,
                              device=dev, dtype=torch.int32)
    h = api.make_prefill_step(cfg)(params, {"tokens": prompts32})
    logits = (h @ params.embed.T).float()
    cache = api.init_cache(cfg, HYBRID_BATCH, HYBRID_PROMPT + 1, device=dev)
    swa.reset_launches()
    _, stepped_logits = serve.prefill_into_cache(cfg, params, cache, prompts32)
    torch.cuda.synchronize()
    launches = swa.LAUNCHES["swa_decode"]
    want = rglru.pattern(cfg).count("attn") * HYBRID_PROMPT
    check(launches == want, f"prefill check: {launches} swa_decode launches, expected {want}")
    ref_logits = stepped_logits[:, -1, :]
    rel = float((logits - ref_logits).abs().max() / ref_logits.abs().max())
    check(rel <= LM_GATE, f"prefill: forward vs token-stepped max |dlogit| / max |logit| "
          f"{rel:.3e} > {LM_GATE}")
    print(f"  prefill: {full.name} {full.dtype}, batch {HYBRID_BATCH}, prompt {HYBRID_PROMPT}: "
          f"make_prefill_step {ms:.2f} ms ({tok_s:.0f} prompt tokens/s; first call "
          f"{times[0]:.1f} ms), peak {peak_gib:.2f} GiB; phase 15's token-stepped prefill "
          f"{stepped:.1f} ms ({hybrid_serve['prefill_tok_s']:.0f} tokens/s)  on {name} ({smi})")
    print(f"  prefill check ({cfg.n_layers} layers, f32): forward's last hidden through the "
          f"tied embedding vs the token-stepped prefill's last logits: max |dlogit| / max |logit| "
          f"{rel:.3e} (gate {LM_GATE}); swa_decode launches {launches}")
    del params, cache
    torch.cuda.empty_cache()
    return dict(ms=ms, first_ms=times[0], prompt_tok_s=tok_s, peak_gib=peak_gib,
                token_stepped_ms=stepped, token_stepped_tok_s=hybrid_serve["prefill_tok_s"],
                check_rel=rel, swa_launches=launches)


def pod_job(job, spec, mesh, dev) -> dict:
    """A pod step run (phase 21 (e)): ``job`` = ("pod:<label>", cfg, kw,
    keep); params from seed 0 on the card, tokens (POD_BATCH, POD_SEQ) from
    seed 3; ``mesh`` a client mesh (rank r is pod r) or None (``kw``'s
    n_pods looped in this process).  ms a step, losses, peak memory, the
    bytes a pod sends a step; with ``keep`` the flat params and error
    buffers."""
    from repro_torch.core import mesh_fl
    from repro_torch.models import api
    from repro_torch.optim import sgd
    _, cfg, kw, keep = job
    params = api.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (POD_BATCH, POD_SEQ),
                                     generator=torch.Generator().manual_seed(3),
                                     dtype=torch.int32).to(dev)}
    step = mesh_fl.make_pod_hfl_train_step(cfg, mesh, **kw)
    err = mesh_fl.init_err(params, None if mesh is not None else kw.get("n_pods", 1))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses = [], []
    for _ in range(POD_STEPS):
        t0 = time.perf_counter()
        params, err, loss = step(params, err, batch)
        losses.append(float(loss))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    out = dict(step_ms=step_ms, losses=losses,
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               payload_bytes=mesh_fl.payload_bytes(params, kw.get("mode", "int8")),
               d=sum(p.numel() for p in sgd.tree_leaves(params)))
    if keep:
        out["params"] = sgd.ravel_tree([p.float() for p in sgd.tree_leaves(params)]).cpu()
        out["err"] = [e.cpu() for e in sgd.tree_leaves(err)]
    del params, err
    torch.cuda.empty_cache()
    return out


MESH_JOBS["pod"] = pod_job


def pod_phase(configs, dev, name, smi, workdir) -> dict:
    """(e) The pod family: llama3-8b at full width cut to ``POD_LAYERS``
    layers, int8, E = 1 and 2, ``POD_STEPS`` steps, as one NCCL rank (one
    pod) and as the one-process 2-pod loop; then two gloo ranks sharing
    the card at REDUCED in both modes, their params bitwise equal to each
    other and to the one-process 2-pod loop's, each rank's error buffers
    to the loop's pod r."""
    cfg = cut(configs.get(POD_ARCH), POD_LAYERS)
    runs = {}
    torch.cuda.empty_cache()
    nccl_jobs = [(f"pod:nccl-e{e}", cfg, dict(mode="int8", local_epochs=e), False)
                 for e in (1, 2)]
    (one,) = spawn_mesh(nccl_jobs, 1, "nccl", {}, workdir / "pod_nccl")
    for e in (1, 2):
        runs[f"1 NCCL rank, E={e}"] = one[f"pod:nccl-e{e}"]
        runs[f"2-pod loop, E={e}"] = pod_job(
            ("pod:loop", cfg, dict(mode="int8", local_epochs=e, n_pods=2), False), {}, None, dev)
    for label, r in runs.items():
        check(all(math.isfinite(x) for x in r["losses"]), f"pods {label}: non-finite losses")
        ms = sum(r["step_ms"][1:]) / len(r["step_ms"][1:])
        r["ms_per_step"] = ms
        print(f"  pods {label}: {cfg.name} {cfg.n_layers} layers (d={r['d']:,}), int8, batch "
              f"{POD_BATCH} x {POD_SEQ}: {ms:.1f} ms a step after the first "
              f"({r['step_ms'][0]:.1f}), {r['payload_bytes']:,} bytes a pod a step "
              f"({r['payload_bytes'] / (4 * r['d']):.3f} of dense f32), peak "
              f"{r['peak_gib']:.2f} GiB, losses {[round(x, 4) for x in r['losses']]}  "
              f"on {name} ({smi})")
    small = configs.get(POD_ARCH, reduced=True).replace(learning_rate=1e-2)
    modes = ("int8", "topk")
    gloo = spawn_mesh([(f"pod:{m}", small, dict(mode=m), True) for m in modes], 2, "gloo", {},
                      workdir / "pod_gloo")
    for m in modes:
        loop = pod_job(("pod:loop", small, dict(mode=m, n_pods=2), True), {}, None, dev)
        for r in range(2):
            got = gloo[r][f"pod:{m}"]
            check(torch.equal(got["params"], loop["params"]),
                  f"pods gloo {m}: rank {r}'s params differ from the 2-pod loop's")
            check(all(torch.equal(a, b[r]) for a, b in zip(got["err"], loop["err"])),
                  f"pods gloo {m}: rank {r}'s error buffers differ from the loop's pod {r}")
            check(got["losses"] == loop["losses"], f"pods gloo {m}: rank {r}'s losses differ")
        runs[f"2 gloo ranks REDUCED {m}"] = dict(
            step_ms=gloo[0][f"pod:{m}"]["step_ms"], losses=loop["losses"],
            payload_bytes=loop["payload_bytes"], bitwise_loop=True)
        print(f"  pods 2 gloo ranks on the card, {small.name} {m}: both ranks' params bitwise "
              f"the 2-pod loop's, error buffers the loop's pod r; losses "
              f"{[round(x, 4) for x in loop['losses']]}")
    for r in runs.values():
        r.pop("params", None)
        r.pop("err", None)
    return runs


def fed_gradient_row(configs, api, sgd, lm_batches, dev) -> torch.Tensor:
    """Phase 21 (f)'s row, (1, d) f32: -1e-3 times llama3-8b's gradient at
    full width cut to 2 layers (weights from seed 0) on one batch of 2 x 32
    tokens."""
    cfg = cut(configs.get(POD_ARCH), POD_LAYERS)
    params = api.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    stream = torch.randint(0, cfg.vocab_size, (4096,), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(1))
    batch = {"tokens": lm_batches(torch.Generator().manual_seed(2), stream, 2, 32).to(dev)}
    grads, _ = sgd.grad_and_value(api.loss_fn(cfg))(params, batch)
    del params
    delta = (-1e-3 * sgd.ravel_tree([g.float() for g in sgd.tree_leaves(grads)]))[None]
    del grads
    torch.cuda.empty_cache()
    return delta


def fed_llm_phase(federated_llm, configs, api, sgd, comp, kops, kq8, kref, lm_batches, dev,
                  name, smi) -> dict:
    """(f) One ``compress_update`` at llama3-8b full width cut to 2 layers
    (one f32 row of d ~ 1.49e9, the example's update of a real gradient):
    ``compress_q8``'s time a launch against its bound, peak memory, and its
    output on whole-block slices (the first, a middle and the last blocks,
    and the last of the row cut by ``FED_TAIL``, a ragged one) bitwise
    equal to the plain version run on the same blocks; then the
    federated-LLM example at REDUCED on the card against the CPU (f32:
    losses within ``FED_LOSS_GATE`` relative; bf16 recorded; one
    ``compress_q8`` launch a step)."""
    delta = fed_gradient_row(configs, api, sgd, lm_batches, dev)
    err = torch.zeros_like(delta)
    d = delta.shape[1]
    cc = comp.CompressorConfig(rho_s=0.05, quant_bits=8)
    k = kops.block_k(comp.blockwise_k_frac(d, cc.rho_s))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kq8.reset_launches()
    recon, new_err = comp.compress_update(delta, err, cc)
    torch.cuda.synchronize()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    check(kq8.LAUNCHES["compress_q8"] == 1 and bool(torch.isfinite(recon).all()),
          "federated-llm full width: compress_update did not run compress_q8 once")
    del recon, new_err
    torch.cuda.empty_cache()

    # CUDA events over back-to-back launches: at ~10 ms a launch the host
    # is idle, and torch.profiler's CUPTI trace of these launches came back
    # empty more often than not on the H100.
    ms = call_ms(lambda: kq8.compress_blocks(delta, err, k), 3)
    bound_ms, bound_by = bound_from(*compress_work(1, d, True))
    checked = 0
    for dd in (d, d - FED_TAIL):
        q, scale, ne = kq8.compress_blocks(delta[:, :dd], err[:, :dd], k)
        nb = scale.shape[1]
        for b0 in (0, nb // 2, nb - FED_SLICE_BLOCKS):
            a0, a1 = b0 * kops.BLOCK_ELEMS, min(dd, (b0 + FED_SLICE_BLOCKS) * kops.BLOCK_ELEMS)
            wq, ws, we = kref.compress_ref(delta[:, a0:a1].contiguous(),
                                           err[:, a0:a1].contiguous(), k)
            same = (torch.equal(q[:, a0:a1], wq) and torch.equal(ne[:, a0:a1], we)
                    and torch.equal(scale[:, b0:b0 + FED_SLICE_BLOCKS], ws))
            check(same, f"compress_q8 at d={dd:,}: blocks {b0}.. differ from the plain version")
            checked += a1 - a0
        del q, scale, ne
        torch.cuda.empty_cache()
    print(f"  federated-llm full width: one compress_update of d={d:,} ({d % kops.BLOCK_ELEMS} "
          f"past the last whole block) at k={k}: peak {peak_gib:.2f} GiB ({base / 2 ** 30:.2f} "
          f"resident before it); compress_q8 {ms:.3f} ms a launch (CUDA events), "
          f"bound {bound_ms:.3f} ms ({bound_by}); {checked:,} coordinates of whole-block slices "
          f"bitwise the plain version (first, middle, last; and at d={d - FED_TAIL:,}, a "
          f"{(d - FED_TAIL) % kops.BLOCK_ELEMS}-wide last block)  on {name} ({smi})")
    del delta, err
    torch.cuda.empty_cache()

    reduced, launches = {}, {}
    for tag, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        cfg = configs.get(POD_ARCH, reduced=True).replace(dtype=dtype)
        kq8.reset_launches()
        card = federated_llm.main([], cfg=cfg, steps=FED_STEPS)
        launches[tag] = kq8.LAUNCHES["compress_q8"]
        host = federated_llm.main([], cfg=cfg, steps=FED_STEPS, device="cpu")
        check(launches[tag] == FED_STEPS, f"federated-llm {tag}: {launches[tag]} compress_q8 "
              f"launches, expected {FED_STEPS}")
        rel = max(abs(a - b) / abs(b) for a, b in zip(card["losses"], host["losses"]))
        if tag == "f32":
            check(rel <= FED_LOSS_GATE, f"federated-llm: card vs CPU losses {rel:.3e} apart")
        reduced[tag] = dict(d=card["d"], losses=card["losses"], cpu_losses=host["losses"],
                            max_rel=rel, compress_q8_launches=launches[tag])
        print(f"  federated-llm REDUCED {tag} (d={card['d']:,}), {FED_STEPS} steps: losses card "
              f"{[round(x, 5) for x in card['losses']]}, max rel vs CPU {rel:.3e}"
              f"{' (gate ' + str(FED_LOSS_GATE) + ')' if tag == 'f32' else ' (recorded)'}; "
              f"compress_q8 launches {launches[tag]}")
    return dict(reduced=reduced,
                full=dict(d=d, k=k, ms=ms, bound_ms=bound_ms, bound_by=bound_by,
                          peak_gib=peak_gib, resident_gib=base / 2 ** 30,
                          checked_coordinates=checked))


def lm_train_phase(mods, hybrid_serve, dev, name, smi, workdir) -> dict:
    """Phase 21: language-model training and the full-sequence forward,
    and the pod family; (a)-(f) of the module docstring."""
    (train, configs, api, layers, serve, rglru, swa, kref, sgd, CheckpointStore, comp, kops,
     kq8, federated_llm, lm_batches) = mods
    out = {"hybrid-train": train_run("hybrid-train", train, HYBRID_TRAIN_ARCH, name, smi)}
    out["checkpoint"] = checkpoint_on_card(train, configs, api, sgd, CheckpointStore, dev,
                                           workdir)
    out["dense-train"] = train_run("dense-train", train, DENSE_TRAIN_ARCH, name, smi)
    vs_cpu = {}
    for label, (arch, lay) in TRAIN_VS_CPU.items():
        base = configs.get(arch, reduced=lay is None)
        for dtype in ((torch.float32,) if lay is not None else (torch.float32, torch.bfloat16)):
            cfg = cut(base, lay).replace(dtype=dtype, learning_rate=TRAIN_VS_CPU_LR)
            key = f"{label} {'f32' if dtype == torch.float32 else 'bf16'}"
            vs_cpu[key] = train_card_vs_cpu(key, api, layers, sgd, cfg, dev)
    out["train_card_vs_cpu"] = vs_cpu
    out["prefill"] = prefill_phase(configs, api, serve, rglru, swa, hybrid_serve, dev, name, smi)
    out["pods"] = pod_phase(configs, dev, name, smi, workdir)
    out["federated-llm"] = fed_llm_phase(federated_llm, configs, api, sgd, comp, kops, kq8,
                                         kref, lm_batches, dev, name, smi)
    return out


# --- phase 22: lm-families: the moe, ssm and encdec families, and qwen3 ------------

MOE_ARCH, MOE_BATCH, MOE_PROMPT, MOE_NEW = "qwen2-moe-a2.7b", 8, 128, 32          # (a) uncut
MOE_TRAIN_LAYERS, MOE_TRAIN_BATCH, MOE_TRAIN_SEQ, MOE_TRAIN_STEPS = 12, 4, 512, 5  # (b)
GROK_ARCH, GROK_LAYERS, GROK_BATCH, GROK_PROMPT, GROK_NEW = "grok-1-314b", 2, 8, 32, 16  # (c)
SSM_ARCH, SSM_BATCH, SSM_PROMPT, SSM_NEW = "mamba2-2.7b", 8, 128, 32               # (d) uncut
SSM_PREFILL_BATCH, SSM_PREFILL_SEQ = 8, 256
ED_ARCH, ED_BATCH, ED_PROMPT, ED_NEW = "whisper-medium", 8, 128, 32               # (e) uncut
ED_TRAIN = ["--full", "--steps", "5", "--batch", "4", "--seq", "448"]   # whisper's decoder context
QWEN3_ARCH, QWEN3_LAYERS, QWEN3_BATCH, QWEN3_PROMPT, QWEN3_NEW = "qwen3-14b", 2, 8, 128, 32  # (f)
# (g) card vs CPU, f32: label -> (arch, layers at full width (an enc-dec model:
# both stacks) or None for REDUCED).
FAMILY_VS_CPU = {"qwen2-moe full width": ("qwen2-moe-a2.7b", 2),
                 "mamba2 full width": ("mamba2-2.7b", 2),
                 "whisper full width": ("whisper-medium", 2),
                 "qwen3-14b REDUCED": ("qwen3-14b", None),
                 "qwen3-32b REDUCED": ("qwen3-32b", None),
                 "grok-1 REDUCED": ("grok-1-314b", None)}
FAMILY_VS_CPU_STEPS = 16
ED_INVARIANT_BATCH, ED_INVARIANT_LEN = 2, 32
FAMILY_SERVE_RUNS = ("moe-serve", "grok-decode", "encdec-decode", "qwen3-decode")  # on swa_decode


def cut_stacks(cfg, layers):
    """``cut`` of both stacks of an enc-dec model, of the one stack
    otherwise."""
    if layers is None or cfg.family != "encdec":
        return cut(cfg, layers)
    return cfg.replace(n_layers=layers, n_enc_layers=layers)


def draw_batch(cfg, dev, g, batch, seq) -> dict:
    """Tokens (and an enc-dec model's frames, in its dtype), as
    ``launch/train`` production draws them."""
    out = {"tokens": torch.randint(0, cfg.vocab_size, (batch, seq), generator=g, device=dev,
                                   dtype=torch.int32)}
    if cfg.family == "encdec":
        out["audio_embeds"] = torch.randn((batch, cfg.n_audio_frames, cfg.d_model), generator=g,
                                          device=dev).to(cfg.dtype)
    return out


def moe_train(label, api, moe, cfg, dev, name, smi) -> dict:
    """(b) ``make_train_step`` of a MoE cut by depth, driven as
    ``launch/train`` production drives it (params from seed 0, a fresh
    batch a step from the run's generator, the loss read back): ms a step
    after the first, tokens/s, peak memory, finite losses, and the router
    aux (summed over the layers) of a forward on the last batch."""
    torch.cuda.empty_cache()
    g = torch.Generator(device=dev).manual_seed(0)
    params = api.init_params(g, cfg)
    step = api.make_train_step(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms = [], []
    for _ in range(MOE_TRAIN_STEPS):
        batch = draw_batch(cfg, dev, g, MOE_TRAIN_BATCH, MOE_TRAIN_SEQ)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, loss = step(params, batch)
        losses.append(float(loss))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    with torch.no_grad():
        aux = float(moe.forward(params, batch, cfg)[1])
    check(all(math.isfinite(x) for x in losses) and math.isfinite(aux),
          f"{label}: non-finite losses {losses} or aux {aux}")
    ms = sum(step_ms[1:]) / len(step_ms[1:])
    tokens = MOE_TRAIN_BATCH * MOE_TRAIN_SEQ
    cap = moe.capacity(cfg, min(moe.MOE_GROUP, tokens))
    print(f"  {label}: {cfg.name} at full width, {cfg.n_layers} layers {cfg.dtype} remat, batch "
          f"{MOE_TRAIN_BATCH} x {MOE_TRAIN_SEQ} (capacity {cap}), {MOE_TRAIN_STEPS} steps: "
          f"{ms:.1f} ms a step after the first ({step_ms[0]:.1f} ms), "
          f"{tokens / (ms / 1e3):.0f} tokens/s, peak {peak_gib:.2f} GiB, losses "
          f"{[round(x, 4) for x in losses]}, router aux {aux:.4f}  on {name} ({smi})")
    del params
    torch.cuda.empty_cache()
    return dict(layers=cfg.n_layers, capacity=cap, losses=losses, step_ms=step_ms,
                ms_per_step=ms, tokens_per_s=tokens / (ms / 1e3), peak_gib=peak_gib,
                router_aux=aux)


def forward_prefill(label, api, cfg, dev, batch, seq, stepped, name, smi) -> dict:
    """``make_prefill_step`` of ``cfg`` (seed-0 weights and inputs on the
    card) at batch x seq: ms a call (3 calls after a first), prompt
    tokens/s and peak memory, beside ``stepped``, the ``lm_serve`` run's
    token-stepped prefill."""
    torch.cuda.empty_cache()
    g = torch.Generator(device=dev).manual_seed(0)
    params = api.init_params(g, cfg)
    inputs = draw_batch(cfg, dev, g, batch, seq)
    prefill = api.make_prefill_step(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(4):
        t0 = time.perf_counter()
        h = prefill(params, inputs)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    check(h.shape == (batch, cfg.d_model) and bool(torch.isfinite(h.float()).all()),
          f"{label}: bad last hidden state")
    ms = sum(times[1:]) / len(times[1:])
    tok_s = batch * seq / (ms / 1e3)
    print(f"  {label}: {cfg.name} {cfg.dtype}, batch {batch} x {seq}: make_prefill_step "
          f"{ms:.2f} ms ({tok_s:.0f} prompt tokens/s; first call {times[0]:.1f} ms), peak "
          f"{peak_gib:.2f} GiB; token-stepped prefill of {stepped['batch']} x "
          f"{stepped['prompt_len']}: {stepped['prefill_s'] * 1e3:.1f} ms "
          f"({stepped['prefill_tok_s']:.0f} tokens/s)  on {name} ({smi})")
    del params
    torch.cuda.empty_cache()
    return dict(batch=batch, seq=seq, ms=ms, first_ms=times[0], prompt_tok_s=tok_s,
                peak_gib=peak_gib, token_stepped_tok_s=stepped["prefill_tok_s"])


def cross_kv_prepare(encdec, cfg, dev, batch):
    """``lm_serve``'s ``prepare`` for an enc-dec model: random frames
    (seed 3 on the card) through the encoder into every layer's cross K/V
    (``precompute_cross_kv``)."""
    def prepare(params, cache):
        g = torch.Generator(device=dev).manual_seed(3)
        audio = torch.randn((batch, cfg.n_audio_frames, cfg.d_model), generator=g,
                            device=dev).to(cfg.dtype)
        with torch.no_grad():
            ck, cv = encdec.precompute_cross_kv(params, encdec.encode(params, audio, cfg), cfg)
        return cache._replace(cross_k=ck, cross_v=cv)
    return prepare


def encdec_invariant(api, encdec, cfg, dev, name, smi) -> dict:
    """(g) On the card, f32: teacher-forced decode from the cross K/V of
    ``precompute_cross_kv`` gives the full-sequence forward's logits (its
    last hidden states through the tied embedding) at every position,
    within ``LM_GATE`` of the largest."""
    g = torch.Generator(device=dev).manual_seed(4)
    params = api.init_params(g, cfg)
    batch = draw_batch(cfg, dev, g, ED_INVARIANT_BATCH, ED_INVARIANT_LEN)
    with torch.no_grad():
        want = encdec.forward(params, batch, cfg) @ params.embed.T
        ck, cv = encdec.precompute_cross_kv(
            params, encdec.encode(params, batch["audio_embeds"], cfg), cfg)
    cache = api.init_cache(cfg, ED_INVARIANT_BATCH, ED_INVARIANT_LEN, device=dev)
    cache = cache._replace(cross_k=ck, cross_v=cv)
    step = api.make_serve_step(cfg)
    worst = 0.0
    for t in range(ED_INVARIANT_LEN):
        cache, logits = step(params, cache, batch["tokens"][:, t:t + 1])
        w = want[:, t]
        worst = max(worst, float((logits[:, 0] - w).abs().max() / w.abs().max()))
    check(worst <= LM_GATE, f"encdec invariant: decode vs forward {worst:.3e} > {LM_GATE}")
    print(f"  encdec invariant ({cfg.name}, {cfg.n_enc_layers} + {cfg.n_layers} layers d="
          f"{cfg.d_model} {cfg.dtype}, batch {ED_INVARIANT_BATCH}, {ED_INVARIANT_LEN} positions, "
          f"{cfg.n_audio_frames} frames): decode after precompute_cross_kv vs forward max "
          f"|dlogit| / max |logit| {worst:.3e} (gate {LM_GATE})  on {name} ({smi})")
    del params, cache, ck, cv
    torch.cuda.empty_cache()
    return dict(max_rel_logit_diff=worst, positions=ED_INVARIANT_LEN, layers=cfg.n_layers)


def lm_family_phase(mods, dev, name, smi) -> dict:
    """Phase 22: the moe, ssm and encdec families and qwen3; (a)-(g) of
    the module docstring."""
    train, configs, api, layers, serve, swa, kref, sgd, moe, encdec = mods
    out = {}
    full = configs.get(MOE_ARCH)
    run = lm_serve("moe-serve", api, serve, swa, kref, full, dev, MOE_BATCH, MOE_PROMPT, MOE_NEW,
                   name, smi)
    want = full.n_layers * (MOE_PROMPT + MOE_NEW)
    check(run["launches"] == want, f"moe-serve: {run['launches']} swa_decode launches, "
          f"expected {want}")
    out["moe-serve"] = run
    out["moe-train"] = moe_train("moe-train", api, moe, cut(full, MOE_TRAIN_LAYERS), dev, name,
                                 smi)
    gcfg = cut(configs.get(GROK_ARCH), GROK_LAYERS)
    run = lm_serve("grok-decode", api, serve, swa, kref, gcfg, dev, GROK_BATCH, GROK_PROMPT,
                   GROK_NEW, name, smi)
    want = GROK_LAYERS * (GROK_PROMPT + GROK_NEW)
    check(run["launches"] == want, f"grok-decode: {run['launches']} swa_decode launches, "
          f"expected {want}")
    out["grok-decode"] = run

    out["ssm-train"] = train_run("ssm-train", train, SSM_ARCH, name, smi)
    scfg = configs.get(SSM_ARCH)
    run = lm_serve("ssm-decode", api, serve, swa, kref, scfg, dev, SSM_BATCH, SSM_PROMPT,
                   SSM_NEW, name, smi)
    check(run["launches"] == 0, "ssm-decode launched swa_decode")
    out["ssm-decode"] = run
    out["ssm-prefill"] = forward_prefill("ssm-prefill", api, scfg, dev, SSM_PREFILL_BATCH,
                                         SSM_PREFILL_SEQ, run, name, smi)

    out["encdec-train"] = train_run("encdec-train", train, ED_ARCH, name, smi, argv=ED_TRAIN)
    ecfg = configs.get(ED_ARCH)
    run = lm_serve("encdec-decode", api, serve, swa, kref, ecfg, dev, ED_BATCH, ED_PROMPT, ED_NEW,
                   name, smi, prepare=cross_kv_prepare(encdec, ecfg, dev, ED_BATCH))
    want = ecfg.n_layers * (ED_PROMPT + ED_NEW)
    check(run["launches"] == want, f"encdec-decode: {run['launches']} swa_decode launches, "
          f"expected {want}")
    out["encdec-decode"] = run
    out["encdec-prefill"] = forward_prefill("encdec-prefill", api, ecfg, dev, ED_BATCH,
                                            ED_PROMPT, run, name, smi)

    qcfg = cut(configs.get(QWEN3_ARCH), QWEN3_LAYERS)
    run = lm_serve("qwen3-decode", api, serve, swa, kref, qcfg, dev, QWEN3_BATCH, QWEN3_PROMPT,
                   QWEN3_NEW, name, smi)
    want = QWEN3_LAYERS * (QWEN3_PROMPT + QWEN3_NEW)
    check(run["launches"] == want, f"qwen3-decode: {run['launches']} swa_decode launches, "
          f"expected {want}")
    out["qwen3-decode"] = run

    vs_cpu = {}
    for label, (arch, lay) in FAMILY_VS_CPU.items():
        cfg = cut_stacks(configs.get(arch, reduced=lay is None), lay).replace(
            dtype=torch.float32, learning_rate=TRAIN_VS_CPU_LR)
        fam = moe if cfg.family == "moe" else None
        res = {"train": train_card_vs_cpu(label, api, layers, sgd, cfg, dev, moe=fam),
               "decode": card_vs_cpu(label, api, layers, swa, cfg, dev, 2, FAMILY_VS_CPU_STEPS,
                                     gate=True, moe=fam)}
        want = 0 if cfg.family == "ssm" else cfg.n_layers * FAMILY_VS_CPU_STEPS
        check(res["decode"]["launches"] == want,
              f"{label}: {res['decode']['launches']} swa_decode launches, expected {want}")
        vs_cpu[label] = res
    out["card_vs_cpu"] = vs_cpu
    out["encdec_invariant"] = encdec_invariant(
        api, encdec, cut_stacks(ecfg, 2).replace(dtype=torch.float32), dev, name, smi)
    return out


# --- phase 23: launch-tooling: the examples, sgd.adam, the dry run beside the card ----

EXAMPLE_ARGV = {"quickstart": [], "train_iout_hfl": [], "serve_anomaly": [],
                "load_replay": ["--duration", "4", "--int8"]}     # the reference's defaults
EXAMPLE_KERNELS = {"quickstart": ("local_train_f32", "fused_agg"),
                   "train_iout_hfl": ("local_train_f32", "fused_agg"),
                   "serve_anomaly": ("local_train_f32", "fused_agg", "fused_score_f32"),
                   "load_replay": ("fused_score_f32", "fused_score_q8")}
ADAM_STEPS, ADAM_GATE = 3, 1e-6     # card vs CPU, each leaf within 1e-6 of its largest value


def run_example(label, mod, argv, counters, dev, workdir) -> tuple[dict, dict]:
    """``mod.main(argv)`` on the card, every counter zeroed just before and
    read just after; returns (its result, the launches of each kernel)."""
    if label in ("train_iout_hfl", "serve_anomaly"):
        argv = argv + ["--ckpt-dir", str(workdir / label)]
    for _, reset in counters.values():
        reset()
    t0 = time.perf_counter()
    out = mod.main(argv, device=dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = {k: c[k] for k, (c, _) in counters.items()}
    for k in EXAMPLE_KERNELS[label]:
        check(counts[k] > 0, f"{label}: {k} was not launched")
    return out, dict(launches=counts, seconds=seconds)


def examples_phase(examples, counters, dev, name, smi, workdir) -> dict:
    """(a): the four examples at the reference's defaults on the card."""
    res = {}
    out, info = run_example("quickstart", examples["quickstart"], EXAMPLE_ARGV["quickstart"],
                            counters, dev, workdir)
    check(tuple(out) == ("fedavg", "hfl-nocoop", "hfl-selective", "hfl-nearest"),
          f"quickstart: methods {tuple(out)}")
    for m, r in out.items():
        check(0.0 <= r.f1 <= 1.0 and 0.0 < r.participation <= 1.0 and math.isfinite(r.e_total),
              f"quickstart: {m} f1 {r.f1} participation {r.participation} e_total {r.e_total}")
    res["quickstart"] = dict(info, methods={m: dict(f1=r.f1, participation=r.participation,
                                                     e_total=r.e_total, e_f2f=r.e_f2f)
                                             for m, r in out.items()})
    out, info = run_example("train_iout_hfl", examples["train_iout_hfl"],
                            EXAMPLE_ARGV["train_iout_hfl"], counters, dev, workdir)
    check(len(out["rounds"]) == 10 and all(math.isfinite(r["loss"]) for r in out["rounds"]),
          f"train_iout_hfl: rounds {out['rounds']}")
    check(len(out["checkpoints"]) == 2 and 0.0 <= out["f1"] <= 1.0,
          f"train_iout_hfl: checkpoints {out['checkpoints']}, PA-F1 {out['f1']}")
    res["train_iout_hfl"] = dict(info, source=out["source"], pa_f1=out["f1"],
                                 last_loss=out["rounds"][-1]["loss"],
                                 participation=out["rounds"][-1]["participation"])
    out, info = run_example("serve_anomaly", examples["serve_anomaly"],
                            EXAMPLE_ARGV["serve_anomaly"], counters, dev, workdir)
    check(out["swapped"] is True and out["service"]["swaps"] >= 1,
          f"serve_anomaly: swapped {out['swapped']}, swaps {out['service']['swaps']}")
    check(out["mean_abs_error_shift"] > 0.0 and 0.0 <= out["f1"] <= 1.0,
          f"serve_anomaly: error shift {out['mean_abs_error_shift']}, f1 {out['f1']}")
    res["serve_anomaly"] = dict(info, swaps=out["service"]["swaps"], f1=out["f1"],
                                served_round=out["served_round"],
                                compiles=out["service"]["compiles"])
    out, info = run_example("load_replay", examples["load_replay"], EXAMPLE_ARGV["load_replay"],
                            counters, dev, workdir)
    for key in ("fixed", "adaptive_bucketed", "adaptive_bucketed_int8"):
        check(out[key]["completed"] == out["trace"]["n_events"],
              f"load_replay {key}: {out[key]['completed']} of {out['trace']['n_events']} done")
    res["load_replay"] = dict(info, p99_speedup=out["p99_speedup"], **{
        f"{k}_p99_ms": out[k]["e2e_p99_ms"]
        for k in ("fixed", "adaptive_bucketed", "adaptive_bucketed_int8")})
    for label, r in res.items():
        fields = {k: v for k, v in r.items() if k not in ("launches", "seconds", "methods")}
        print(f"  {label}: {r['seconds']:.2f} s, launches "
              f"{ {k: n for k, n in r['launches'].items() if n} }, {json.dumps(fields)}"
              f"  on {name} ({smi})")
    for m, r in res["quickstart"]["methods"].items():
        print(f"    quickstart {m:14s} F1 {r['f1']:.3f}  participation {r['participation']:.2f}"
              f"  E_total {r['e_total']:.3f} J (f2f {r['e_f2f']:.3f})")
    return res


def adam_on_card(sgd, configs, api, dev) -> dict:
    """(b): ``sgd.adam`` steps on the card and on the CPU from the same f32
    tree (llama3-8b REDUCED) and normal gradients: each leaf within
    ``ADAM_GATE`` of its largest magnitude."""
    cfg = configs.get("llama3-8b", reduced=True).replace(dtype=torch.float32)
    g = torch.Generator().manual_seed(23)
    cpu = api.init_params(g, cfg)
    from repro_torch.models.layers import map_leaves
    grads = [map_leaves(lambda t: torch.randn(t.shape, generator=g), cpu)
             for _ in range(ADAM_STEPS)]
    gpu = map_leaves(lambda t: t.to(dev), cpu)
    sc, sg = sgd.adam_init(cpu), sgd.adam_init(gpu)
    for gr in grads:
        cpu, sc = sgd.adam(cpu, gr, sc, 1e-2, weight_decay=0.01)
        gpu, sg = sgd.adam(gpu, map_leaves(lambda t: t.to(dev), gr), sg, 1e-2, weight_decay=0.01)
    torch.cuda.synchronize()
    worst = max(float((b.cpu() - a).abs().max()) / float(a.abs().max())
                for a, b in zip(sgd.tree_leaves(cpu), sgd.tree_leaves(gpu)))
    check(worst <= ADAM_GATE and int(sg.count) == ADAM_STEPS,
          f"adam: card vs CPU {worst:.3e} of the largest value (gate {ADAM_GATE})")
    n = sum(t.numel() for t in sgd.tree_leaves(cpu))
    print(f"  adam: {ADAM_STEPS} steps of {n:,} f32 params, card vs CPU max |diff| / max |p| "
          f"{worst:.3e} (gate {ADAM_GATE})")
    return dict(steps=ADAM_STEPS, params=n, max_rel_err=worst)


def dryrun_vs_card(label, dryrun, roofline, cfg, shape, run, step_ms, peak_bytes, name, smi):
    """(c): the dry run of one card cell on a one-chip plan against that
    cell's own run: the params' bytes exactly; the planned peak beside the
    measured one; the roofline's bound beside the measured step."""
    from repro_torch.launch.mesh import PEAK_FLOPS_BF16, make_host_mesh
    rec = dryrun.dryrun_one(cfg.name, label, cfg=cfg, shape=shape, mesh=make_host_mesh())
    row = roofline.analyse(rec)
    check(rec["param_bytes"] == run["param_bytes"],
          f"{label}: dry run {rec['param_bytes']:,} param bytes, the card held "
          f"{run['param_bytes']:,}")
    step_s = step_ms / 1e3
    out = dict(param_bytes=rec["param_bytes"], dryrun_s=rec["compile_s"], flops=rec["flops"],
               bytes_accessed=rec["bytes_accessed"], peak_bytes=rec["memory"]["peak_bytes"],
               measured_peak_bytes=peak_bytes, bound_s=row["bound_s"], dominant=row["dominant"],
               t_compute_s=row["t_compute_s"], t_memory_s=row["t_memory_s"], peak=row["peak"],
               model_flops=rec["model_flops"], useful_ratio=row["useful_ratio"],
               step_s=step_s, bound_share=row["bound_s"] / step_s,
               model_flop_share=rec["model_flops"] / (step_s * PEAK_FLOPS_BF16))
    print(f"  {label}: dry run ({rec['compile_s']} s on the host) {rec['param_bytes']:,} param "
          f"bytes = the card's; peak {rec['memory']['peak_bytes'] / 2 ** 30:.2f} GiB planned, "
          f"{peak_bytes / 2 ** 30:.2f} GiB max_memory_allocated; {rec['flops']:.4e} FLOP, "
          f"{rec['bytes_accessed']:.4e} bytes (unfused); roofline bound {row['bound_s'] * 1e3:.3f}"
          f" ms ({row['dominant']}; compute {row['t_compute_s'] * 1e3:.3f} ms at {row['peak']}, "
          f"memory {row['t_memory_s'] * 1e3:.3f} ms) against {step_ms:.3f} ms measured: share "
          f"{out['bound_share']:.3f}; model-FLOP share {out['model_flop_share']:.4f} "
          f"(model FLOPs {rec['model_flops']:.4e})  on {name} ({smi})")
    return out


def example_launches(tooling, kname) -> int:
    """``kname``'s launches over phase 23's four examples."""
    return sum(r["launches"].get(kname, 0) for r in tooling["examples"].values())


def launch_tooling_phase(mods, counters, lm, families, dev, name, smi, workdir) -> dict:
    """Phase 23: (a)-(c) of the module docstring."""
    examples, sgd, configs, api, dryrun, roofline, shape_config = mods
    t0 = time.perf_counter()
    out = {"examples": examples_phase(examples, counters, dev, name, smi, workdir),
           "adam": adam_on_card(sgd, configs, api, dev)}
    dense = configs.get(DENSE_TRAIN_ARCH)
    shape = dict(zip(TRAIN_FULL[1::2], TRAIN_FULL[2::2]))
    run = lm["dense-train"]
    out["dense-train"] = dryrun_vs_card(
        "dense-train", dryrun, roofline, dense,
        shape_config("dense-train", int(shape["--seq"]), int(shape["--batch"]), "train"),
        run, run["ms_per_step"], run["peak_gib"] * 2 ** 30, name, smi)
    run = families["grok-decode"]
    out["grok-decode"] = dryrun_vs_card(
        "grok-decode", dryrun, roofline, cut(configs.get(GROK_ARCH), GROK_LAYERS),
        shape_config("grok-decode", GROK_PROMPT + GROK_NEW + 1, GROK_BATCH, "decode"),
        run, run["decode_step_ms"], run["peak_mib"] * 2 ** 20, name, smi)
    out["seconds"] = time.perf_counter() - t0
    print(f"  phase 23 took {out['seconds']:.1f} s")
    return out


# --- phase 24: sweep-200, Engine.sweep's shape classes as one call each ----------

SWEEP_SEEDS = (0, 1)                        # (a), (b): 2 seeds x 1 deployment a cell
SWEEP_PHYSICS = tuple((w, s, e) for w in (3.0, 8.0) for s in (0.2, 0.7) for e in (0.25, 0.4))
SWEEP_ROBUST = tuple((r, b, p) for r in ("mean", "trimmed", "median") for b in (0.0, 0.25)
                     for p in (0.0, 0.3))   # robustness_bench's attack grid
SWEEP_AUDIT_METHODS = ("hfl-nocoop", "hfl-selective", "hfl-nearest", "fedprox")
SWEEP_AUDIT_SEEDS = (0, 1, 2)               # fig6_energy's N = 200 audit
SWEEP_COUNTS = (("participation", "sensor-rounds"), ("coop_links", "rounds"),
                ("erased_total", None), ("nonfinite_total", None), ("nonfinite_rounds", None),
                ("merges", None))


def hold_cell(got, want, label, n, t, loose, chaotic=False) -> dict:
    """A sweep cell's (S, P) metrics against its own Engine call's:
    counters exactly (participation as sensor-rounds, links as a count a
    round), energies rtol=1e-5, losses rtol=1e-4 and F1 within 1e-3, or
    1% and 0.02 for the async and robust cells (``loose``: their fog sums
    add in no fixed order on the card).  A ``chaotic`` cell (the mean
    reduce under Gaussian colluders, whose model diverges) has its losses
    and F1 recorded, not gated: a sum over a larger trial axis reduces in
    another order on the card, and the divergence amplifies that one-ulp
    difference.  Returns the worst differences."""
    worst = {}
    for key, per in SWEEP_COUNTS:
        if key not in want:
            continue
        scale = {"sensor-rounds": n * t, "rounds": t, None: 1}[per]
        check(torch.equal(torch.round(got[key].double() * scale),
                          torch.round(want[key].double() * scale)),
              f"{label}: {key} {got[key].tolist()} vs {want[key].tolist()}")
    for key in ("e_total", "e_s2f", "e_f2f", "e_f2g"):
        a, b = got[key].double(), want[key].double()
        rel = float(((a - b).abs() / b.abs().clamp_min(1e-30)).max())
        check(rel <= 1e-5, f"{label}: {key} differs by {rel:.3e} (rtol 1e-5)")
        worst[key] = rel
    if "losses" in want:
        a, b = got["losses"].double(), want["losses"].double()
        tag = "chaotic " if chaotic else ""
        worst[tag + "losses"] = float(((a - b).abs() / b.abs()).max())
        worst[tag + "f1"] = float((got["f1"] - want["f1"]).abs().max())
        if not chaotic:
            check(worst["losses"] <= (0.01 if loose else 1e-4),
                  f"{label}: losses differ by {worst['losses']:.3e}")
            check(worst["f1"] <= (0.02 if loose else 1e-3),
                  f"{label}: F1 differs by {worst['f1']:.3e}")
    return worst


def sweep_part(eng, label, method, cfgs, seeds, run_one, counters, n, t, loose, dev, name, smi,
               ds=None, family="run", record=None, chaotic=()) -> dict:
    """One part of phase 24: ``Engine.sweep`` over ``cfgs`` on the card,
    every count zeroed just before it and read just after, then each cell
    by its own Engine call (``run_one(i)``) one after another: every
    class's launches must equal one of its cells', and every cell its own
    call's metrics (:func:`hold_cell`; the cells in ``chaotic`` also run
    twice, to show the card repeats a call bitwise).  Then the sweep once
    more, timed against the cells (the first call bears the warm-up), and
    once under torch.profiler for the device idle share.  ``record`` (a
    :class:`KernelCalls`) keeps the first sweep's kernel inputs."""
    def sweep():
        return eng.sweep(method, cfgs, seeds, ds, family=family)

    start = time.perf_counter()
    for _, reset in counters.values():
        reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if record is not None:
        with record:
            sw = sweep()
    else:
        sw = sweep()
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    logs = eng.take_log()
    check(len(logs) == sw.n_classes, f"{label}: {len(logs)} calls for {sw.n_classes} classes")
    total = {k: launches_of[k] for k, (launches_of, _) in counters.items() if launches_of[k]}
    check(sum(sum(e["launches"].values()) for e in logs) == sum(total.values()),
          f"{label}: the Engine's log disagrees with the launch counters {total}")
    class_of = {i: c for c, info in enumerate(sw.classes) for i in info["indices"]}
    cells_s, cells_call_s, worst = 0.0, 0.0, {}
    for i in range(len(cfgs)):
        for _, reset in counters.values():
            reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = run_one(i)
        torch.cuda.synchronize()
        cells_s += time.perf_counter() - t0
        (one,) = eng.take_log()
        cells_call_s += one["wall_s"]
        check(logs[class_of[i]]["launches"] == one["launches"],
              f"{label}: class {class_of[i]} launched {logs[class_of[i]]['launches']}, its cell "
              f"{i} alone {one['launches']}")
        got = sw.cell(i)
        check(all(bool(torch.isfinite(v).all()) for v in got.values()),
              f"{label} cell {i}: non-finite metrics")
        check(got["e_total"].device == dev, f"{label} did not run on the card")
        for k, v in hold_cell(got, want, f"{label} cell {i}", n, t, loose,
                              i in chaotic).items():
            worst[k] = max(worst.get(k, 0.0), v)
        if i in chaotic:
            again = run_one(i)
            eng.take_log()
            worst["chaotic cell run twice, max |dloss|"] = max(
                worst.get("chaotic cell run twice, max |dloss|", 0.0),
                float((again["losses"] - want["losses"]).abs().max()))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sweep()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    call_s = sum(e["wall_s"] for e in eng.take_log())   # the calls, without the host's draws
    dev_ms, ops = device_ms(sweep, 1, warm=False, host=False)   # the timed call warmed it
    eng.take_log()
    trials = len(cfgs) * len(seeds)
    out = dict(cells=len(cfgs), classes=[list(c["indices"]) for c in sw.classes],
               knobs=[c["knobs"] for c in sw.classes], trials=trials,
               launches_per_class=[e["launches"] for e in logs], first_call_s=first,
               sweep_s=wall, cells_one_after_another_s=cells_s, speedup=cells_s / wall,
               calls_s=call_s, cells_calls_s=cells_call_s, calls_speedup=cells_call_s / call_s,
               trial_round_ms=wall * 1e3 / (trials * t),
               call_trial_round_ms=call_s * 1e3 / (trials * t), device_ms=dev_ms,
               device_ops=ops, idle_share=max(0.0, 1.0 - dev_ms / (wall * 1e3)),
               call_idle_share=max(0.0, 1.0 - dev_ms / (call_s * 1e3)), worst=worst,
               part_s=time.perf_counter() - start)
    print(f"  {label}: {len(cfgs)} cells x {len(seeds)} seeds in {sw.n_classes} class(es) "
          f"{out['classes']} (knobs {out['knobs']}), one call each: {wall:.3f} s (first call "
          f"{first:.3f} s) against "
          f"{cells_s:.3f} s cell by cell by Engine.{'run' if family == 'run' else 'audit'} "
          f"(x{out['speedup']:.2f}); the Engine calls alone (the host's draws of the "
          f"trials' inputs left out) {call_s:.3f} s against {cells_call_s:.3f} s "
          f"(x{out['calls_speedup']:.2f}); {out['trial_round_ms']:.3f} ms per trial-"
          f"{'event' if method == 'hfl-async' else 'round'} ({out['call_trial_round_ms']:.3f} in "
          f"the call); device {dev_ms:.1f} ms in {ops} ops, idle share "
          f"{out['idle_share']:.3f} ({out['call_idle_share']:.3f} of the call); launches per class "
          f"{out['launches_per_class']} (one cell's each)  on {name} ({smi})")
    print(f"    every cell vs its own call: counters equal; max rel "
          + ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
          + f"; the part took {out['part_s']:.1f} s")
    return out


def sweep_phase(mods, train_ds, counters, dev, name, smi) -> dict:
    """Phase 24: sweep-200.  ``Engine.sweep`` at train-200's width (N =
    200, M = 20, window 256, E = 5, batch 32, T = 20, rho_s 0.05 int8),
    each shape class one batched call: (a) a physics grid (wind x
    shipping x eta_ea, 8 cells x seeds 0-1: one class of B = 16, 3,200
    clients a ``local_train_f32`` launch); (b) ``robustness_bench``'s
    attack grid (mean / trimmed 0.45 / median x byz_frac 0, 0.25 x
    erasure 0, 0.3, gauss x 20; 3 classes of 4 cells, B = 8); (c)
    ``fig6_energy``'s N = 200 audit (hfl-nocoop, hfl-selective,
    hfl-nearest, fedprox x compressed / dense, a method and a payload per
    cell, seeds 0-2: one class); (d) phase 19's three async staleness
    cells at ``ASYNC_TIME_EVENTS`` events (seeds 0-2, one class; phase 19
    holds their 60-event sweep, one call too, to sequential trials).  Every class launches as one cell does,
    every cell equals its own ``Engine.run`` / ``Engine.audit``, and the
    folded calls' own ``local_train_f32``, ``fused_agg`` and
    ``robust_agg`` inputs (one round of (a) and of (b)) are held to the
    plain versions (:func:`check_recorded_kernels`); the seconds of each
    sweep against its cells one after another, ms per trial-round and the
    device idle share are recorded."""
    Engine, exp, async_fl, ch, en, FaultConfig, comp, lt, fa, ra, kref, ae = mods
    cfg = exp.make_config(TRAIN_N, TRAIN_FOG, ROUNDS)
    eng = Engine()
    eng.take_log()
    out = {}

    physics = [cfg.replace(channel=ch.ChannelParams(wind_m_s=w, shipping=s),
                           energy=en.EnergyParams(eta_ea=e)) for w, s, e in SWEEP_PHYSICS]
    rec_a = KernelCalls(lt, fa, ra)
    out["physics"] = sweep_part(
        eng, "(a) physics grid", "hfl-selective", physics, SWEEP_SEEDS,
        lambda i: eng.run("hfl-selective", physics[i], SWEEP_SEEDS, train_ds).metrics,
        counters, TRAIN_N, ROUNDS, False, dev, name, smi, ds=train_ds, record=rec_a)
    check(out["physics"]["launches_per_class"] == [{"local_train_f32": ROUNDS,
                                                    "fused_agg": 2 * ROUNDS}],
          f"(a) launched {out['physics']['launches_per_class']}")
    out["physics"]["kernel_checks"] = check_recorded_kernels(rec_a.calls, kref, ra, ae, dev,
                                                             "(a) the physics class")

    robust = [cfg.replace(robust=r, trim_frac=ROBUST_TRIM if r == "trimmed" else 0.0,
                          faults=FaultConfig(erasure_prob=p, byz_frac=b, byz_scale=20.0,
                                             byz_mode="gauss"))
              for r, b, p in SWEEP_ROBUST]
    rec_b = KernelCalls(lt, fa, ra)
    out["robust"] = sweep_part(
        eng, "(b) attack grid", "hfl-selective", robust, SWEEP_SEEDS,
        lambda i: eng.run("hfl-selective", robust[i], SWEEP_SEEDS, train_ds).metrics,
        counters, TRAIN_N, ROUNDS, True, dev, name, smi, ds=train_ds, record=rec_b,
        chaotic=tuple(i for i, (r, b, _) in enumerate(SWEEP_ROBUST) if r == "mean" and b > 0))
    check(len(out["robust"]["classes"]) == 3 and all(
        e.get("robust_agg", 0) == (ROUNDS if i else 0)
        for i, e in enumerate(out["robust"]["launches_per_class"])),
        f"(b) classes {out['robust']['classes']}, launches {out['robust']['launches_per_class']}")
    first_of = {}      # the first robust_agg call of each robust class
    for call in rec_b.calls["robust_aggregate_blocks"]:
        first_of.setdefault(call[1][-1], call)
    rec_b.calls["robust_aggregate_blocks"] = list(first_of.values())
    out["robust"]["kernel_checks"] = check_recorded_kernels(rec_b.calls, kref, ra, ae, dev,
                                                            "(b) the attack grid")

    compressed, dense = comp.CompressorConfig(rho_s=0.05, quant_bits=8), comp.CompressorConfig(
        rho_s=1.0, quant_bits=32)
    audit = [(m, cfg.replace(compressor=c)) for m in SWEEP_AUDIT_METHODS
             for c in (compressed, dense)]
    methods = [m for m, _ in audit]
    out["audit"] = sweep_part(
        eng, "(c) energy audit", methods, [c for _, c in audit], SWEEP_AUDIT_SEEDS,
        lambda i: eng.audit(methods[i], audit[i][1], SWEEP_AUDIT_SEEDS),
        counters, TRAIN_N, ROUNDS, False, dev, name, smi, family="audit")
    check(len(out["audit"]["classes"]) == 1, f"(c) split into {out['audit']['classes']}")

    cells = [async_cell(async_fl, cfg, a, f, n_events=ASYNC_TIME_EVENTS) for a, f in ASYNC_CELLS]
    out["async"] = sweep_part(
        eng, "(d) async staleness", "hfl-async", cells, ASYNC_SEEDS,
        lambda i: eng.run("hfl-async", cells[i], ASYNC_SEEDS, train_ds).metrics,
        counters, TRAIN_N, ASYNC_TIME_EVENTS, True, dev, name, smi, ds=train_ds)
    check(out["async"]["launches_per_class"] == [{"local_train_f32": ASYNC_TIME_EVENTS,
                                                  "fused_agg": 2 * ASYNC_TIME_EVENTS}],
          f"(d) launched {out['async']['launches_per_class']}")
    return out


# --- phase 25: data-axis: data-parallel production training, in-pod data ranks ------

DATA_WORLD = 2                  # (a), (b), (d): two gloo ranks sharing the one card
DATA_TIMEOUT_S = 420.0          # the ranks of (a), (b) and (d)
DATA_TRAIN_STEPS = 3            # (a) hybrid-train, uncut, as the ranks
DATA_TRAIN = ["--full", "--steps", str(DATA_TRAIN_STEPS), "--batch", "4", "--seq", "512"]
# (a)'s losses against phase 21's one-process hybrid-train (TRAIN_FULL: the
# same seed, hence the same weights and batches).  A rank's forward is the
# same bf16 arithmetic on half the rows, so a loss moves only where a GEMM on
# 1,024 rows accumulates in another order than on 2,048 and a bf16 output
# rounds to its neighbour (at most 2^-8 of it); the update is the same
# formula of f32-summed gradients.  The loss, a mean over 2,048 tokens of
# such outputs, stays within one bf16 ulp (2^-8) relative.
DATA_LOSS_GATE = 2.0 ** -8
DATA_F32_LAYERS = 3             # (b) recurrentgemma-2b at TRAIN_VS_CPU's cut, f32
DATA_MOE_ARCH, DATA_MOE_LAYERS, DATA_MOE_BATCH, DATA_MOE_SEQ = "qwen2-moe-a2.7b", 2, 8, 512
DATA_GRAD_GATE, DATA_UPDATE_GATE = 1e-4, 1e-4   # (b), (d): the train-step rule
# (d) takes lr 1e-1: a MoE's gradients are small enough that at 1e-2 one f32
# ulp of |p| comes near 1e-4 of its largest update (1.2e-4 at REDUCED on the
# CPU), and the rule is there to measure the step, not the params' rounding.
DATA_MOE_LR = 1e-1
DATA_SPLIT_BATCH, DATA_SPLIT_SEQ = 2, 1024      # (e) one row a rank: a group over both
# (e) runs at capacity 0.25 (34 slots an expert against 136.5 selections on
# average): most selections are dropped, so which of a rank's tokens keep a
# slot rests on its places in the group's queue after the other rank's.
DATA_SPLIT_CAPACITY = 0.25
DATA_POD_WORLD, DATA_POD_DATA = 4, 2            # (c) 2 pods x 2 data ranks, gloo, one card
DATA_FLIP_SHARE = 1e-3          # (c) neighbouring int8 codes: <= 1e-3 of a leaf's, or two
DIGEST_CHUNK = 1 << 26


def leaf_digests(sgd, params) -> list[int]:
    """One int64 a leaf that moves with any of its bits: the sum of its
    bit patterns (integers of the leaf's width) times position weights 1 ..
    65,521, in chunks on the leaf's device (the sum wraps alike on every
    rank).  Two ranks' leaves are the same bits when their digests are."""
    out = []
    for p in sgd.tree_leaves(params):
        bits = p.reshape(-1).view({2: torch.int16, 4: torch.int32}[p.element_size()])
        h = torch.zeros((), dtype=torch.int64, device=p.device)
        for s in range(0, bits.numel(), DIGEST_CHUNK):
            b = bits[s:s + DIGEST_CHUNK].to(torch.int64)
            h += (b * (torch.arange(s, s + b.numel(), device=p.device) % 65521 + 1)).sum()
        out.append(int(h))
    return out


def data_train_job(job, spec, mesh, dev) -> dict:
    """(a) ``launch/train.main`` production of ``job``'s arch and argv under
    the ranks' group (data-parallel over it), with every
    ``ClientMesh.mean_`` timed between two synchronisations: the losses,
    ms a step, ms a step in the reductions, this rank's peak memory and
    the digests of its last params."""
    from repro_torch.launch import sharding
    from repro_torch.launch import train
    from repro_torch.models import api
    from repro_torch.optim import sgd
    kept, spent, reduce_s = {}, [], []
    plain_make, plain_mean = api.make_train_step, sharding.ClientMesh.mean_

    def make(cfg, data=None):
        step = plain_make(cfg, data)

        def recorded(params, batch):
            n = len(spent)
            out = step(params, batch)
            reduce_s.append(sum(spent[n:]))
            kept["params"] = out[0]
            return out
        return recorded

    def timed_mean(self, t):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = plain_mean(self, t)
        torch.cuda.synchronize()
        spent.append(time.perf_counter() - t0)
        return out

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    api.make_train_step, sharding.ClientMesh.mean_ = make, timed_mean
    try:
        out = train.main(["production", "--arch", job[1], *job[2]])
    finally:
        api.make_train_step, sharding.ClientMesh.mean_ = plain_make, plain_mean
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    digests = leaf_digests(sgd, kept.pop("params"))
    torch.cuda.empty_cache()
    if mesh.rank == 0 and "a_done" in spec:
        Path(spec["a_done"]).touch()
    return dict(losses=out["losses"], step_ms=[x * 1e3 for x in out["step_s"]],
                reduce_ms=[x * 1e3 for x in reduce_s], reductions_per_step=len(spent) / len(
                    reduce_s), peak_gib=peak_gib, digests=digests, data_ranks=out["data_ranks"],
                tokens_per_s=out["tokens_per_s"], param_bytes=out["param_bytes"],
                seconds=time.perf_counter() - t0)


def data_step_job(job, spec, mesh, dev) -> dict:
    """(b), (d) One data-parallel ``make_train_step`` of ``job``'s config
    (weights from seed 1 on the card, tokens from seed 2) on this rank's
    rows, the f32 gradients it reduced kept (``ClientMesh.mean_``
    recorded); rank 0 then takes the one-process gradient and step on the
    whole batch and gives the largest differences relative to their
    largest coordinates.  With a MoE, the expert ids of each forward
    (``RouteRecorder``): this rank's over the mesh (a layer's routing
    follows the dispatch of the layers before it) and, on rank 0, the
    whole batch's in one process."""
    from repro_torch.launch import sharding
    from repro_torch.models import api
    from repro_torch.models import moe as moe_mod
    from repro_torch.optim import sgd
    _, cfg, b, s = job
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    params = api.init_params(torch.Generator(device=dev).manual_seed(1), cfg)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s), generator=torch.Generator(
        ).manual_seed(2), dtype=torch.int32).to(dev)}
    mine = {k: v[mesh.rows(b)] for k, v in batch.items()}
    out = {"ids": {}, "kept": {}}
    if cfg.family == "moe":
        with torch.no_grad():
            for key, part, data in (("rank", mine, mesh), ("whole", batch, None)):
                if key == "rank" or mesh.rank == 0:
                    with RouteRecorder(moe_mod) as rec:
                        moe_mod.forward(params, part, cfg, data)
                    out["ids"][key], out["kept"][key] = rec.ids, rec.kept
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reduced, plain_mean = [], sharding.ClientMesh.mean_

    def kept(self, t):
        reduced.append(plain_mean(self, t))
        return reduced[-1]

    sharding.ClientMesh.mean_ = kept
    try:
        new, step_loss = api.make_train_step(cfg, mesh)(params, mine)
    finally:
        sharding.ClientMesh.mean_ = plain_mean
    n = len(sgd.tree_leaves(params))
    grads = reduced[-1 - n:-1]     # (a MoE's aux means,) the leaves' means, the loss's
    out.update(step_loss=float(step_loss), digests=leaf_digests(sgd, new),
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    if mesh.rank == 0:
        want, want_loss = sgd.grad_and_value(api.loss_fn(cfg))(params, batch)
        pairs = list(zip(grads, sgd.tree_leaves(want)))
        out["grad_rel"] = (max(float((a - w).abs().max()) for a, w in pairs)
                           / max(float(w.abs().max()) for _, w in pairs))
        del pairs, want, grads
        want_new, _ = api.make_train_step(cfg)(params, batch)
        worst, biggest = 0.0, 0.0
        for p, n, w in zip(*(sgd.tree_leaves(t) for t in (params, new, want_new))):
            uw = w.float() - p.float()
            worst = max(worst, float(((n.float() - p.float()) - uw).abs().max()))
            biggest = max(biggest, float(uw.abs().max()))
        out.update(update_rel=worst / biggest, want_loss=float(want_loss))
        del want_new
    del params, new
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    return out


def pod_data_job(job, spec, mesh, dev) -> dict:
    """(c) ``pod_job`` over ``sharding.pod_data_mesh(DATA_POD_DATA)``."""
    from repro_torch.launch import sharding
    return pod_job(job, spec, sharding.pod_data_mesh(DATA_POD_DATA), dev)


MESH_JOBS.update({"data_train": data_train_job, "data_step": data_step_job,
                  "pod_data": pod_data_job})


def close_but_flips(got, want, step, share) -> int:
    """Coordinates of ``got`` more than 1e-5 from ``want``; each must be
    within one quantisation ``step`` (neighbouring int8 codes), and at most
    ``share`` of them or two."""
    diff = (got - want).abs()
    far = diff > 1e-5
    n = int(far.sum())
    check(bool((diff[far] <= 1.001 * step + 1e-5).all()),
          f"a coordinate {float(diff.max()):.3e} apart, beyond one step {step:.3e}")
    check(n <= max(2, share * got.numel()), f"{n} of {got.numel()} coordinates apart")
    return n


def data_parity_line(label, cfg, got, ranks, gated, extra="") -> None:
    """Print and gate (b) / (d): the ranks' params the same bits, the loss
    to rtol 1e-5 and the gradients and update at the train-step rule."""
    check(all(r["digests"] == ranks[0]["digests"] for r in ranks),
          f"{label}: the ranks' params differ")
    check(all(r["step_loss"] == ranks[0]["step_loss"] for r in ranks),
          f"{label}: the ranks' losses differ")
    rel = abs(got["step_loss"] - got["want_loss"]) / abs(got["want_loss"])
    if gated:
        check(rel <= 1e-5, f"{label}: loss {got['step_loss']} vs one process "
              f"{got['want_loss']} ({rel:.3e})")
        check(got["grad_rel"] <= DATA_GRAD_GATE, f"{label}: gradients {got['grad_rel']:.3e}")
        check(got["update_rel"] <= DATA_UPDATE_GATE, f"{label}: update {got['update_rel']:.3e}")
    print(f"  {label}: {cfg.name} at full width, {cfg.n_layers} layers f32, lr "
          f"{cfg.learning_rate:g}, {DATA_WORLD} ranks vs one process: ranks' params the same "
          f"bits; loss {got['step_loss']:.6f} vs {got['want_loss']:.6f} (rel {rel:.3e}), "
          f"gradients {got['grad_rel']:.3e}, update {got['update_rel']:.3e} of their largest"
          + (f" (gates 1e-5, {DATA_GRAD_GATE}, {DATA_UPDATE_GATE})" if gated else " (recorded)")
          + f"; peak {max(r['peak_gib'] for r in ranks):.2f} GiB a rank{extra}")


def moe_slot_diffs(ranks) -> int:
    """Token-slots whose expert id on a rank differs from the one-process
    forward's on the same token (rank r holds the whole batch's flat tokens
    [r t, (r + 1) t))."""
    whole = ranks[0]["ids"]["whole"]
    diffs = 0
    for r, got in enumerate(ranks):
        for mine, want in zip(got["ids"]["rank"], whole):
            k = mine.shape[-1]
            mine = mine.reshape(-1, k)
            diffs += int((mine != want.reshape(-1, k)[r * len(mine):(r + 1) * len(mine)]).sum())
    return diffs


def data_axis_phase(configs, sgd, hybrid_train, dev, name, smi, workdir) -> dict:
    """Phase 25: the reference's ``data`` mesh axis; (a)-(e) of the
    module docstring."""
    from repro_torch.models import moe
    t0 = time.perf_counter()
    f32 = dict(dtype=torch.float32, learning_rate=TRAIN_VS_CPU_LR)
    b_cfg = cut(configs.get(HYBRID_TRAIN_ARCH), DATA_F32_LAYERS).replace(**f32)
    d_cfg = cut(configs.get(DATA_MOE_ARCH), DATA_MOE_LAYERS).replace(
        dtype=torch.float32, learning_rate=DATA_MOE_LR)
    e_cfg = d_cfg.replace(capacity_factor=DATA_SPLIT_CAPACITY)
    jobs = [("data_train", HYBRID_TRAIN_ARCH, DATA_TRAIN),
            ("data_step:f32", b_cfg, TRAIN_VS_CPU_BATCH, TRAIN_VS_CPU_SEQ),
            ("data_step:moe", d_cfg, DATA_MOE_BATCH, DATA_MOE_SEQ),
            ("data_step:moe-split", e_cfg, DATA_SPLIT_BATCH, DATA_SPLIT_SEQ)]
    torch.cuda.empty_cache()
    small = configs.get(POD_ARCH, reduced=True).replace(**f32)
    cases = [(m, e) for m in ("int8", "topk") for e in (1, 2)]
    # (c)'s ranks start beside (a)'s but run their jobs only once (a) has
    # ended (its rank 0 leaves ``a_done``): they then share the card and the
    # host with (b) and (d), which report only their gates, while (a)'s
    # times are taken with (c)'s ranks asleep.
    a_done = workdir / "a_done"
    two = start_mesh(jobs, DATA_WORLD, "gloo", {"a_done": str(a_done)}, workdir / "data")
    try:
        four = start_mesh([(f"pod_data:{m}-e{e}", small, dict(mode=m, local_epochs=e), True)
                           for m, e in cases], DATA_POD_WORLD, "gloo",
                          {"wait_for": str(a_done)}, workdir / "pod_data")
        try:
            ranks = join_mesh(two, workdir / "data", DATA_TIMEOUT_S)
            pods = join_mesh(four, workdir / "pod_data", DATA_TIMEOUT_S)
        finally:
            stop_mesh(four)
    finally:
        stop_mesh(two)
    out = {}

    a = [r["data_train"] for r in ranks]
    check(all(r["data_ranks"] == DATA_WORLD for r in a), "(a) did not run data-parallel")
    check(all(r["digests"] == a[0]["digests"] for r in a), "(a) the ranks' params differ")
    check(all(r["losses"] == a[0]["losses"] for r in a), "(a) the ranks' losses differ")
    one = hybrid_train["losses"][:DATA_TRAIN_STEPS]
    rel = max(abs(x - y) / abs(y) for x, y in zip(a[0]["losses"], one))
    check(all(math.isfinite(x) for x in a[0]["losses"]) and rel <= DATA_LOSS_GATE,
          f"(a) losses {a[0]['losses']} vs one process {one} ({rel:.3e} > {DATA_LOSS_GATE})")
    step_ms = [sum(r["step_ms"][i] for r in a) / len(a) for i in range(DATA_TRAIN_STEPS)]
    reduce_ms = [sum(r["reduce_ms"][i] for r in a) / len(a) for i in range(DATA_TRAIN_STEPS)]
    ms = sum(step_ms[1:]) / len(step_ms[1:])
    share = sum(reduce_ms[1:]) / sum(step_ms[1:])
    peak = max(r["peak_gib"] for r in a)
    out["a"] = dict(losses=a[0]["losses"], one_process_losses=one, loss_rel=rel, step_ms=step_ms,
                    ms_per_step=ms, reduce_ms=reduce_ms, reduce_share=share, peak_gib_a_rank=peak,
                    reductions_per_step=a[0]["reductions_per_step"],
                    f32_grad_bytes=2 * a[0]["param_bytes"],
                    one_process_ms_per_step=hybrid_train["ms_per_step"],
                    one_process_peak_gib=hybrid_train["peak_gib"], seconds=a[0]["seconds"])
    print(f"  (a) hybrid-train as {DATA_WORLD} gloo ranks on the card: {HYBRID_TRAIN_ARCH} "
          f"published config, batch 4 x 512 (2 rows a rank), {DATA_TRAIN_STEPS} steps: "
          f"{ms:.1f} ms a step after the first ({step_ms[0]:.1f} ms), "
          f"{sum(reduce_ms[1:]) / len(reduce_ms[1:]):.1f} ms of it in "
          f"{a[0]['reductions_per_step']:.0f} mean-reductions (share {share:.3f}, "
          f"{2 * a[0]['param_bytes'] / 1e9:.2f} GB of f32 gradients a step), peak {peak:.2f} GiB "
          f"a rank; ranks' params the same bits; losses {[round(x, 5) for x in a[0]['losses']]} "
          f"vs one process (phase 21) {[round(x, 5) for x in one]} (max rel {rel:.3e}, gate "
          f"2^-8); one process {hybrid_train['ms_per_step']:.1f} ms a step, peak "
          f"{hybrid_train['peak_gib']:.2f} GiB  on {name} ({smi})")

    b = [r["data_step:f32"] for r in ranks]
    data_parity_line("(b) f32 parity", b_cfg, b[0], b, True)
    out["b"] = {k: b[0][k] for k in ("step_loss", "want_loss", "grad_rel", "update_rel",
                                     "seconds")}
    out["b"]["peak_gib_a_rank"] = max(r["peak_gib"] for r in b)

    # (d) is gated where no expert slot differs (a router near-tie flips a
    # token's expert); (e) always, its differing slots recorded: the split
    # dispatch must give the one-process step.  Each forward's selections
    # that kept a slot are summed over the ranks and held against the
    # one-process forward's where no slot differs; (e) must drop some, or
    # its queue places decide nothing.
    for part, job, p_cfg, (rows, seq), how in (
            ("d", "data_step:moe", d_cfg, (DATA_MOE_BATCH, DATA_MOE_SEQ),
             "one {t}-token group a rank"),
            ("e", "data_step:moe-split", e_cfg, (DATA_SPLIT_BATCH, DATA_SPLIT_SEQ),
             "{t} tokens a rank, one {g}-token group spanning the ranks")):
        d = [r[job] for r in ranks]
        diffs = moe_slot_diffs(d)
        gated = part == "e" or diffs == 0
        kept = sum(n for r in d for n, _ in r["kept"]["rank"])
        want_kept, chosen = (sum(x) for x in zip(*d[0]["kept"]["whole"]))
        dropped = chosen - want_kept
        check(diffs != 0 or kept == want_kept, f"({part}) the ranks kept {kept} selections, "
              f"the one-process forward {want_kept}")
        check(part == "d" or dropped > 0, f"({part}) no selection was dropped at capacity "
              f"{moe.capacity(p_cfg, min(rows * seq, moe.MOE_GROUP))}")
        t = rows * seq // DATA_WORLD
        label = "(d) MoE" if part == "d" else "(e) MoE, a split group"
        data_parity_line(label, p_cfg, d[0], d, gated,
                         f"; expert slots differing {diffs} ({rows} x {seq}, "
                         f"{how.format(t=t, g=min(rows * seq, moe.MOE_GROUP))}, capacity factor "
                         f"{p_cfg.capacity_factor:g}); selections kept {kept:,} over the ranks, "
                         f"{want_kept:,} in one process, of {chosen:,} ({dropped:,} dropped)")
        out[part] = {k: d[0][k] for k in ("step_loss", "want_loss", "grad_rel", "update_rel",
                                          "seconds")}
        out[part].update(expert_slots_differing=diffs, gated=gated, kept_selections=kept,
                         one_process_kept=want_kept, selections=chosen, dropped=dropped,
                         capacity_factor=p_cfg.capacity_factor,
                         peak_gib_a_rank=max(r["peak_gib"] for r in d))

    out["c"] = {}
    for m, e in cases:
        got = [r[f"pod_data:{m}-e{e}"] for r in pods]
        check(all(torch.equal(r["params"], got[0]["params"]) for r in got),
              f"(c) {m} E={e}: the four ranks' params differ")
        for p in range(DATA_POD_WORLD // DATA_POD_DATA):
            pair = got[p * DATA_POD_DATA:(p + 1) * DATA_POD_DATA]
            check(all(all(torch.equal(x, y) for x, y in zip(r["err"], pair[0]["err"]))
                      for r in pair), f"(c) {m} E={e}: pod {p}'s data ranks' errors differ")
        loop = pod_job(("pod:loop", small, dict(mode=m, local_epochs=e, n_pods=2), True), {},
                       None, dev)
        off, apart = 0, 0
        for i, err in enumerate(loop["err"]):
            n = err[0].numel()
            qstep = 2 * float(err.abs().max()) + 1e-30
            apart += close_but_flips(got[0]["params"][off:off + n], loop["params"][off:off + n],
                                     qstep * (TRAIN_VS_CPU_LR if e == 1 else 1.0),
                                     DATA_FLIP_SHARE)
            for p in range(2):
                close_but_flips(got[p * DATA_POD_DATA]["err"][i].reshape(-1),
                                err[p].reshape(-1), qstep, DATA_FLIP_SHARE)
            off += n
        rel = max(abs(x - y) / abs(y) for x, y in zip(got[0]["losses"], loop["losses"]))
        check(rel <= 1e-5, f"(c) {m} E={e}: losses {got[0]['losses']} vs {loop['losses']}")
        out["c"][f"{m} E={e}"] = dict(losses=got[0]["losses"], loop_losses=loop["losses"],
                                      params_apart=apart, d=off,
                                      step_ms=got[0]["step_ms"])
        print(f"  (c) pods 2 x {DATA_POD_DATA} data ranks ({DATA_POD_WORLD} gloo ranks on the "
              f"card), {small.name} f32 {m} E={e}: the four ranks' params the same bits, each "
              f"pod's data ranks' error buffers the same bits; vs the one-process 2-pod loop "
              f"{apart} of {off:,} params a neighbouring code apart, losses rel {rel:.2e}")
    out["seconds"] = time.perf_counter() - t0
    print(f"  phase 25 took {out['seconds']:.1f} s: on rank 0 (a) {a[0]['seconds']:.1f}, (b) "
          f"{b[0]['seconds']:.1f}, (d) {out['d']['seconds']:.1f}, (e) "
          f"{out['e']['seconds']:.1f}; the ranks' start and (c), beside (b), (d) and (e), the "
          f"rest")
    return out


# --- phase 26: long-row: the per-client compressors on one row past 2^31 -----------

LONG_D = 2 ** 31 + 8209         # 262,145 full blocks (one starts at 2^31), then 17 columns
LONG_RHO = 0.05
LONG_CALLS = 3                  # timed calls a kernel after call_ms's warm-up
FED_ROW_D = 1_486_901_248       # phase 21 (f)'s row: --timing's shape, the parent's too


def long_row_phase(dev, kq8, tk, kops, kref, comp, name, smi, d=LONG_D,
                   check_slices=True) -> dict:
    """Phase 26 (module docstring) on one row of ``d``; with
    ``check_slices`` False (``--timing``) the three kernels are only timed.
    Keys "<kernel> @ 1 x <d>": ms a call by CUDA events, the bytes bound."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    g = torch.Generator(device=dev).manual_seed(26)
    delta = torch.randn((1, d), generator=g, device=dev)
    err = torch.randn((1, d), generator=g, device=dev).mul_(0.1)
    blk = kops.BLOCK_ELEMS
    nb = -(-d // blk)
    k = kops.block_k(comp.blockwise_k_frac(d, LONG_RHO))
    spans = [(b, min(d, (b + 1) * blk))
             for b in sorted({max(b, 0) for b in (0, nb - 3, nb - 2, nb - 1)})]
    out = {}
    check(d != LONG_D or ((nb - 2) * blk == 2 ** 31 and d - (nb - 1) * blk == 17),
          f"long-row: d={d:,} does not put a full block at 2^31 and a 17-wide one last")
    if check_slices:
        kq8.reset_launches()
        recon, new_err = comp.compress_update(delta, err, comp.CompressorConfig(
            rho_s=LONG_RHO, quant_bits=8))
        torch.cuda.synchronize()
        check(kq8.LAUNCHES["compress_q8"] == 1 and tuple(recon.shape) == (1, d)
              and bool(torch.isfinite(recon[:, -blk:]).all()),
              "long-row: compress_update did not run compress_q8 once on the row")
        del recon, new_err
        torch.cuda.empty_cache()

    def slices(kname, ins, got, plain, padded):
        """``got`` on each span's block bitwise ``plain`` on that block alone
        (codes past d included where the layout is ``padded``)."""
        for b, end in spans:
            want = plain(*(x[:, b * blk:end].contiguous() for x in ins))
            for gt, wt in zip(got, want):
                cols = (slice(b, b + 1) if gt.shape[1] == nb
                        else slice(b * blk, (b + 1) * blk if padded else end))
                check(torch.equal(gt[:, cols], wt), f"long-row {kname}: block {b} of d={d:,} "
                      "differs from the plain version")

    runs = (("compress_q8", (delta, err), lambda: kq8.compress_blocks(delta, err, k),
             lambda x, e: kref.compress_ref(x, e, k), compress_work(1, d, True), False),
            ("quant8", (delta,), lambda: kq8.quant8_blocks(delta), kref.quant8_ref,
             quant8_work(1, d), True),
            ("topk_ef", (delta, err), lambda: tk.topk_ef_blocks(delta, err, k),
             lambda x, e: kref.blockwise_topk_ef_ref(x, e, k), compress_work(1, d, False), False))
    for kname, ins, run, plain, work, padded in runs:
        if check_slices:
            got = run()
            slices(kname, ins, got, plain, padded)
            del got
            torch.cuda.empty_cache()
        ms = call_ms(run, LONG_CALLS)
        bound_ms, bound_by = bound_from(*work)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        out[f"{kname} @ 1 x {d:,}"] = dict(ms=ms, bound_ms=bound_ms, bound_by=bound_by,
                                            checked_blocks=[b for b, _ in spans] if check_slices
                                            else [])
        print(f"  {kname} on one row of d={d:,} (k={k}): {ms:.3f} ms a call (CUDA events), "
              f"bound {bound_ms:.3f} ms ({bound_by}, {work[0] / 1e9:.2f} GB)"
              + (f"; blocks {[b for b, _ in spans]} bitwise the plain version" if check_slices
                 else "") + f"; peak {peak:.1f} GiB  on {name} ({smi})")
        torch.cuda.empty_cache()
    del delta, err
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    return out


def time_gradient_row(configs, api, kq8, kops, comp, dev, name, smi) -> dict:
    """``--timing``'s ``compress_q8`` on phase 21 (f)'s gradient row (the
    selection's cost rides on the data: this row is slower than a Gaussian
    one of its d), by CUDA events as phase 21 (f) times it."""
    from repro_torch.data.pipeline import lm_batches
    from repro_torch.optim import sgd
    delta = fed_gradient_row(configs, api, sgd, lm_batches, dev)
    err = torch.zeros_like(delta)
    d = delta.shape[1]
    check(d == FED_ROW_D, f"phase 21 (f)'s row has d={d:,}, not {FED_ROW_D:,}")
    k = kops.block_k(comp.blockwise_k_frac(d, LONG_RHO))
    ms = call_ms(lambda: kq8.compress_blocks(delta, err, k), LONG_CALLS)
    bound_ms, bound_by = bound_from(*compress_work(1, d, True))
    print(f"  compress_q8 on phase 21 (f)'s gradient row, d={d:,} (k={k}): {ms:.3f} ms a call "
          f"(CUDA events), bound {bound_ms:.3f} ms ({bound_by})  on {name} ({smi})")
    del delta, err
    torch.cuda.empty_cache()
    return {f"compress_q8 @ gradient row 1 x {d:,}": dict(ms=ms, bound_ms=bound_ms,
                                                          bound_by=bound_by)}


def main(argv: list[str]) -> int:
    timing_only = argv == ["--timing"]
    if argv and not timing_only:
        print("usage: chip_smoke.py [--timing]", file=sys.stderr)
        return 2
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

    max_err, q8_batches, main_path_launches = {}, 0, {}
    if not timing_only:   # phases 3-5; --timing runs phase 6 alone after the build
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
                        check(same_scores(out, fs.score_rows(x, tau, dequantised(*tensors[:2]),
                                                             tensors[2])),
                              f"fused_score_q8 differs from fused_score_f32 on the dequantised "
                              f"weights at d={d}, rows={rows}")
                    else:
                        out = fs.score_rows(x, tau, *tensors)
                        ref = kref.fused_score_ref(x, *tensors, tau)
                    torch.cuda.synchronize()
                    e = compare(*out, *ref, tau)
                    max_err[kname] = max(max_err[kname], e)
                    print(f"  {kname:16s} d={d:3d} rows={rows:6d} max|err diff|={e:.3e}"
                          + ("; bitwise fused_score_f32 on q * s" if q8 else "") + "  ok")
        q8_batches = check_q8_any_batch(dev, fs, ae, score_mod.quantize_params)

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
    at_10k, at_depth = (train_timing[k]["ms"] for k in ("wire_agg @ 10k call",
                                                         "wire_agg @ chunk, 10k depth"))
    scan_share = (at_10k - at_depth) / at_10k
    print(f"  wire_agg member scan over 10,000 ids less 512: {(at_10k - at_depth) * 1e3:.3f} us of "
          f"the 10k call's {at_10k * 1e3:.3f} us (share {scan_share:.3f})  on {name} ({smi})")
    train_timing.update(time_compress_kernels(dev, kq8, tk, kops, kref, comp, ae, name, smi))
    identity = time_identity_fogs(dev, fa, name, smi)
    if timing_only:
        train_timing.update(long_row_phase(dev, kq8, tk, kops, kref, comp, name, smi,
                                           FED_ROW_D, check_slices=False))
        train_timing.update(time_gradient_row(lm_configs, lm_api, kq8, kops, comp, dev, name,
                                              smi))
        print(json.dumps({"timing": train_timing, "identity_66k": identity,
                          "launch_floor": floor, "device": name}))
        print(smi)
        return 0

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

    phase("17. flat-200 (main path): FedAvg, FedProx, FedAdam, SCAFFOLD, centralised")
    from repro_torch.core import flat_fl   # here, so --timing runs in checkouts without it
    flat = flat_fleet(exp, flat_fl, ae, FaultConfig, train_ds,
                      kernel_counters(lt, fa, ra, kq8, tk), training, dev, name, smi)

    phase("18. engine-200 (main path): the batched trial Engine, 8 trials a call")
    from repro_torch.core import participation
    from repro_torch.engine import Engine
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=ROOT / "build") as tmp:
        engine = engine_fleet(
            (Engine, exp, hfl, ae, participation, topo, anomaly, score_mod, CheckpointStore,
             FaultConfig, SyntheticConfig, generate, normalize, lt, fa, ra, fs, kops, kref, agg,
             comp, multi_epoch_indices),
            train_ds, kernel_counters(lt, fa, ra, kq8, tk), training, dev, name, smi, Path(tmp))

    phase("19. async-200 (main path): the event-driven async family, N=200")
    from repro_torch.core import async_fl
    async_res = async_fleet((Engine, exp, async_fl, hfl, ae, FaultConfig, mmpp_trace, lt, fa, ra,
                             kref), train_ds, kernel_counters(lt, fa, ra, kq8, tk), training,
                            dev, name, smi)

    phase("20. mesh-200 (main path): the client-sharded round loop over torch.distributed")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=ROOT / "build") as tmp:
        mesh = mesh_phase((exp, hfl, flat_fl, ae, Engine, lt, fa, kops, kref), train_ds,
                          training, flat, fleet, dev, name, smi, Path(tmp))

    phase("21. lm-train (main path): LM training, prefill by forward, the pod family")
    from repro_torch.data.pipeline import lm_batches
    from repro_torch.examples import federated_llm
    from repro_torch.launch import train as lm_train
    from repro_torch.optim import sgd
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=ROOT / "build") as tmp:
        lm = lm_train_phase((lm_train, lm_configs, lm_api, lm_layers, lm_launch, rglru, swa, kref,
                             sgd, CheckpointStore, comp, kops, kq8, federated_llm, lm_batches),
                            hybrid["hybrid-serve"], dev, name, smi, Path(tmp))
    phase("22. lm-families (main path): the moe, ssm and encdec families, and qwen3")
    from repro_torch.models import encdec, moe
    families = lm_family_phase((lm_train, lm_configs, lm_api, lm_layers, lm_launch, swa, kref, sgd,
                                moe, encdec), dev, name, smi)
    phase("23. launch-tooling (main path): the examples, sgd.adam, the dry run beside the card")
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.examples import load_replay, quickstart, serve_anomaly, train_iout_hfl
    from repro_torch.launch import dryrun, roofline
    example_mods = {"quickstart": quickstart, "train_iout_hfl": train_iout_hfl,
                    "serve_anomaly": serve_anomaly, "load_replay": load_replay}
    example_counters = {**{k: v for k, v in kernel_counters(lt, fa, ra, kq8, tk).items()
                           if k in ("local_train_f32", "fused_agg")},
                        **{k: (fs.LAUNCHES, fs.reset_launches) for k in KERNELS}}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=ROOT / "build") as tmp:
        tooling = launch_tooling_phase(
            (example_mods, sgd, lm_configs, lm_api, dryrun, roofline, ShapeConfig),
            example_counters, lm, families, dev, name, smi, Path(tmp))
    phase("24. sweep-200 (main path): Engine.sweep, each shape class one batched call")
    from repro_torch.core import energy as en
    sweep = sweep_phase((Engine, exp, async_fl, ch, en, FaultConfig, comp, lt, fa, ra, kref, ae),
                        train_ds, kernel_counters(lt, fa, ra, kq8, tk), dev, name, smi)
    phase("25. data-axis (main path): data-parallel production training, in-pod data ranks")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=ROOT / "build") as tmp:
        data_axis = data_axis_phase(lm_configs, sgd, lm["hybrid-train"], dev, name, smi,
                                    Path(tmp))
    phase("26. long-row: the per-client compressors on one row of 2^31 + 8,209")
    long_rows = long_row_phase(dev, kq8, tk, kops, kref, comp, name, smi)
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
            "launches_by_path": {"serve-200 + load-mmpp": main_path_launches[kname],
                                 "examples": example_launches(tooling, kname)},
        })
    for key, entry in engine["kernels"].items():       # the folded shapes' checks
        kname = key.split(" @ ")[0]
        train_err[kname] = max(train_err[kname], entry["max_abs_err"])
    for kname, e in async_res["kernel_checks"]["max_abs_err"].items():   # the async inputs'
        train_err[kname] = max(train_err[kname], e)
    for kname, e in mesh["kernel_max_abs_err"].items():   # a mesh rank's shapes
        train_err[kname] = max(train_err[kname], e)
    for part in ("physics", "robust"):                    # the folded sweep classes' inputs
        for kname, e in sweep[part]["kernel_checks"]["max_abs_err"].items():
            train_err[kname] = max(train_err[kname], e)
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
        by_shape = {k.split(" @ ")[1]: v for k, v in {**train_timing, **engine["kernels"],
                                                        **long_rows}.items()
                    if k.startswith(f"{kname} @ ")}
        if kname in ("local_train_f32", "fused_agg"):
            kernels[-1]["launches_by_path"] = {
                "train-200": launches[kname],
                "engine-200": engine["cells"]["engine-200"]["launches"][kname],
                "async-200 sweep": async_res["launches"]["sweep (3 cells)"][kname],
                "mesh-200 per gloo rank (W=2)": mesh["gloo_two_ranks"]["launches_per_rank"][kname],
                "examples": example_launches(tooling, kname),
                "sweep-200 physics (8 cells, B=16, one call)":
                    sweep["physics"]["launches_per_class"][0][kname],
                "sweep-200 async (3 cells, one call)":
                    sweep["async"]["launches_per_class"][0][kname]}
        if kname in ("wire_emit", "wire_agg"):
            kernels[-1]["launches_by_path"] = {
                "fleet-10k": launches[kname],
                "mesh-10k per gloo rank (W=2)": mesh["mesh_10k"]["wire_launches_per_rank"][kname]}
        if kname == "robust_agg":
            kernels[-1]["launches_by_path"] = {
                "robust-200": launches[kname],
                "engine robust": engine["cells"]["robust trimmed"]["launches"][kname],
                "async robust": async_res["launches"]["robust"][kname],
                "sweep-200 trimmed class (4 cells, B=8, one call)":
                    sweep["robust"]["launches_per_class"][1][kname]}
        if kname == "fused_agg":
            by_shape["66,000 identity fogs"] = identity
        if kname == "compress_q8":
            full = lm["federated-llm"]["full"]
            by_shape[f"federated-llm, 1 x {full['d']:,}"] = {
                k: full[k] for k in ("ms", "bound_ms", "bound_by", "peak_gib")}
            kernels[-1]["launches_by_path"] = {
                "legacy-200": launches[kname],
                "federated-llm REDUCED f32, 5 steps": lm["federated-llm"]["reduced"]["f32"][
                    "compress_q8_launches"]}
        if by_shape:
            kernels[-1]["by_shape"] = by_shape
    print(json.dumps({"training": training}))
    print(json.dumps({"robust": robust}))
    print(json.dumps({"fleet": fleet}))
    print(json.dumps({"legacy": legacy, "tied_blocks": tied_blocks}))
    print(json.dumps({"drift": drift}))
    print(json.dumps({"launch_floor": floor, "wrapper_host_cost": host_cost,
                      "compress_q8_at_fleet_chunk": train_timing["compress_q8 @ fleet chunk"],
                      "wire_agg_at_10k_call": train_timing["wire_agg @ 10k call"],
                      "wire_agg_chunk_at_10k_depth": train_timing["wire_agg @ chunk, 10k depth"],
                      "wire_agg_scan_share_at_10k": scan_share,
                      "fused_score_q8_batches_bitwise": q8_batches,
                      "wire_emit_edge_cases": wire_edges}))
    replaces, source = SWA_KERNEL
    kernels.append({
        "name": "swa_decode",
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": hybrid["hybrid-serve"]["launches"],
        "max_abs_err": max([swa_err["max_abs_err"]] + [
            run["path_check"]["max_abs_err"] for run in (
                hybrid["hybrid-serve"], hybrid["hybrid-window"], dense["dense-decode"],
                *(families[k] for k in FAMILY_SERVE_RUNS))]),
        **swa_timing,
        "launches_by_path": {"hybrid-serve": hybrid["hybrid-serve"]["launches"],
                             "hybrid-window": hybrid["hybrid-window"]["launches"],
                             "dense-decode": dense["dense-decode"]["launches"],
                             "lm-train prefill check (token-stepped)":
                                 lm["prefill"]["swa_launches"],
                             **{k: families[k]["launches"] for k in FAMILY_SERVE_RUNS}},
    })
    print(json.dumps({"lm": {"swa_check": swa_err, "hybrid": hybrid, "dense": dense}}))
    print(json.dumps({"flat": flat}))
    print(json.dumps({"engine": engine}))
    print(json.dumps({"async": async_res}))
    print(json.dumps({"mesh": mesh}))
    print(json.dumps({"lm_train": lm}))
    print(json.dumps({"lm_families": families}))
    print(json.dumps({"launch_tooling": tooling}))
    print(json.dumps({"sweep": sweep}))
    print(json.dumps({"data_axis": data_axis}))
    print(json.dumps({"long_rows": long_rows}))
    print("phase seconds: " + ", ".join(f"{k.split('.')[0]} {v:.1f}" for k, v in PHASE_S.items()
                                        if k != "done")
          + f"; script {time.perf_counter() - START:.1f} s  on {name} ({smi})")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
