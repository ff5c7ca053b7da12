"""Plain PyTorch versions of the port's kernels.

Each function is the counterpart of the same-named oracle in
``repro.kernels.ref``.  The CPU tests run them against the JAX package,
and ``chip_smoke.py`` holds each CUDA kernel against them on the card.
"""
from __future__ import annotations

import torch


def fused_score_ref(
    x: torch.Tensor,                  # (R, d) telemetry rows
    ws: tuple[torch.Tensor, ...],     # per-layer weights, (d_in, d_out)
    bs: tuple[torch.Tensor, ...],     # per-layer biases, (d_out,)
    tau: torch.Tensor,                # (R,) per-row thresholds
) -> tuple[torch.Tensor, torch.Tensor]:
    """AE forward (tanh hidden layers, linear output), squared-L2
    reconstruction error (Sec. V-D) and the Eq. 32 threshold compare.

    Returns (err (R,) f32, flag (R,) bool).
    """
    x = x.to(torch.float32)
    h = x
    for i, (w, b) in enumerate(zip(ws, bs)):
        h = h @ w.to(torch.float32) + b.to(torch.float32)
        if i < len(ws) - 1:
            h = torch.tanh(h)
    err = torch.sum(torch.square(x - h), dim=-1)
    return err, err > tau


def fused_score_q8_ref(
    x: torch.Tensor,                  # (R, d) telemetry rows
    qws: tuple[torch.Tensor, ...],    # per-layer int8 weights, (d_in, d_out)
    sws: tuple[torch.Tensor, ...],    # per-layer scales, (1, d_out) f32
    bs: tuple[torch.Tensor, ...],     # per-layer f32 biases, (d_out,)
    tau: torch.Tensor,                # (R,) per-row thresholds
) -> tuple[torch.Tensor, torch.Tensor]:
    """int8-weight variant: per-output-channel dequantisation
    (``w = q * scale``), then exactly :func:`fused_score_ref`."""
    ws = tuple(
        q.to(torch.float32) * s.to(torch.float32).reshape(1, -1)
        for q, s in zip(qws, sws)
    )
    return fused_score_ref(x, ws, bs, tau)


BISECT_ITERS = 32


def bisect_threshold(
    absx: torch.Tensor, k: int, iters: int = BISECT_ITERS,
    hi: torch.Tensor | None = None,
) -> torch.Tensor:
    """Magnitude threshold t with |{i : absx_i > t}| <= k, maximal keep.

    ``absx``: (..., block) non-negative; returns (..., 1).  Invariant:
    count(> hi) <= k < count(> lo), with lo = -1 (every entry passes, the
    zero padding included) and hi = the block max (none does).
    """
    lo = torch.full(absx.shape[:-1] + (1,), -1.0, dtype=absx.dtype, device=absx.device)
    if hi is None:
        hi = torch.amax(absx, dim=-1, keepdim=True)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        take = torch.sum(absx > mid, dim=-1, keepdim=True) > k
        lo = torch.where(take, mid, lo)
        hi = torch.where(take, hi, mid)
    return hi


BLOCK_ELEMS = 8192   # compression block of the flat updates


def pad_blocks(x: torch.Tensor) -> torch.Tensor:
    """Zero-pad (N, d) rows to (N, nb, BLOCK_ELEMS)."""
    n, d = x.shape
    nb = max(1, -(-d // BLOCK_ELEMS))
    return torch.nn.functional.pad(x, (0, nb * BLOCK_ELEMS - d)).reshape(n, nb, BLOCK_ELEMS)


def unpad_rows(x: torch.Tensor, d: int) -> torch.Tensor:
    """(N, nb, BLOCK_ELEMS) blocks back to the (N, d) real coordinates."""
    return x.reshape(x.shape[0], -1)[:, :d]


def blockwise_topk_ef_ref(
    delta: torch.Tensor,      # (N, d) per-client flat updates
    err: torch.Tensor,        # (N, d) error-feedback buffers
    k_per_block: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback block Top-K (paper Eq. 30, blockwise) per client and
    zero-padded 8192-element block: (sparse (N, d), new_err (N, d)) with
    sparse + new_err == delta + err exactly (a mask decomposition)."""
    d = delta.shape[1]
    v = pad_blocks(delta + err)
    absv = torch.abs(v)
    sparse = torch.where(absv > bisect_threshold(absv, k_per_block), v, 0.0)
    return unpad_rows(sparse, d), unpad_rows(v - sparse, d)


def _quant8_blocks(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-block symmetric int8 of (..., BLOCK_ELEMS) blocks: (q int8, scale
    (..., 1)), scale = max|x| times f32(1/127) (the product the
    reference's jitted ``amax / 127`` computes), q = round(x / scale)
    clipped to +-127 (half to even); an all-zero block gets scale 0 and q
    0."""
    scale = torch.amax(torch.abs(x), dim=-1, keepdim=True) * (1.0 / 127.0)
    safe = torch.where(scale > 0, scale, 1.0)
    q = torch.clamp(torch.round(x / safe), -127.0, 127.0).to(torch.int8)
    return torch.where(scale > 0, q, 0), scale


def quant8_ref(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-block symmetric int8 of (N, d) rows, zero-padded to whole
    8192-element blocks: (q int8 (N, nb * 8192) in the blocked layout,
    zeros past d, scale (N, nb))."""
    n = x.shape[0]
    q, scale = _quant8_blocks(pad_blocks(x))
    return q.reshape(n, -1), scale[..., 0]


def dequant8_ref(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quant8_ref` (lossy): ``q * scale`` in f32, with
    ``scale`` shaped to broadcast over its block (for blocked q (N, nb,
    8192), scale (N, nb, 1))."""
    return q.to(torch.float32) * scale


def compress_ref(
    delta: torch.Tensor,      # (N, d) per-client flat updates
    err: torch.Tensor,        # (N, d) error-feedback buffers
    k_per_block: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """EF block Top-K, then int8 of the survivors (the paper pipeline,
    Sec. V-C): (q int8 (N, d), scale (N, nb), new_err (N, d)).

    The scale is max|sparse| times f32(1/127): the block max of |v| when
    anything survives, 0 when nothing does (more than k entries tied at
    the block max), where :func:`compress_aggregate_ref` keeps the block
    max's scale over the all-zero sparse.  new_err = v - q * scale, so the
    error buffer absorbs the sparsification and the quantisation residual.
    """
    d = delta.shape[1]
    v = pad_blocks(delta + err)
    absv = torch.abs(v)
    sparse = torch.where(absv > bisect_threshold(absv, k_per_block), v, 0.0)
    q, scale = _quant8_blocks(sparse)
    recon = dequant8_ref(q, scale)
    return unpad_rows(q, d), scale[..., 0], unpad_rows(v - recon, d)


def compress_aggregate_ref(
    delta: torch.Tensor,      # (N, d) per-client flat updates
    err: torch.Tensor,        # (N, d) error-feedback buffers
    fog_id: torch.Tensor,     # (N,) cluster id per client
    weights: torch.Tensor,    # (N,) f32, zeroed for non-participants
    n_fog: int,
    k_per_block: int,
    quantize: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Error-feedback block Top-K (+ int8 round trip) per client and
    zero-padded 8192-element block, then the weighted per-fog sums as a
    one-hot product.

    Returns (fog_sum (n_fog, d) unnormalised, new_err (N, d), threshold
    (N, nb)).  The int8 scale is the block max of |v| times f32(1/127),
    the product the reference's jitted oracle computes for ``amax / 127``
    (XLA folds a division by a constant into a multiply); whenever
    anything survives the threshold the block max does too, and when
    nothing does the scale multiplies only zeros.
    """
    n, d = delta.shape
    v, recon, t = _dense_recon(delta, err, k_per_block, quantize)
    fogs = torch.arange(n_fog, device=fog_id.device)
    sel = torch.where(fog_id[None, :] == fogs[:, None], weights[None, :].to(torch.float32), 0.0)
    fog_sum = torch.tensordot(sel, recon, dims=([1], [0])).reshape(n_fog, -1)[:, :d]
    return fog_sum, (v - recon).reshape(n, -1)[:, :d], t[..., 0]


def _dense_recon(
    delta: torch.Tensor, err: torch.Tensor, k_per_block: int, quantize: bool,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The dense path's selection and int8 round trip: (v, recon (N, nb,
    BLOCK_ELEMS), threshold (N, nb, 1))."""
    v = pad_blocks(delta + err)
    absv = torch.abs(v)
    amax = torch.amax(absv, dim=-1, keepdim=True)
    t = bisect_threshold(absv, k_per_block, hi=amax)
    sparse = torch.where(absv > t, v, 0.0)
    if quantize:
        scale = amax * (1.0 / 127.0)
        safe = torch.where(scale > 0, scale, 1.0)
        q = torch.clamp(torch.round(sparse / safe), -127.0, 127.0)
        recon = torch.where(scale > 0, q * scale, 0.0)
    else:
        recon = sparse
    return v, recon, t


def fog_ranks(fog_id: torch.Tensor, n_fog: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(member, rank) per client: whether its id lies in [0, n_fog), and
    its place among its fog's clients in index order (the clients of no
    fog ranked among themselves)."""
    n = fog_id.shape[0]
    fog = fog_id.long()
    member = (fog >= 0) & (fog < n_fog)
    key = torch.where(member, fog, n_fog)
    order = torch.sort(key, stable=True).indices
    counts = torch.bincount(key, minlength=n_fog + 1)
    first = torch.cumsum(counts, 0) - counts
    rank = torch.empty_like(fog)
    rank[order] = torch.arange(n, device=fog.device) - first[key[order]]
    return member, rank


def dense_fold_ref(
    delta: torch.Tensor,      # (N, d) per-client flat updates
    err: torch.Tensor,        # (N, d) error-feedback buffers
    fog_id: torch.Tensor,     # (N,) cluster id per client
    weights: torch.Tensor,    # (N,) f32
    n_fog: int,
    k_per_block: int,
    quantize: bool = True,
) -> torch.Tensor:
    """:func:`compress_aggregate_ref`'s fog sums in ``fused_agg``'s own
    order: each coordinate of fog m takes ``w * recon`` of m's clients in
    index order, from 0, each added to the running value, so the result is
    the kernel's bit for bit.  Ids outside [0, n_fog) belong to no fog; an
    empty fog's row is zeros.  The clients go in waves, the r-th member of
    every fog in wave r, as in :func:`wire_fold_ref`."""
    n, d = delta.shape
    _, recon, _ = _dense_recon(delta, err, k_per_block, quantize)
    val = weights.to(torch.float32)[:, None] * recon.reshape(n, -1)[:, :d]
    out = torch.zeros((n_fog, d), dtype=torch.float32, device=delta.device)
    member, rank = fog_ranks(fog_id, n_fog)
    fog = fog_id.long()
    waves = int(rank[member].max()) + 1 if bool(member.any()) else 0
    for r in range(waves):
        wave = member & (rank == r)
        rows = fog[wave]
        out[rows] = out[rows] + val[wave]
    return out


def local_train_ref(
    x: torch.Tensor,                  # (N, window, D) resident client windows
    idx: torch.Tensor,                # (N, steps, bsz) minibatch row indices
    ws: tuple[torch.Tensor, ...],     # per-layer weights, (d_in, d_out)
    bs: tuple[torch.Tensor, ...],     # per-layer biases, (d_out,)
    lr: float,
    mu: float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """E-epoch minibatch SGD on the autoencoder loss for every client at
    once, each minibatch indexed out of the client's window; FedProx adds
    ``mu * (theta - theta_anchor)`` to the gradient when ``mu != 0``.

    The backward pass is written out: tanh' is ``1 - a**2`` from the stored
    tanh output, the gradient of layer l-1 uses layer l's pre-update
    weights, dL/dz_out = (2 / bsz) (recon - x).  Returns (deltas (N, d) =
    trained - broadcast params in the ravel order — per layer the bias,
    then the row-major weight — and the mean step loss (N,)).
    """
    n, steps, bsz = idx.shape
    n_layers = len(ws)
    anchor_w = [w.to(torch.float32) for w in ws]
    anchor_b = [b.to(torch.float32) for b in bs]
    cur_w = [w.expand(n, *w.shape).clone() for w in anchor_w]
    cur_b = [b.expand(n, *b.shape).clone() for b in anchor_b]
    rows = torch.arange(n, device=x.device)[:, None]
    inv_b = 1.0 / bsz
    loss_sum = torch.zeros((n,), dtype=torch.float32, device=x.device)
    for s in range(steps):
        xb = x[rows, idx[:, s].long()].to(torch.float32)         # (N, bsz, D)
        acts = [xb]
        h = xb
        for li in range(n_layers):
            h = torch.bmm(h, cur_w[li]) + cur_b[li][:, None, :]
            if li < n_layers - 1:
                h = torch.tanh(h)
            acts.append(h)
        diff = h - xb
        loss_sum = loss_sum + torch.sum(diff * diff, dim=(1, 2)) * inv_b
        g = (2.0 * inv_b) * diff
        for li in range(n_layers - 1, -1, -1):
            a_prev = acts[li]
            dw = torch.bmm(a_prev.transpose(1, 2), g)
            db = torch.sum(g, dim=1)
            if li > 0:
                g_prev = torch.bmm(g, cur_w[li].transpose(1, 2)) * (1.0 - a_prev * a_prev)
            if mu != 0.0:
                dw = dw + mu * (cur_w[li] - anchor_w[li])
                db = db + mu * (cur_b[li] - anchor_b[li])
            cur_w[li] = cur_w[li] - lr * dw
            cur_b[li] = cur_b[li] - lr * db
            if li > 0:
                g = g_prev
    deltas = torch.cat([
        part for w, b, aw, ab in zip(cur_w, cur_b, anchor_w, anchor_b)
        for part in ((b - ab).reshape(n, -1), (w - aw).reshape(n, -1))
    ], dim=1)
    return deltas, loss_sum / steps


def compress_wire_ref(
    delta: torch.Tensor,      # (N, d) per-client flat updates
    err: torch.Tensor,        # (N, d) error-feedback buffers
    k: int,                   # slots per 8192-element block
    quantize: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The sparse wire: the survivors of :func:`compress_aggregate_ref`'s
    selection packed into k slots per zero-padded block.

    Returns (idx (N, nb, k) int32 within-block coordinates, q (N, nb, k)
    int8 codes — f32 values without ``quantize`` — scale (N, nb) f32, 1.0
    without ``quantize``, new_err (N, d)).  Slot order is the reference's
    ``top_k(where(survive, |v|, -1))``: survivors by |v| descending, ties
    to the lower index, then the lowest-index non-survivors ascending with
    code 0 (a stable descending sort gives exactly that order).
    new_err is v - q * scale at the slots and v elsewhere.
    """
    n, d = delta.shape
    v = pad_blocks(delta + err)
    absv = torch.abs(v)
    amax = torch.amax(absv, dim=-1, keepdim=True)
    t = bisect_threshold(absv, k, hi=amax)
    survive = absv > t
    k = min(int(k), BLOCK_ELEMS)
    rank_key = torch.where(survive, absv, -1.0)
    idx = torch.sort(rank_key, dim=-1, descending=True, stable=True).indices[..., :k]
    kept = torch.gather(survive, -1, idx)
    v_slots = torch.gather(v, -1, idx)
    vals = torch.where(kept, v_slots, 0.0)
    if quantize:
        scale = (amax * (1.0 / 127.0))[..., 0]
        safe = torch.where(scale > 0, scale, 1.0)[..., None]
        q = torch.clamp(torch.round(vals / safe), -127.0, 127.0)
        recon_vals = torch.where(scale[..., None] > 0, q * scale[..., None], 0.0)
        q = q.to(torch.int8)
    else:
        scale = torch.ones(v.shape[:-1], dtype=torch.float32, device=v.device)
        q = vals
        recon_vals = vals
    new_err = v.scatter(-1, idx, v_slots - recon_vals)
    return idx.to(torch.int32), q, scale, new_err.reshape(n, -1)[:, :d]


def wire_aggregate_ref(
    idx: torch.Tensor,        # (N, nb, k) int32 within-block coordinates
    q: torch.Tensor,          # (N, nb, k) int8 codes (or f32 values)
    scale: torch.Tensor,      # (N, nb) f32 per-block scales
    fog_id: torch.Tensor,     # (N,) cluster id per client
    weights: torch.Tensor,    # (N,) f32, zeroed for non-participants
    n_fog: int,
    d: int,
) -> torch.Tensor:
    """Weighted scatter-add off the wire: each slot adds
    ``q * scale * w`` at its coordinate of its client's fog row.  Returns
    fog_sum (n_fog, d) f32, unnormalised.  A client whose id lies outside
    [0, n_fog) is dropped (the reference's oracle wraps a negative id to
    a fog from the end instead; the port keeps the rule of its dense path
    and of ``jax.ops.segment_sum``)."""
    n, nb, k = idx.shape
    contrib = q.to(torch.float32) * scale[..., None] * weights.to(torch.float32)[:, None, None]
    fog = _fog_or_spill(fog_id, n_fog)
    row = fog[:, None, None] * nb + torch.arange(nb, device=idx.device)[None, :, None]
    flat = row * BLOCK_ELEMS + idx.long()
    fog_sum = torch.zeros(((n_fog + 1) * nb * BLOCK_ELEMS,), dtype=torch.float32,
                          device=idx.device)
    fog_sum.index_add_(0, flat.reshape(-1), contrib.reshape(-1))
    return fog_sum.reshape(n_fog + 1, -1)[:n_fog, :d]


def wire_fold_ref(
    idx: torch.Tensor,        # (N, nb, k) int32, distinct within a (client, block)
    q: torch.Tensor,          # (N, nb, k) int8 codes (or f32 values)
    scale: torch.Tensor,      # (N, nb) f32 per-block scales
    fog_id: torch.Tensor,     # (N,) cluster id per client
    weights: torch.Tensor,    # (N,) f32
    out: torch.Tensor,        # (n_fog, d) f32 running sums, added to in place
) -> torch.Tensor:
    """:func:`wire_aggregate_ref` in ``wire_agg``'s own order: each
    coordinate of ``out`` takes ``(q * scale) * w`` of its fog's clients in
    index order, each added to the running value, so the result is the
    kernel's bit for bit.  Slots outside the real columns, and clients of
    ids outside [0, n_fog), are skipped.  The clients go in waves, the r-th
    member of every fog in wave r, so no two adds of a wave meet at a
    coordinate."""
    nb = idx.shape[1]
    d = out.shape[1]
    fog = fog_id.long()
    member, rank = fog_ranks(fog_id, out.shape[0])
    col = torch.arange(nb, device=idx.device)[None, :, None] * BLOCK_ELEMS + idx.long()
    real = (idx >= 0) & (idx < BLOCK_ELEMS) & (col < d)
    val = q.to(torch.float32) * scale[..., None] * weights.to(torch.float32)[:, None, None]
    flat = out.view(-1)
    for r in range(int(rank[member].max()) + 1 if bool(member.any()) else 0):
        wave = member & (rank == r)
        keep = real[wave]
        pos = (fog[wave][:, None, None] * d + col[wave])[keep]
        flat[pos] = flat[pos] + val[wave][keep]
    return out


def compress_aggregate_wire_ref(
    delta: torch.Tensor,      # (N, d)
    err: torch.Tensor,        # (N, d)
    fog_id: torch.Tensor,     # (N,)
    weights: torch.Tensor,    # (N,) f32
    n_fog: int,
    k: int,
    quantize: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Emit the wire, then scatter-add it: (fog_sum (n_fog, d), new_err
    (N, d)), equal to :func:`compress_aggregate_ref` up to f32 summation
    order.  The plain version of ``ops.compress_aggregate_wire``, the
    counterpart of the reference's one-shot wire operator."""
    idx, q, scale, new_err = compress_wire_ref(delta, err, k, quantize)
    return wire_aggregate_ref(idx, q, scale, fog_id, weights, n_fog, delta.shape[1]), new_err


def _fog_or_spill(fog_id: torch.Tensor, n_fog: int) -> torch.Tensor:
    """Each client's fog id as int64, with every id outside [0, n_fog)
    sent to row ``n_fog`` (-1 and ids above it go there; -1 by the
    remainder): a spill row the callers add into and discard, so such a
    client is dropped (``jax.ops.segment_sum``'s rule), never added into a
    fog.  Two device ops, on the round's path on the card too."""
    return torch.remainder(torch.clamp(fog_id.long(), -1, n_fog), n_fog + 1)


def segment_sum(x: torch.Tensor, fog_id: torch.Tensor, n_fog: int) -> torch.Tensor:
    """Sum of the rows of x (N, ...) per fog: (n_fog, ...), in O(N); rows
    whose id lies outside [0, n_fog) are dropped."""
    out = torch.zeros((n_fog + 1,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    return out.index_add_(0, _fog_or_spill(fog_id, n_fog), x)[:n_fog]


ROBUST_PAIR_BUDGET = 1 << 24   # (members x members x columns) elements per chunk


def robust_aggregate_ref(
    recon: torch.Tensor,      # (N, d) per-client reconstructions
    fog_id: torch.Tensor,     # (N,) cluster id per client
    weights: torch.Tensor,    # (N,) f32, zeroed for non-participants
    n_fog: int,
    trim_frac: float = 0.1,
    mode: str = "trimmed",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Coordinate-wise weighted trimmed mean (``mode="trimmed"``) or lower
    median (``"median"``) per fog, sort-free by tie-group interval overlap.

    Per fog m and coordinate, over the members i of m with weight > 0:
    A_i is the member weight strictly below v_i, g_i the member weight tied
    at v_i and W the fog's weight.  Trimmed: eff_i = w_i * max(min(A_i +
    g_i, (1 - beta) W) - max(A_i, beta W), 0) / g_i with beta the trim
    fraction clamped to [0, 0.4995] in f32; median: eff_i = w_i / g_i for
    the tie group with A_i < W/2 <= A_i + g_i.  out = sum eff_i v_i /
    max(sum eff_i, 1e-12); an empty fog gets zeros.

    Loops over the fogs and, within a fog, over chunks of coordinates so
    that the (members, members, columns) comparisons stay under
    ``ROBUST_PAIR_BUDGET`` elements at any fleet size.  Returns (fog_out
    (n_fog, d) f32, fog_weight (n_fog,) = the fogs' summed weights).
    """
    if mode not in ("trimmed", "median"):
        raise ValueError(f"robust mode must be 'trimmed' or 'median', got {mode!r}")
    v = recon.to(torch.float32)
    w = weights.to(torch.float32)
    n, d = v.shape
    fog_weight = segment_sum(w, fog_id, n_fog)
    out = torch.zeros((n_fog, d), dtype=torch.float32, device=v.device)
    beta = torch.clamp(torch.tensor(trim_frac, dtype=torch.float32), 0.0, 0.4995).to(v.device)
    for m in range(n_fog):
        members = torch.nonzero((fog_id == m) & (w > 0)).flatten()
        n_m = int(members.numel())
        if n_m == 0:
            continue
        vm, wm = v[members], w[members]
        big_w = torch.sum(wm)
        cols = max(1, ROBUST_PAIR_BUDGET // (n_m * n_m))
        for c0 in range(0, d, cols):
            x = vm[:, c0:c0 + cols]                               # (n_m, C)
            a = torch.einsum("ikc,k->ic", (x[None, :, :] < x[:, None, :]).to(torch.float32), wm)
            g = torch.einsum("ikc,k->ic", (x[None, :, :] == x[:, None, :]).to(torch.float32), wm)
            g_safe = torch.clamp_min(g, 1e-30)
            if mode == "median":
                half = 0.5 * big_w
                ratio = torch.where((a < half) & (half <= a + g), 1.0 / g_safe, 0.0)
            else:
                lo = torch.maximum(a, beta * big_w)
                hi = torch.minimum(a + g, (1.0 - beta) * big_w)
                ratio = torch.clamp_min(hi - lo, 0.0) / g_safe
            eff = wm[:, None] * ratio
            out[m, c0:c0 + cols] = torch.sum(eff * x, dim=0) / torch.clamp_min(
                torch.sum(eff, dim=0), 1e-12)
    return out, fog_weight


SWA_NEG_INF = -1e30   # the decode kernel's running-max start (swa_decode.cu)


def sliding_window_decode_attention_ref(
    q: torch.Tensor,          # (B, Hq, d) one query token per row
    k_cache: torch.Tensor,    # (B, S, Hkv, d)
    v_cache: torch.Tensor,    # (B, S, Hkv, d)
    cache_len: torch.Tensor,  # (B,) int32 valid entries per row
    window: int,              # attend to the last ``window`` positions
) -> torch.Tensor:
    """One-token GQA decode attention over positions [len - window, len)
    of each row's cache; (B, Hq, d) in q's dtype, computed in f32.

    The function of the ``swa_decode`` kernel: q is scaled by d**-0.5
    before the dot product, and the softmax takes the kernel's clips
    (exp(clip(s - m, -80, 0)), the sum floored at 1e-20), so a row with no
    position in its window gives zeros (the reference's oracle gives NaN
    there, and its plain branch the mean of the whole cache)."""
    b, hq, d = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    g = hq // hkv
    qg = q.reshape(b, hkv, g, d).to(torch.float32) * (d ** -0.5)
    scores = torch.einsum("bhgd,bshd->bhgs", qg, k_cache.to(torch.float32))
    pos = torch.arange(s, device=q.device)
    n = cache_len.to(torch.int64)[:, None]
    valid = ((pos < n) & (pos >= n - window))[:, None, None, :]         # (B, 1, 1, S)
    m = torch.amax(torch.where(valid, scores, float("-inf")), dim=-1, keepdim=True)
    m = torch.clamp_min(m, SWA_NEG_INF)
    p = torch.where(valid, torch.exp(torch.clamp(scores - m, -80.0, 0.0)), 0.0)
    acc = torch.einsum("bhgs,bshd->bhgd", p, v_cache.to(torch.float32))
    out = acc / torch.clamp_min(torch.sum(p, dim=-1, keepdim=True), 1e-20)
    return out.reshape(b, hq, d).to(q.dtype)
