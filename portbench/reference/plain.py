"""Plain PyTorch versions of the round's kernels: the client phase, the
error-feedback top-k int8 compressor with the fog sums, the chunked wire,
and the weighted trimmed mean.

Frozen copies of ``src/repro_torch/kernels/ref.py`` at commit
503575e07401e7f10a9c0026dea9d563d82ebbba (``local_train_ref``,
``bisect_threshold``, ``_dense_recon``, ``dense_fold_ref``,
``compress_wire_ref``, ``wire_fold_ref``, ``fog_ranks``, ``segment_sum``),
the fog sums summed in the kernels' own client order.  The trimmed mean
is rewritten from ``robust_aggregate_ref``'s definition to run all fogs
at once, padded to the largest fog.

``lowp``: every matrix product takes its operands rounded to TF32 (10
mantissa bits, to nearest) and accumulates in f32, as the card's TF32
tensor cores do: the benchmark's lower-precision control.
"""
from __future__ import annotations

import torch

BISECT_ITERS = 32
BLOCK_ELEMS = 8192


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 (f32 with the low 13 mantissa bits cleared,
    to nearest, ties away from zero)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def bmm(a: torch.Tensor, b: torch.Tensor, lowp: bool) -> torch.Tensor:
    return torch.bmm(tf32(a), tf32(b)) if lowp else torch.bmm(a, b)


def matmul(a: torch.Tensor, b: torch.Tensor, lowp: bool) -> torch.Tensor:
    return torch.matmul(tf32(a), tf32(b)) if lowp else torch.matmul(a, b)


def local_train(x, idx, ws, bs, lr: float, lowp: bool = False):
    """E epochs of minibatch SGD on the autoencoder loss for every client,
    each minibatch indexed out of its window; weights with a leading trial
    axis B start the clients in B runs of N / B.  The backward pass is
    written out (tanh' = 1 - a^2, dL/dz_out = (2 / bsz)(recon - x)).
    Returns (deltas (N, d) in the ravel order: per layer the bias, then the
    row-major weight; the mean step loss (N,))."""
    n, steps, bsz = idx.shape
    n_layers = len(ws)
    anchor_w, anchor_b = list(ws), list(bs)
    if anchor_b[0].dim() == 2:
        per = n // anchor_b[0].shape[0]
        anchor_w = [w.repeat_interleave(per, dim=0) for w in anchor_w]
        anchor_b = [b.repeat_interleave(per, dim=0) for b in anchor_b]
    cur_w = [w.expand(n, *w.shape[-2:]).clone() for w in anchor_w]
    cur_b = [b.expand(n, b.shape[-1]).clone() for b in anchor_b]
    rows = torch.arange(n, device=x.device)[:, None]
    inv_b = 1.0 / bsz
    loss_sum = torch.zeros((n,), dtype=torch.float32, device=x.device)
    for s in range(steps):
        xb = x[rows, idx[:, s].long()]
        acts = [xb]
        h = xb
        for li in range(n_layers):
            h = bmm(h, cur_w[li], lowp) + cur_b[li][:, None, :]
            if li < n_layers - 1:
                h = torch.tanh(h)
            acts.append(h)
        diff = h - xb
        loss_sum = loss_sum + torch.sum(diff * diff, dim=(1, 2)) * inv_b
        g = (2.0 * inv_b) * diff
        for li in range(n_layers - 1, -1, -1):
            a_prev = acts[li]
            dw = bmm(a_prev.transpose(1, 2), g, lowp)
            db = torch.sum(g, dim=1)
            if li > 0:
                g_prev = bmm(g, cur_w[li].transpose(1, 2), lowp) * (1.0 - a_prev * a_prev)
            cur_w[li] = cur_w[li] - lr * dw
            cur_b[li] = cur_b[li] - lr * db
            if li > 0:
                g = g_prev
    deltas = torch.cat([
        part for w, b, aw, ab in zip(cur_w, cur_b, anchor_w, anchor_b)
        for part in ((b - ab).reshape(n, -1), (w - aw).reshape(n, -1))
    ], dim=1)
    return deltas, loss_sum / steps


def bisect_threshold(absx: torch.Tensor, k: int, hi: torch.Tensor) -> torch.Tensor:
    """Magnitude threshold t with |{i : absx_i > t}| <= k, maximal keep,
    by 32 bisection steps from (-1, block max)."""
    lo = torch.full(absx.shape[:-1] + (1,), -1.0, dtype=absx.dtype, device=absx.device)
    for _ in range(BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        take = torch.sum(absx > mid, dim=-1, keepdim=True) > k
        lo = torch.where(take, mid, lo)
        hi = torch.where(take, hi, mid)
    return hi


def pad_blocks(x: torch.Tensor) -> torch.Tensor:
    n, d = x.shape
    nb = max(1, -(-d // BLOCK_ELEMS))
    return torch.nn.functional.pad(x, (0, nb * BLOCK_ELEMS - d)).reshape(n, nb, BLOCK_ELEMS)


def block_k(k_frac: float) -> int:
    return max(1, int(round(k_frac * BLOCK_ELEMS)))


def blockwise_k_frac(d: int, rho_s: float) -> float:
    """Per-block keep fraction: rho_s of the real coordinates, the padded
    tail block keeping at most its real ones."""
    nb = max(1, -(-d // BLOCK_ELEMS))
    tail = d - (nb - 1) * BLOCK_ELEMS
    target = max(1, round(rho_s * d))
    k = target / nb
    if nb > 1 and k > tail:
        k = (target - tail) / (nb - 1)
    return min(1.0, k / BLOCK_ELEMS)


def dense_recon(delta, err, k: int):
    """EF top-k by bisection, then the int8 round trip at scale max|v| /
    127: (v, recon), both (N, nb, BLOCK_ELEMS)."""
    v = pad_blocks(delta + err)
    absv = torch.abs(v)
    amax = torch.amax(absv, dim=-1, keepdim=True)
    sparse = torch.where(absv > bisect_threshold(absv, k, amax), v, 0.0)
    scale = amax * (1.0 / 127.0)
    safe = torch.where(scale > 0, scale, 1.0)
    q = torch.clamp(torch.round(sparse / safe), -127.0, 127.0)
    return v, torch.where(scale > 0, q * scale, 0.0)


def fog_ranks(fog_id: torch.Tensor, n_fog: int):
    """(member, rank): whether a client's id lies in [0, n_fog), and its
    place among its fog's clients in index order."""
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


def segment_sum(x: torch.Tensor, fog_id: torch.Tensor, n_fog: int) -> torch.Tensor:
    """Rows of x summed per fog; ids outside [0, n_fog) dropped."""
    spill = torch.remainder(torch.clamp(fog_id.long(), -1, n_fog), n_fog + 1)
    out = torch.zeros((n_fog + 1,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    return out.index_add_(0, spill, x)[:n_fog]


def _waves(fog_id, n_fog):
    member, rank = fog_ranks(fog_id, n_fog)
    n_waves = int(rank[member].max()) + 1 if bool(member.any()) else 0
    return member, rank, n_waves


def dense_fold(delta, err, fog_id, weights, n_fog: int, k: int):
    """The one-shot fog reduce: (fog sums (n_fog, d) unnormalised, new_err
    (N, d)), each fog's clients added in index order."""
    n, d = delta.shape
    v, recon = dense_recon(delta, err, k)
    val = weights[:, None] * recon.reshape(n, -1)[:, :d]
    out = torch.zeros((n_fog, d), dtype=torch.float32, device=delta.device)
    member, rank, n_waves = _waves(fog_id, n_fog)
    fog = fog_id.long()
    for r in range(n_waves):
        wave = member & (rank == r)
        rows = fog[wave]
        out[rows] = out[rows] + val[wave]
    return out, (v - recon).reshape(n, -1)[:, :d]


def compress_wire(delta, err, k: int):
    """The sparse wire of a chunk of clients: (idx (N, nb, k), q (N, nb,
    k) int8, scale (N, nb), new_err (N, d)); slots ordered by |v|
    descending, ties to the lower index, then non-survivors with code 0."""
    n, d = delta.shape
    v = pad_blocks(delta + err)
    absv = torch.abs(v)
    amax = torch.amax(absv, dim=-1, keepdim=True)
    survive = absv > bisect_threshold(absv, k, amax)
    k = min(int(k), BLOCK_ELEMS)
    idx = torch.sort(torch.where(survive, absv, -1.0), dim=-1, descending=True,
                     stable=True).indices[..., :k]
    kept = torch.gather(survive, -1, idx)
    v_slots = torch.gather(v, -1, idx)
    vals = torch.where(kept, v_slots, 0.0)
    scale = (amax * (1.0 / 127.0))[..., 0]
    safe = torch.where(scale > 0, scale, 1.0)[..., None]
    q = torch.clamp(torch.round(vals / safe), -127.0, 127.0)
    recon_vals = torch.where(scale[..., None] > 0, q * scale[..., None], 0.0)
    new_err = v.scatter(-1, idx, v_slots - recon_vals)
    return idx.to(torch.int32), q.to(torch.int8), scale, new_err.reshape(n, -1)[:, :d]


def wire_fold(idx, q, scale, fog_id, weights, out):
    """Add a chunk's wire into the running fog sums ``out`` in place, each
    fog's clients in index order."""
    nb = idx.shape[1]
    d = out.shape[1]
    fog = fog_id.long()
    member, rank, n_waves = _waves(fog_id, out.shape[0])
    col = torch.arange(nb, device=idx.device)[None, :, None] * BLOCK_ELEMS + idx.long()
    real = (idx >= 0) & (idx < BLOCK_ELEMS) & (col < d)
    val = q.to(torch.float32) * scale[..., None] * weights[:, None, None]
    flat = out.view(-1)
    for r in range(n_waves):
        wave = member & (rank == r)
        keep = real[wave]
        pos = (fog[wave][:, None, None] * d + col[wave])[keep]
        flat[pos] = flat[pos] + val[wave][keep]


def trimmed_mean(recon, fog_id, weights, n_fog: int, beta: float,
                 budget: int = 1 << 26) -> torch.Tensor:
    """Coordinate-wise weighted trimmed mean per fog over its members of
    weight > 0: with A_i the member weight strictly below v_i, g_i the
    weight tied at v_i and W the fog's total, eff_i = w_i max(min(A_i +
    g_i, (1 - beta) W) - max(A_i, beta W), 0) / g_i and the fog's value
    sum eff_i v_i / max(sum eff_i, 1e-12); zeros for an empty fog.  The
    fogs go ``budget`` pair elements at a time, padded to the largest."""
    n, d = recon.shape
    dev = recon.device
    fog = fog_id.long()
    keep = (fog >= 0) & (fog < n_fog) & (weights > 0)
    member, rank = fog_ranks(torch.where(keep, fog, n_fog).to(torch.int32), n_fog)
    c_max = int(rank[member].max()) + 1 if bool(member.any()) else 1
    pad_v = torch.zeros((n_fog, c_max, d), dtype=torch.float32, device=dev)
    pad_w = torch.zeros((n_fog, c_max), dtype=torch.float32, device=dev)
    pad_v[fog[member], rank[member]] = recon[member]
    pad_w[fog[member], rank[member]] = weights[member]
    b = torch.clamp(torch.tensor(beta, dtype=torch.float32), 0.0, 0.4995).to(dev)
    out = torch.zeros((n_fog, d), dtype=torch.float32, device=dev)
    step = max(1, budget // (c_max * c_max * d))
    for f0 in range(0, n_fog, step):
        x, wm = pad_v[f0:f0 + step], pad_w[f0:f0 + step]
        big_w = torch.sum(wm, dim=-1)[:, None, None]
        wk = wm[:, None, :, None]
        a = torch.sum((x[:, None, :, :] < x[:, :, None, :]) * wk, dim=2)
        g = torch.sum((x[:, None, :, :] == x[:, :, None, :]) * wk, dim=2)
        lo = torch.maximum(a, b * big_w)
        hi = torch.minimum(a + g, (1.0 - b) * big_w)
        eff = wm[..., None] * (torch.clamp_min(hi - lo, 0.0) / torch.clamp_min(g, 1e-30))
        out[f0:f0 + step] = torch.sum(eff * x, dim=1) / torch.clamp_min(
            torch.sum(eff, dim=1), 1e-12)
    return out
