"""The paper's hierarchical-FL communication pattern between pods, the
port of ``repro.core.mesh_fl``: a compressed selective-cooperation train
step of a language model.

Pods play the fog clusters; the cross-pod hop is the expensive
fog->gateway / fog->fog link.  One step:

  1. each pod takes its rows of the batch (pod p: rows [p B/P, (p+1) B/P))
     and computes its gradient of ``models/api.loss_fn`` (Eq. 13's fog
     aggregate), or, with ``local_epochs`` E > 1, runs E SGD passes over
     its rows on an f32 copy of the params (``optim/sgd.local_sgd``) and
     exchanges the parameter delta;
  2. per leaf, error feedback plus compression into compact wire buffers
     (Eqs. 30-31): ``int8`` mode, one int8 code per coordinate and one f32
     scale per leaf; ``topk`` mode, per 4096-element block the k largest
     |v| as int8 codes, int32 indices and one f32 scale;
  3. the one cross-pod collective, an ``all_gather`` of every pod's
     compressed buffers (fog-to-fog exchange, Eq. 15), where the reference
     replicates them by a sharding constraint;
  4. every pod decodes every pod's update and mixes them with fixed
     weights (Eq. 29), ``own_w recon_p + peer_w (sum - recon_p)``, then
     the gateway mean over pods (Eq. 16) and the SGD update, the same on
     every pod.

Two forms of the same step.  With a ``launch/sharding.ClientMesh`` rank r
is pod r: it holds its own pod's error-feedback buffers (params-shaped,
f32) and computes only its own pod's gradient.  Without one, ``n_pods``
pods run as a Python loop on one device (the reference's ``vmap``), with
error-feedback leaves shaped (n_pods, ...).  Both sum the pods in pod
order from the same decoded buffers, so they give the same bits, and
every rank's params are bitwise equal.

With a ``launch/sharding.PodDataMesh`` (the reference's ``("pod",
"data")`` axes) each pod is D ranks: rank (p, r) takes slot r of pod p's
rows, and its gradient (or each of the E > 1 passes' gradients) and loss
are mean-reduced in f32 over pod p's ``data`` group, as the reference's
in-pod collectives are.  The encode then runs on the same bits on the
pod's D ranks, so their error-feedback buffers are the same (the
reference's ``err`` is sharded over ``pod`` alone), and the gather runs
over the ``pod`` group.  D = 1 is the one-axis mesh, bit for bit.

Cross-pod traffic drops from 4 d bytes a pod (a dense f32 all-reduce) to
d + 4 bytes a leaf (``int8``) or about rho_s d 5 bytes (``topk``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch.launch import sharding
from repro_torch.models import api
from repro_torch.optim import sgd

BLOCK = 4096


def compress_compact(
    flat: torch.Tensor, rho_s: float
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Blockwise Top-K + int8 into compact wire buffers.

    flat: (n,) f32.  Returns (q int8 (nb, k), idx int32 (nb, k), scale f32
    (nb, 1)) with k = max(1, round(rho_s * 4096)); the zero-padded tail
    block is a block like the others.  The scale is max |survivor| times
    f32(1/127), the product the reference's jitted division computes.
    ``torch.topk`` leaves the order of tied magnitudes unspecified where
    ``jax.lax.top_k`` takes the lower index first, so which of several
    tied coordinates survive may differ from the reference's."""
    n = flat.shape[0]
    nb = -(-n // BLOCK)
    k = max(1, int(round(rho_s * BLOCK)))
    blocks = torch.zeros((nb * BLOCK,), dtype=torch.float32, device=flat.device)
    blocks[:n] = flat
    blocks = blocks.reshape(nb, BLOCK)
    idx = torch.topk(torch.abs(blocks), k, dim=1).indices            # (nb, k)
    vals = torch.gather(blocks, 1, idx)                                # signed survivors
    scale = torch.amax(torch.abs(vals), dim=1, keepdim=True) * (1.0 / 127.0)
    safe = torch.where(scale > 0, scale, 1.0)
    q = torch.clamp(torch.round(vals / safe), -127, 127).to(torch.int8)
    return q, idx.to(torch.int32), scale


def decompress_compact(
    q: torch.Tensor, idx: torch.Tensor, scale: torch.Tensor, n: int
) -> torch.Tensor:
    """Inverse of :func:`compress_compact` -> flat (n,) f32."""
    vals = q.to(torch.float32) * scale
    blocks = torch.zeros((q.shape[0], BLOCK), dtype=torch.float32, device=q.device)
    blocks.scatter_(1, idx.long(), vals)
    return blocks.reshape(-1)[:n]


def wire_bytes(d: int, rho_s: float) -> float:
    """Compact cross-pod payload per pod per exchange in ``topk`` mode
    (bytes): k int8 codes and k int32 indices a block, one f32 scale."""
    nb = -(-d // BLOCK)
    k = max(1, int(round(rho_s * BLOCK)))
    return nb * k * (1 + 4) + nb * 4


def payload_bytes(params: Any, mode: str = "int8", rho_s: float = 0.05) -> int:
    """Bytes one pod sends a step, the ``all_gather``'s input: every
    leaf's codes (int8), scales (f32) and in ``topk`` mode indices
    (int32), and the pod's f32 loss."""
    wire = _Wire([tuple(p.shape) for p in sgd.tree_leaves(params)], mode, rho_s)
    codes, scales = wire.codes[-1], wire.scales[-1] + 1
    return codes + 4 * scales + (4 * codes if mode == "topk" else 0)


def init_err(params: Any, n_pods: int | None = None) -> Any:
    """Zero f32 error-feedback buffers (Eq. 30) shaped as ``params``: with
    a leading axis of ``n_pods`` for the one-device loop, params-shaped
    (``n_pods=None``) for a rank of a mesh."""
    lead = () if n_pods is None else (n_pods,)
    return sgd.tree_unflatten(params, [
        torch.zeros(lead + tuple(p.shape), dtype=torch.float32, device=p.device)
        for p in sgd.tree_leaves(params)])


@dataclasses.dataclass
class _Payload:
    """One pod's compressed update, every leaf's buffers end to end: the
    int8 codes, the f32 scales (the pod's loss appended last) and, in
    ``topk`` mode, the int32 indices."""

    codes: torch.Tensor
    scales: torch.Tensor
    idx: torch.Tensor | None


class _Wire:
    """Per-leaf layout of a pod's payload, and the codec of each mode."""

    def __init__(self, shapes: list[tuple[int, ...]], mode: str, rho_s: float):
        if mode not in ("int8", "topk"):
            raise ValueError(f"mode must be 'int8' or 'topk', got {mode!r}")
        self.shapes, self.mode, self.rho_s = shapes, mode, rho_s
        self.codes, self.scales = [0], [0]        # running offsets per leaf
        k = max(1, int(round(rho_s * BLOCK)))
        for shape in shapes:
            n = 1
            for s in shape:
                n *= s
            nb = -(-n // BLOCK)
            self.codes.append(self.codes[-1] + (n if mode == "int8" else nb * k))
            self.scales.append(self.scales[-1] + (1 if mode == "int8" else nb))

    def encode(self, updates: list[torch.Tensor], errs: list[torch.Tensor],
               loss: torch.Tensor, data: Any = None) -> tuple[_Payload, list[torch.Tensor]]:
        """EF + compression of one pod's leaves: (payload, new error leaves).
        With ``data`` (the pod's data group) each update leaf is first
        mean-reduced over the group in f32, one leaf at a time."""
        codes, scales, idxs, new_errs = [], [], [], []
        for g, e in zip(updates, errs):
            v = (g.to(torch.float32) if data is None else data.mean_(g)) + e
            if self.mode == "int8":
                scale = torch.amax(torch.abs(v)).reshape(1) * (1.0 / 127.0)
                safe = torch.where(scale > 0, scale, 1.0)
                q = torch.clamp(torch.round(v / safe), -127, 127).to(torch.int8)
                new_errs.append(v - q.to(torch.float32) * safe)
                codes.append(q.reshape(-1))
            else:
                q, idx, scale = compress_compact(v.reshape(-1), self.rho_s)
                recon = decompress_compact(q, idx, scale, v.numel())
                new_errs.append(v - recon.reshape(v.shape))
                codes.append(q.reshape(-1))
                idxs.append(idx.reshape(-1))
                scale = scale.reshape(-1)
            scales.append(scale)
            del v
        scales.append(loss.detach().to(torch.float32).reshape(1))
        payload = _Payload(torch.cat(codes), torch.cat(scales),
                           torch.cat(idxs) if idxs else None)
        return payload, new_errs

    def decode(self, pay: _Payload, i: int) -> torch.Tensor:
        """Leaf ``i`` of a pod's payload, reconstructed (f32)."""
        shape = self.shapes[i]
        q = pay.codes[self.codes[i]:self.codes[i + 1]]
        scale = pay.scales[self.scales[i]:self.scales[i + 1]]
        if self.mode == "int8":
            return (q.to(torch.float32) * scale).reshape(shape)
        n = 1
        for s in shape:
            n *= s
        nb = scale.shape[0]
        idx = pay.idx[self.codes[i]:self.codes[i + 1]]
        return decompress_compact(q.reshape(nb, -1), idx.reshape(nb, -1), scale[:, None],
                                  n).reshape(shape)

    def mix(self, pays: list[_Payload], i: int, self_weight: float) -> torch.Tensor:
        """Leaf ``i``'s update: the mean over pods of each pod's mix
        ``own_w recon_p + peer_w (sum - recon_p)`` (Eq. 29), which is
        ``sum (own_w + (n - 1) peer_w) / n``; each pod decoded once and
        the pods summed in pod order."""
        n_pods = len(pays)
        own_w = self_weight
        peer_w = (1.0 - self_weight) / max(n_pods - 1, 1)
        total = self.decode(pays[0], i)
        for pay in pays[1:]:
            total += self.decode(pay, i)
        return total * ((own_w + (n_pods - 1) * peer_w) / n_pods)


def _gather(mesh: Any, t: torch.Tensor) -> list[torch.Tensor]:
    """Every rank's ``t`` (same shape on all), in rank order.  Gloo gathers
    only CPU tensors, so a CUDA tensor of a gloo group goes through the
    host."""
    staged = dist.get_backend(mesh.group) == "gloo" and t.device.type == "cuda"
    src = t.cpu() if staged else t.contiguous()
    out = [torch.empty_like(src) for _ in range(mesh.size)]
    dist.all_gather(out, src, group=mesh.group)
    return [o.to(t.device) for o in out] if staged else out


def make_pod_hfl_train_step(
    cfg: Any,
    mesh: Any = None,
    rho_s: float = 0.05,
    self_weight: float = 0.5,
    mode: str = "int8",
    local_epochs: int = 1,
    n_pods: int = 1,
) -> Callable:
    """Compressed hierarchical train step of a language model (module doc).

    ``mesh``: a ``launch/sharding.ClientMesh`` whose ranks are the pods
    (``n_pods`` is then its size), a ``launch/sharding.PodDataMesh`` (P
    pods of D data ranks: the module doc), or None for ``n_pods`` pods
    looped on one device.  Returns ``step(params, err, batch) -> (params', err',
    loss)``: ``batch`` the whole batch (every tensor's rows split evenly
    over the pods), ``err`` from :func:`init_err` (params-shaped on a
    rank, (n_pods, ...) leaves without a mesh), ``loss`` the mean of the
    pods' losses (with E > 1 each pod's mean over its passes).  Every leaf
    becomes ``(p.f32 + s upd).to(p.dtype)`` with s = -lr for a gradient
    (E = 1) and 1 for a delta.

    ``self_weight=0.5`` with 2 pods is the plain mean of the compressed
    pod updates; with one pod it halves the update (peer_w (sum - recon)
    is 0), as the reference's arithmetic does.  The E > 1 passes run on an
    f32 copy of the params: in bf16, |lr g| < |p| 2^-9 would round to
    nothing."""
    pods, data = ((mesh.pod, mesh.data) if isinstance(mesh, sharding.PodDataMesh)
                  else (mesh, None))
    if data is not None and data.size == 1:
        data = None
    n_data = 1 if data is None else data.size
    lfn = api.loss_fn(cfg, data)
    lr = cfg.learning_rate
    if pods is not None:
        n_pods = pods.size

    def pod_update(params, pb):
        """(loss, the pod's update leaves): a gradient (this rank's share of
        the pod's, reduced in ``encode``), or an E-pass delta (each pass
        reduced over the pod's data ranks)."""
        if local_epochs == 1:
            grads, loss = sgd.grad_and_value(lfn)(params, pb)
            if data is not None:
                loss = data.mean_(loss.clone())
            return loss, sgd.tree_leaves(grads)
        p32 = sgd.tree_unflatten(params, [
            p.to(torch.float32) if p.is_floating_point() else p
            for p in sgd.tree_leaves(params)])
        p1, loss = sgd.local_sgd(lfn, p32, [pb] * local_epochs, lr, data)
        return loss, [a - b for a, b in zip(sgd.tree_leaves(p1), sgd.tree_leaves(p32))]

    def rows(batch, p, r=0):
        """Slot r (of ``n_data``) of pod p's rows."""
        n = next(iter(batch.values())).shape[0]
        if n % (n_pods * n_data):
            raise ValueError(f"batch of {n} rows does not split over {n_pods} pods"
                             + (f" of {n_data} data ranks" if n_data > 1 else ""))
        per = n // (n_pods * n_data)
        at = (p * n_data + r) * per
        return {k: v[at:at + per] for k, v in batch.items()}

    def step(params, err, batch):
        leaves = sgd.tree_leaves(params)
        wire = _Wire([tuple(p.shape) for p in leaves], mode, rho_s)
        err_leaves = sgd.tree_leaves(err)
        if pods is not None:
            loss, upd = pod_update(params, rows(batch, pods.rank,
                                                0 if data is None else data.rank))
            pay, new_err = wire.encode(upd, err_leaves, loss,
                                       data if local_epochs == 1 else None)
            del upd
            parts = [_gather(pods, pay.codes), _gather(pods, pay.scales),
                     _gather(pods, pay.idx) if pay.idx is not None else [None] * n_pods]
            pays = [_Payload(*part) for part in zip(*parts)]
        else:
            pays, errs = [], []
            for p in range(n_pods):
                loss, upd = pod_update(params, rows(batch, p))
                pay, ne = wire.encode(upd, [e[p] for e in err_leaves], loss)
                del upd
                pays.append(pay)
                errs.append(ne)
            new_err = [torch.stack(col) for col in zip(*errs)]
        step_scale = -lr if local_epochs == 1 else 1.0
        new_params = []
        for i, p in enumerate(leaves):
            new_params.append(api.sgd_update(p, wire.mix(pays, i, self_weight), step_scale))
        total = pays[0].scales[-1]
        for pay in pays[1:]:
            total = total + pay.scales[-1]
        return (sgd.tree_unflatten(params, new_params), sgd.tree_unflatten(params, new_err),
                total / n_pods)

    return step
