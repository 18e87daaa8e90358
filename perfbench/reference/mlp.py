"""Plain PyTorch training of the paper's XML MLP under Adaptive SGD.

The reference the benchmark holds ``repro_torch`` to. It imports nothing of
the program. Each replica is a dict of plain tensors (``w1`` (NF, H), ``b1``
(H,), ``w2`` (H, NC), ``b2`` (NC,)), trained one replica and one batch at a
time:

* the sparse input layer as a gather of W1's rows, scaled and summed over
  the slots in f32;
* the head ``relu(h + b1) @ w2 + b2``, its log-softmax and the mean over a
  sample's labels of -log p, averaged over the valid samples, with autograd
  over the head only;
* plain SGD: the head's leaves densely, W1's touched rows by one
  ``index_add_`` of every slot's gradient;
* the non-finite guard (a replica that is not finite is re-cloned from the
  merge of the finite ones, weighted by batch size);
* Algorithm 2's merge: sum_i alpha_i w_i + gamma (global - previous
  global), in f32.

Plans, batch sizes, learning rates and merge weights come from
:mod:`.host`. ``fault`` plants one of the faults the benchmark's control
must catch: ``half_batch`` (every other valid sample of a batch left out,
the mean over the rest), ``no_exchange`` (the merge sums only the first
shard's replicas, as if the partials of the other cards never arrived).
"""
from __future__ import annotations

import numpy as np
import torch

from . import host
from .check import Trajectory, leaf_norms, weight_sum

# each fault, and the fewest shards a cell needs for it to differ from the
# reference (``no_exchange`` drops the other cards' replicas)
FAULTS = {"half_batch": 1, "no_exchange": 2}

UNIT_DIM = {"w1": 1, "b1": 0, "w2": 0}   # each leaf's hidden-unit dim


def unit_norms(tree: dict, base: dict, scale: float = 1.0) -> list:
    """The norm of ``tree - scale * base`` by hidden unit j: over column j
    of W1, b1[j] and row j of W2, in f64 (b2 has no hidden unit)."""
    sq = 0.0
    for k, dim in UNIT_DIM.items():
        d = tree[k].double() - scale * base[k].double()
        sq = sq + (d.square() if d.ndim == 1 else d.square().sum(dim=1 - dim))
    return sq.sqrt().tolist()


def pack(pool: dict, ids: np.ndarray, b_slots: int, k: int, n_lab: int, device) -> dict:
    """A padded batch of ``ids``: the first min(nnz, k) features and
    min(labels, n_lab) labels of each sample, ``b_slots`` rows."""
    def gather(ptr, data, width):
        starts = ptr[ids]
        counts = np.minimum(ptr[ids + 1] - starts, width)
        ar = np.arange(width)
        m = ar[None, :] < counts[:, None]
        pos = np.minimum(starts[:, None] + ar[None, :], len(data) - 1)
        out = np.zeros((b_slots, width), data.dtype)
        mask = np.zeros((b_slots, width), bool)
        out[:len(ids)] = np.where(m, data[pos], 0)
        mask[:len(ids)] = m
        return torch.from_numpy(out).to(device), torch.from_numpy(mask).to(device)

    idx, fmask = gather(pool["indptr"], pool["indices"], k)
    val, _ = gather(pool["indptr"], pool["values"], k)
    lab, lmask = gather(pool["label_ptr"], pool["labels"], n_lab)
    smask = torch.zeros(b_slots, dtype=torch.bool, device=device)
    smask[:len(ids)] = True
    return dict(idx=idx, val=val, fmask=fmask, lab=lab, lmask=lmask, smask=smask)


def sgd_round(p: dict, batch: dict, lr: float, fault: str | None) -> torch.Tensor:
    """One SGD step of one replica on one batch, in place; returns its loss."""
    smask = batch["smask"]
    if fault == "half_batch":
        smask = smask & (torch.arange(len(smask), device=smask.device) % 2 == 0)
    scale = torch.where(batch["fmask"], batch["val"], 0.0).float()              # (B, K)
    idx = batch["idx"].long()
    with torch.no_grad():
        h_lin = (p["w1"][idx].float() * scale[..., None]).sum(dim=1)              # (B, H)
    h_lin.requires_grad_(True)
    head = {k: p[k].detach().requires_grad_(True) for k in ("b1", "w2", "b2")}
    h = torch.relu(h_lin + head["b1"])
    logits = (h @ head["w2"] + head["b2"]).float()
    logp = torch.log_softmax(logits, dim=-1)
    lmask = batch["lmask"].float()
    per_sample = -(torch.gather(logp, 1, batch["lab"].long()) * lmask).sum(-1) \
        / lmask.sum(-1).clamp_min(1.0)
    s = smask.float()
    loss = (per_sample * s).sum() / s.sum().clamp_min(1.0)
    dh, *dhead = torch.autograd.grad(loss, [h_lin] + list(head.values()))
    with torch.no_grad():
        live = batch["fmask"]
        slot_grad = (scale[..., None] * dh[:, None, :])[live]                    # (S, H)
        p["w1"].index_add_(0, idx[live], (-lr * slot_grad).to(p["w1"].dtype))
        for k, g in zip(head, dhead):
            p[k].copy_(p[k].float() - lr * g.float())
    return loss.detach()


def merge(reps: list, alphas: np.ndarray, glob: dict, prev: dict) -> dict:
    """sum_i alpha_i w_i + gamma (glob - prev), leaf by leaf in f32."""
    a = torch.as_tensor(alphas, dtype=torch.float32)
    out = {}
    for k in reps[0]:
        acc = torch.zeros_like(reps[0][k], dtype=torch.float32)
        for i, rep in enumerate(reps):
            acc += a[i].item() * rep[k].float()
        acc += host.GAMMA * (glob[k].float() - prev[k].float())
        out[k] = acc.to(reps[0][k].dtype)
    return out


def finite(tree: dict) -> bool:
    return all(bool(torch.isfinite(v).all()) for v in tree.values())


def train(w0: dict, pool: dict, traffic: dict, seed: int, n_megabatches: int,
          readings: list | None = None, n_shards: int = 1, fault: str | None = None
          ) -> Trajectory:
    """The first ``n_megabatches`` mega-batches of Adaptive SGD from the
    weights ``w0`` on the train ``pool``. ``readings``: the measured
    windows, under a measured speed model; ``n_shards``: the cards the
    replicas are split over (``no_exchange`` keeps the first card's)."""
    if fault is not None and fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}; known: {', '.join(FAULTS)}")
    replay = host.Replay(traffic, pool["indptr"], pool["label_ptr"], seed, readings)
    R, device = replay.R, w0["w1"].device
    reps = [{k: v.clone() for k, v in w0.items()} for _ in range(R)]
    glob, prev = w0, w0
    n_param = sum(v.numel() for v in w0.values())
    out = Trajectory()
    for k in range(n_megabatches):
        plan, b, lr, b_next, lr_next = replay.step()
        lr32 = torch.as_tensor(lr, dtype=torch.float32)
        round_losses = []
        for row in plan.grid:
            losses = [sgd_round(reps[i], pack(pool, ids, replay.b_max, replay.max_nnz,
                                              replay.max_labels, device),
                                lr32[i].item(), fault)
                      for i, ids in enumerate(row) if ids is not None]
            round_losses.append(torch.stack(losses).double().mean().item())
        ok = [finite(rep) for rep in reps]
        if not all(ok):
            if not any(ok):
                reps = [{k: v.clone() for k, v in glob.items()} for _ in range(R)]
            else:
                w = np.where(ok, b, 0.0)
                donor = merge([rep for rep, good in zip(reps, ok) if good],
                              (w / w.sum())[np.asarray(ok)], glob, glob)
                reps = [rep if good else {k: v.clone() for k, v in donor.items()}
                        for rep, good in zip(reps, ok)]
        norms = np.array([np.sqrt(sum(torch.linalg.vector_norm(
            v, dtype=torch.float64).item() ** 2 for v in rep.values())) for rep in reps])
        alphas = host.merge_weights(plan.u, b, norms / n_param)
        kept = R // n_shards if fault == "no_exchange" else R
        new = merge(reps[:kept], alphas[:kept], glob, prev)
        prev, glob = glob, new
        reps = [{k: v.clone() for k, v in new.items()} for _ in range(R)]
        out.losses.append(float(np.mean(round_losses)))
        out.decisions.append(dict(u=plan.u.tolist(), n_rounds=plan.n_rounds,
                                  b=b_next.tolist(), lr=lr_next.tolist(),
                                  alphas=np.round(alphas, 4).tolist()))
        if k == 0:
            # the first merge's weighted sum of the replicas' SGD updates:
            # global_1 = sum_i alpha_i w_i, and the weights need not sum to 1
            out.update1 = leaf_norms(glob, w0, weight_sum(alphas))
            out.update1_units = unit_norms(glob, w0, weight_sum(alphas))
    out.change = leaf_norms(glob, w0)
    return out


def replay_decisions(pool: dict, traffic: dict, seed: int, n_megabatches: int,
                     readings: list | None = None) -> list:
    """The host decisions (u, n_rounds, b and lr after Algorithm 1) of the
    first ``n_megabatches`` mega-batches, with no device work: every
    mega-batch of a run's window can be held to them."""
    replay = host.Replay(traffic, pool["indptr"], pool["label_ptr"], seed, readings)
    out = []
    for _ in range(n_megabatches):
        plan, _, _, b_next, lr_next = replay.step()
        out.append(dict(u=plan.u.tolist(), n_rounds=plan.n_rounds, b=b_next.tolist(),
                        lr=lr_next.tolist()))
    return out
