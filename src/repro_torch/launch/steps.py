"""Step functions for the launchers.

Port of ``repro/launch/steps.py``:

  * ``train_round``  — one lockstep elastic round: per-replica forward/
    backward + masked SGD update (the paper's local updates; plain SGD —
    the momentum of Algorithm 2 lives at the global-model level in
    merge_step).
  * ``merge_step``   — Algorithm 2's weighted merge across the replica dim
    (the paper's all-reduce model merging) + replica reset broadcast.
  * ``prefill_step`` / ``decode_step`` — serving paths (no replica dim).

PyTorch runs eagerly, so a step is a plain function over the model's flat
replica trees (``models.model.make_model``: leaves (R, ...)). The round
and the merge are the trainer's own (``core.trainer.train_round`` and
``merge_replicas``), so ``train_round`` updates the replicas in place as
the trainer's rounds do.

**Over a mesh** (``make_partitioned_*``; the reference's jitted steps with
in/out shardings from ``sharding.rules``). The layout:

  * the replica dim R is split by hand over the replica sub-mesh (the mesh
    axes of ``MeshAxes.replica``: ``data``, ``(pod, data)``, ``pod`` or
    none), as the sharded placement splits it over its shards: each rank
    holds the contiguous block of R / n replicas at its coordinate there;
  * each replica's leaves are ``DTensor``s over the remaining mesh dims
    (the *inner* mesh: ``model``, or ``(data, model)`` for the pod-axis
    archs), placed by ``param_specs`` without its leading replica entry, and
    so is the batch, by ``train_batch_specs``; the model code runs on them
    as on plain tensors, under a sharding context whose ``shard`` calls
    redistribute them, and ``implicit_replication`` (a plain tensor the
    model makes, a position ``arange``, counts as replicated);
  * the merge takes each rank's weighted partial of its own replicas on its
    local shards (the ``weighted_merge`` kernel on the card, its no-momentum
    branch), sums the partials by ``all_reduce`` over the replica
    sub-mesh's groups, and adds the global momentum term once to the sum,
    as the sharded placement's merge does;
  * serving has no replica dim: parameters, batch and cache are DTensors
    over the whole mesh (``param_specs``, ``serve_specs``).

``layout_tree`` builds the DTensors from real tensors (each rank takes its
own chunk; nothing is sent) or from ``(shape, dtype)`` pairs under
``FakeTensorMode`` (the dry run).
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.adaptive_sgd import add_global_momentum
from repro_torch.core.trainer import dense_value_and_grad, merge_replicas
from repro_torch.core.trainer import train_round as _train_round
from repro_torch.kernels.weighted_merge.ops import merge_pytree
from repro_torch.models import model as MDL
from repro_torch.models.layers import contiguous_stride
from repro_torch.optim.sgd import SGDConfig
from repro_torch.sharding.annotate import is_dtensor, sharding_context
from repro_torch.sharding.rules import MeshAxes, Spec, leaf_shape, to_placements


def make_train_round(cfg: ModelConfig, sgd_cfg: SGDConfig = SGDConfig()):
    loss_fn = MDL.make_model(cfg).loss_fn

    def grads_fn(replicas, batch):
        return dense_value_and_grad(loss_fn, replicas, batch)

    def train_round(replicas, batch, lr_vec, update_mask):
        replicas, _, loss, aux = _train_round(grads_fn, replicas, None, batch, lr_vec,
                                              update_mask, sgd_cfg)
        return replicas, {"loss": loss, "accuracy": aux["accuracy"]}

    return train_round


def make_merge_step(cfg: ModelConfig, gamma: float = 0.9, keep_global: bool = True):
    """Algorithm 2 merge. keep_global=False = paper §4 memory-lean mode
    (no w̄/w̄_p copies; required for the ≥398B archs)."""
    if keep_global:
        def merge_step(replicas, alphas, global_model, prev_global):
            return merge_replicas(replicas, alphas, global_model, prev_global, gamma)
    else:
        def merge_step(replicas, alphas):
            return merge_replicas(replicas, alphas, None, None, 0.0)[1]

    return merge_step


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(params, batch):
        return MDL.prefill(cfg, params, batch)

    return prefill_step


def make_decode_step(cfg: ModelConfig, window: int = 0):
    def decode_step(params, cache, tokens):
        return MDL.decode_step(cfg, params, cache, tokens, window=window)

    return decode_step


# --------------------------------------------------------------------------
# over a mesh (module doc)
# --------------------------------------------------------------------------


def inner_mesh(mesh, ax: MeshAxes):
    """The mesh dims the replica dim does not use, as a sub-mesh."""
    names = tuple(n for n in mesh.mesh_dim_names if n not in ax.replica_dims)
    return mesh[names]


def replica_coordinate(mesh, ax: MeshAxes) -> tuple[int, int]:
    """(this rank's index, the count) over the replica sub-mesh, the first
    replica axis the major one."""
    index, count = 0, 1
    for name in ax.replica_dims:
        size = mesh.size(mesh.mesh_dim_names.index(name))
        index = index * size + mesh.get_local_rank(name)
        count *= size
    return index, count


def _local_shape(shape: tuple, placements, mesh) -> list:
    out = list(shape)
    for i, p in enumerate(placements):
        if p.is_shard():
            n = mesh.size(i)
            if out[p.dim] % n:
                raise ValueError(f"dim {p.dim} of {tuple(shape)} does not split over {n}")
            out[p.dim] //= n
    return out


def _local_chunk(t: torch.Tensor, placements, mesh) -> torch.Tensor:
    """This rank's chunk of the whole tensor ``t`` (mesh dims in order: a
    tensor dim sharded over two mesh dims splits major to minor)."""
    for i, p in enumerate(placements):
        if p.is_shard():
            t = t.chunk(mesh.size(i), dim=p.dim)[mesh.get_local_rank(i)]
    return t.contiguous()


def layout_leaf(leaf, spec: Spec, mesh, device=None):
    """One leaf as a DTensor over ``mesh`` placed by ``spec``: from a whole
    tensor (its local chunk, on ``device`` or the tensor's own) or from a
    ``(shape, dtype)`` pair (an empty local shard; under ``FakeTensorMode``
    a fake one). A non-tensor leaf (``cur_len``) is returned as it is."""
    from torch.distributed.tensor import DTensor

    if not isinstance(leaf, (torch.Tensor, tuple)):
        return leaf
    shape = leaf_shape(leaf)
    placements = to_placements(spec, mesh, ndim=len(shape))
    if isinstance(leaf, torch.Tensor):
        local = _local_chunk(leaf, placements, mesh)
        local = local.to(device) if device is not None else local
    else:
        local = torch.empty(_local_shape(shape, placements, mesh), dtype=leaf[1], device=device)
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=torch.Size(shape), stride=contiguous_stride(shape))


def _over(tree, specs, fn):
    """``fn(leaf, spec)`` over a tree of dicts and lists and its spec tree."""
    if isinstance(tree, dict):
        return {k: _over(v, specs[k], fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_over(v, sp, fn) for v, sp in zip(tree, specs)]
    return fn(tree, specs)


def layout_tree(tree, specs, mesh, device=None):
    """``layout_leaf`` over a tree of dicts and lists."""
    return _over(tree, specs, lambda x, spec: layout_leaf(x, spec, mesh, device))


def _replica_rows(leaf, mesh, ax: MeshAxes):
    """This rank's rows of the replica dim of a whole (R, ...) leaf, or of
    its ``(shape, dtype)`` pair."""
    index, count = replica_coordinate(mesh, ax)
    if isinstance(leaf, torch.Tensor):
        return leaf.chunk(count, dim=0)[index]
    shape = tuple(leaf[0])
    if shape[0] % count:
        raise ValueError(f"{shape[0]} replicas do not split over {count}")
    return ((shape[0] // count,) + shape[1:], leaf[1])


def layout_replicas(tree, specs, mesh, ax: MeshAxes, device=None):
    """A replica-stacked tree (leaves (R, ...), ``specs`` with the replica
    entry first: ``param_specs(..., with_replica_dim=True)`` or
    ``train_batch_specs``) as this rank's block of R / n replicas, each
    leaf a DTensor over the inner mesh (its replica dim not sharded)."""
    inner = inner_mesh(mesh, ax)
    return _over(tree, specs, lambda x, spec: layout_leaf(
        _replica_rows(x, mesh, ax), Spec(None, *spec[1:]), inner, device))


def _partitioned(mesh, rules):
    from torch.distributed.tensor.experimental import implicit_replication

    stack = contextlib.ExitStack()
    stack.enter_context(sharding_context(mesh, rules))
    stack.enter_context(implicit_replication())
    return stack


def _local(x):
    return x.to_local() if is_dtensor(x) else x


def make_partitioned_train_round(cfg: ModelConfig, mesh, sgd_cfg: SGDConfig = SGDConfig()):
    """``train_round`` over ``mesh`` (module doc): ``replicas`` and
    ``batch`` are this rank's replica block (``layout_replicas``; the
    flat parameter dict of ``make_model``), ``lr_vec`` and ``update_mask``
    its (R / n,) rows. Returns (replicas, {"loss", "accuracy"}), the
    metrics this block's (R / n,) plain tensors."""
    ax = MeshAxes(cfg, mesh)
    step = make_train_round(cfg, sgd_cfg)

    def train_round(replicas, batch, lr_vec, update_mask):
        with _partitioned(mesh, ax.activation_rules()):
            replicas, metrics = step(replicas, batch, lr_vec, update_mask)
        return replicas, {k: _local(v) for k, v in metrics.items()}

    return train_round


def _all_reduce_over(t: torch.Tensor, mesh, dims: tuple) -> torch.Tensor:
    import torch.distributed._functional_collectives as funcol

    for name in dims:
        t = funcol.all_reduce(t, "sum", (mesh, mesh.mesh_dim_names.index(name)))
        if isinstance(t, funcol.AsyncCollectiveTensor):
            t = t.wait()
    return t


def make_partitioned_merge_step(cfg: ModelConfig, mesh, gamma: float = 0.9,
                                keep_global: bool = True):
    """Algorithm 2's merge over ``mesh`` (module doc). ``replicas``: this
    rank's block (DTensors over the inner mesh), ``alphas`` its (R / n,)
    rows; ``global_model`` and ``prev_global`` DTensor trees over the inner
    mesh placed by ``param_specs``. Returns (new global, replicas reset to
    it), or with ``keep_global=False`` only the replicas."""
    ax = MeshAxes(cfg, mesh)

    def merged_global(replicas, alphas):
        local = {k: v.to_local() for k, v in replicas.items()}
        device = next(iter(local.values())).device
        alphas = (alphas.to(device, torch.float32) if isinstance(alphas, torch.Tensor)
                  else torch.as_tensor(np.asarray(alphas), dtype=torch.float32, device=device))
        partial = merge_pytree(local, alphas)   # the kernel's no-momentum branch
        return {k: _all_reduce_over(v, mesh, ax.replica_dims) for k, v in partial.items()}

    def as_like(local: dict, like: dict) -> dict:
        from torch.distributed.tensor import DTensor

        return {k: DTensor.from_local(v, like[k].device_mesh, like[k].placements,
                                      run_check=False) for k, v in local.items()}

    def reset(new_local: dict, replicas: dict) -> dict:
        from torch.distributed.tensor import DTensor

        n = next(iter(replicas.values())).to_local().shape[0]
        return {k: DTensor.from_local(v.unsqueeze(0).repeat((n,) + (1,) * v.ndim),
                                      replicas[k].device_mesh, replicas[k].placements,
                                      run_check=False) for k, v in new_local.items()}

    if keep_global:
        def merge_step(replicas, alphas, global_model, prev_global):
            m = merged_global(replicas, alphas)
            m = add_global_momentum(m, {k: v.to_local() for k, v in global_model.items()},
                                    {k: v.to_local() for k, v in prev_global.items()}, gamma)
            return as_like(m, global_model), reset(m, replicas)
    else:
        def merge_step(replicas, alphas):
            return reset(merged_global(replicas, alphas), replicas)

    return merge_step


def make_partitioned_prefill_step(cfg: ModelConfig, mesh):
    """``prefill_step`` over ``mesh``: parameters, batch (and logits) as
    DTensors over the whole mesh (``param_specs``, ``serve_specs``)."""
    rules = MeshAxes(cfg, mesh).serve_rules()

    def prefill_step(params, batch):
        with _partitioned(mesh, rules):
            return MDL.prefill(cfg, params, batch)

    return prefill_step


def make_partitioned_decode_step(cfg: ModelConfig, mesh, window: int = 0):
    """``decode_step`` over ``mesh``; the cache's DTensors are updated in
    place."""
    rules = MeshAxes(cfg, mesh).serve_rules()

    def decode_step(params, cache, tokens):
        with _partitioned(mesh, rules):
            return MDL.decode_step(cfg, params, cache, tokens, window=window)

    return decode_step
