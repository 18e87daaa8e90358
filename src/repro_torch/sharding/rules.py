"""Partition rules: how the sharded placement splits R replicas over
devices (the replica mesh), and how the partitioned program lays out every
parameter, batch and cache leaf over a ``DeviceMesh`` (the specs, second
half of this file).

Port of ``repro/sharding/rules.py``. Replica mesh: A mesh is a tuple
of ``torch.device``s, one per shard; shard s holds the contiguous block
``replica_block(R, len(mesh), s)`` of the replica dim. A mesh may name one
device more than once: ``("cpu",) * 4`` is four logical shards on the CPU
(the counterpart of the reference's forced host device count), and
``("cuda:0",) * 4`` four shards on one card, each with its own stream.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

#: name of the replica mesh's one axis (``core.algorithms.replica_axis_name``)
REPLICA_AXIS = "replica"


def replica_mesh_size(n_replicas: int, n_devices: int) -> int:
    """Largest device count <= ``n_devices`` that divides ``n_replicas``:
    every shard owns the same number of replicas, so the merge is a plain
    sum of equal-size partials."""
    return next(d for d in range(min(n_replicas, n_devices), 0, -1)
                if n_replicas % d == 0)


def mesh_devices(devices=None) -> tuple:
    """``devices`` as a tuple of ``torch.device``s (a bare ``"cuda"`` gets
    the current card's index); ``None`` means every visible CUDA device,
    and raises where there is none: the CPU runs only when named."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass CPU devices to run the sharded "
                "placement on the CPU"
            )
        return tuple(torch.device("cuda", i) for i in range(torch.cuda.device_count()))
    out = []
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        out.append(d)
    if not out:
        raise ValueError("a replica mesh needs at least one device")
    return tuple(out)


def global_replica_devices(multihost=None) -> list:
    """The fleet's devices as ``(process, device)`` pairs, ordered by
    (process, local index): each process's devices form one contiguous
    block and every process derives the same list (the reference's order
    of ``jax.devices()`` across ``jax.distributed`` processes). Slot block
    p of the replica dim lands on process p's devices.

    ``multihost`` — a ``launch.multihost.MultihostContext``: its local
    devices (every visible card when it names none) are gathered from every
    process. Without one, this process's visible cards."""
    if multihost is None:
        return [(0, d) for d in mesh_devices(None)]
    local = mesh_devices(multihost.local_devices)
    # one leaf (an array of names): every process's tree has one shape
    gathered = multihost.allgather("devices", np.asarray([str(d) for d in local]))
    return [(pid, torch.device(str(name))) for pid in sorted(gathered)
            for name in gathered[pid]]


def replica_mesh(n_replicas: int, devices=None) -> tuple:
    """The mesh for ``n_replicas``: the first ``replica_mesh_size`` of
    ``devices`` (``mesh_devices``'s rule for ``None``)."""
    devices = mesh_devices(devices)
    return devices[: replica_mesh_size(n_replicas, len(devices))]


def replica_block(n_replicas: int, n_shards: int, shard: int) -> slice:
    """The rows of the replica dim that ``shard`` holds: a contiguous block
    of ``n_replicas // n_shards`` (the reference's ``replica_spec``)."""
    if n_replicas % n_shards:
        raise ValueError(f"{n_replicas} replicas do not split over {n_shards} shards")
    rows = n_replicas // n_shards
    return slice(shard * rows, (shard + 1) * rows)


class ReplicaMeshPool:
    """The devices of an elastic population, and one mesh per shard count.

    A resize may need a mesh of another shard count (4 replicas over 4
    devices shrinking to 2 over 2). ``mesh_for`` picks the count by
    ``replica_mesh_size`` and returns the same tuple object every time a
    count recurs, so the trainer's executors, cached per count, are reused.
    """

    def __init__(self, devices=None):
        self.devices = mesh_devices(devices)
        self._meshes: dict[int, tuple] = {}

    def mesh_for(self, n_replicas: int) -> tuple:
        n = replica_mesh_size(n_replicas, len(self.devices))
        mesh = self._meshes.get(n)
        if mesh is None:
            mesh = self.devices[:n]
            self._meshes[n] = mesh
        return mesh

    def adopt(self, mesh) -> None:
        """Seed the pool with a mesh built outside it (the trainer's
        ``mesh=``), so its shard count reuses it as it is."""
        mesh = mesh if isinstance(mesh, tuple) else mesh_devices(mesh)
        self._meshes[len(mesh)] = mesh


# --------------------------------------------------------------------------
# the partitioned program: specs for every parameter, batch and cache leaf
# --------------------------------------------------------------------------
#
# Port of the parameter-spec half of ``repro/sharding/rules.py``. Two
# replica granularities:
#   * replica_axis='data'  (small/mid archs): the elastic-replica dim R is
#     sharded over `data`; tensor-parallel over `model`; no FSDP.
#   * replica_axis='pod'   (jamba/arctic/kimi): R is sharded over `pod`
#     (multi-pod only); within a replica params are FSDP/expert-parallel
#     over `data` + TP over `model`.
#
# Rules are first-fit with divisibility: each leaf has an ordered list of
# candidate specs; the first whose sharded dims divide evenly is used (GQA
# kv=8 heads cannot split over model=16, so the kv projection falls back to
# FSDP-only, like Megatron's replicated-KV TP groups).
#
# The rules read only the mesh's axis sizes: ``mesh`` is a
# ``torch.distributed.device_mesh.DeviceMesh`` with named dims, or a mapping
# from axis name to size (``{"data": 16, "model": 16}``), so the production
# meshes' specs need no process group of 256 or 512 ranks.


class Spec(tuple):
    """A partition spec: one entry per tensor dim (from the first), each
    ``None`` (not sharded), a mesh-axis name, or a tuple of names (the dim
    sharded over several mesh dims, major to minor). Trailing dims a spec
    does not name are not sharded. The counterpart of JAX's
    ``PartitionSpec``, as a plain tuple: ``Spec(None, "model")``."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}" if len(self) != 1 else f"Spec({self[0]!r})"


def mesh_shape(mesh) -> dict:
    """{axis name: size} of a named ``DeviceMesh`` or of a mapping."""
    if isinstance(mesh, dict):
        return dict(mesh)
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        raise ValueError("a partitioned mesh needs named dims")
    return dict(zip(names, (int(s) for s in mesh.shape)))


def axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    shape = mesh_shape(mesh)
    if isinstance(axis, (tuple, list)):
        return int(np.prod([shape[a] for a in axis]))
    return int(shape[axis])


def first_fit(shape, candidates, mesh) -> Spec:
    """First candidate spec whose sharded dims are all divisible."""
    for spec in candidates:
        if all(ax is None or dim % axis_size(mesh, ax) == 0 for dim, ax in zip(shape, spec)):
            return Spec(*spec)
    return Spec()


class MeshAxes:
    """Resolved mesh-axis roles for one (cfg, mesh) pair."""

    def __init__(self, cfg, mesh):
        if getattr(cfg, "kv_lora_rank", 0) > 0:
            raise ValueError(
                f"{cfg.name}: the partitioned program of a latent-attention (MLA) config "
                "needs sharding rules for its leaves (wkv_a, kv_norm, wkv_b, the held "
                "experts, the shared experts) and a partitioned dropless MoE, which the "
                "port does not have; it trains on one device a replica (ElasticTrainer)")
        self.mesh = mesh
        self.tp = "model"
        multi_pod = "pod" in mesh_shape(mesh)
        if cfg.replica_axis == "pod":
            self.replica = "pod" if multi_pod else None
            self.fsdp = "data" if cfg.fsdp else None
            self.ep = "data" if cfg.expert_parallel else None
            self.batch = "data"
        else:
            # elastic replicas over data (x pod in multi-pod mode)
            self.replica = ("pod", "data") if multi_pod else "data"
            self.fsdp = None
            self.ep = None
            self.batch = None

    @property
    def n_replicas(self) -> int:
        return axis_size(self.mesh, self.replica)

    @property
    def replica_dims(self) -> tuple:
        """The mesh axes the replica dim is split over (none, one or two)."""
        if self.replica is None:
            return ()
        return tuple(self.replica) if isinstance(self.replica, tuple) else (self.replica,)

    def activation_rules(self) -> dict:
        """Logical-axis mapping consumed by sharding.annotate (training)."""
        return {
            "replica": self.replica,
            "batch": self.batch,
            "heads": self.tp,
            "ff": self.tp,
            "experts": self.ep if self.ep else self.tp,
        }

    def serve_rules(self) -> dict:
        """Serving has no replica dim: batch spans (pod?, data)."""
        multi_pod = "pod" in mesh_shape(self.mesh)
        return {
            "replica": None,
            "batch": ("pod", "data") if multi_pod else "data",
            "heads": self.tp,
            "ff": self.tp,
            "experts": self.ep if self.ep else self.tp,
        }


def _is_leaf(x) -> bool:
    """A tensor, a ``(shape, dtype)`` pair (``launch.specs``), a
    ``torch.Size`` or a Python number (the cache's ``cur_len``)."""
    if isinstance(x, (torch.Tensor, torch.Size, int, float)):
        return True
    return (isinstance(x, tuple) and len(x) == 2 and isinstance(x[0], (tuple, torch.Size))
            and isinstance(x[1], torch.dtype))


def leaf_shape(x) -> tuple:
    if isinstance(x, torch.Tensor):
        return tuple(x.shape)
    if isinstance(x, torch.Size):
        return tuple(x)
    if isinstance(x, (int, float)):
        return ()
    return tuple(x[0])


def tree_map_with_path(fn, tree, path: tuple = ()):
    """``fn(path, leaf)`` over a tree of dicts and lists; ``path`` holds
    the dict keys and list indices from the root, as strings (the
    reference's key path)."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, list) or (isinstance(tree, tuple) and not _is_leaf(tree)):
        out = [tree_map_with_path(fn, v, path + (str(i),)) for i, v in enumerate(tree)]
        return out if isinstance(tree, list) else tuple(out)
    return fn(path, tree)


def _leaf_spec(keys: tuple, shape: tuple, ax: MeshAxes, mesh) -> Spec:
    name = keys[-1]
    in_blocks = any(k.startswith("pos") for k in keys) or "layers" in keys
    # stacked groups carry a leading (G,) dim
    eff = shape[1:] if in_blocks else shape
    tp, fsdp, ep = ax.tp, ax.fsdp, ax.ep
    # expert-parallel and FSDP may share the same mesh axis ('data'); a
    # single spec cannot repeat an axis, so experts win and the expert
    # weights' non-expert dims fall back to TP-only.
    fsdp_e = None if (ep is not None and ep == fsdp) else fsdp

    def fit(cands):
        spec = first_fit(eff, cands, mesh)
        return Spec(*((None,) + tuple(spec))) if in_blocks else spec

    if name == "table" or name == "lm_head":
        return fit([(tp, fsdp), (None, tp), (fsdp, None), ()])
    if name == "router":
        return fit([(fsdp, None), ()])
    if name in ("wq", "wk", "wv") and len(eff) == 3:
        return fit([(fsdp, tp, None), (fsdp, None, None), ()])
    if name == "wo" and len(eff) == 3:
        if "ffn" in keys:  # MoE expert out: (E, F, D)
            return fit([(ep, tp, fsdp_e), (ep, tp, None), (None, tp, None), ()])
        return fit([(tp, None, fsdp), (None, None, fsdp), ()])  # attn out
    if name in ("wi", "wg") and len(eff) == 3:  # MoE expert in: (E, D, F)
        return fit([(ep, fsdp_e, tp), (ep, None, tp), (None, None, tp), ()])
    if name in ("wi", "wg") and len(eff) == 2:  # dense MLP in: (D, F)
        return fit([(fsdp, tp), (None, tp), ()])
    if name == "wo" and len(eff) == 2:  # dense MLP out: (F, D)
        return fit([(tp, fsdp), (tp, None), ()])
    if name == "in_proj":
        return fit([(fsdp, tp), (None, tp), ()])
    if name == "out_proj":
        return fit([(tp, fsdp), (tp, None), ()])
    if name == "conv_w":
        return fit([(None, tp), ()])
    if name == "conv_b":
        return fit([(tp,), ()])
    if name in ("A_log", "D", "dt_bias"):
        return fit([(tp,), ()])
    if name == "frontend_proj":
        return fit([(None, tp), ()])
    # norms, biases, everything else: replicated
    return fit([()])


def param_specs(cfg, params, mesh, with_replica_dim: bool = False):
    """The spec tree of a parameter tree (nested, ``models.model.init``'s;
    or flat, keyed by dotted path), optionally with a leading replica
    dim."""
    ax = MeshAxes(cfg, mesh)

    def spec(path, leaf):
        keys = tuple(k for p in path for k in p.split("."))
        shape = leaf_shape(leaf)
        s = _leaf_spec(keys, shape[1:] if with_replica_dim else shape, ax, mesh)
        return Spec(*((ax.replica,) + tuple(s))) if with_replica_dim else s

    return tree_map_with_path(spec, params)


def train_batch_specs(cfg, batch, mesh):
    """Batch leaves have layout (R, B, ...)."""
    ax = MeshAxes(cfg, mesh)
    return tree_map_with_path(
        lambda path, leaf: Spec(ax.replica, ax.batch, *((None,) * (len(leaf_shape(leaf)) - 2))),
        batch)


def serve_specs(cfg, tree, mesh):
    """Serving has no replica dim: batch over (pod?, data), TP over model.

    Cache leaves: (B, S, Hkv, hd) / (B, K, C) / (B, H, P, N) — batch-shard
    first dim when divisible, then try TP on the head-ish dim.
    """
    multi_pod = "pod" in mesh_shape(mesh)
    bat = ("pod", "data") if multi_pod else "data"
    tp = "model"

    def spec(path, leaf):
        keys = path
        if keys and keys[-1] == "cur_len":
            return Spec()
        shape = leaf_shape(leaf)
        # grouped block caches carry a leading (n_groups,) dim
        grouped = any(k.startswith("pos") for k in keys)
        eff = shape[1:] if grouped else shape
        cands = []
        if len(eff) == 4:  # kv cache or ssm state (B, S, Hkv, hd)/(B,H,P,N)
            cands = [
                (bat, None, tp, None),
                (bat, None, None, None),
                (None, None, tp, None),
                (None, tp, None, None),
            ]
        elif len(eff) == 3:  # conv cache / frontend embeds (B, K, C)
            cands = [(bat, None, tp), (bat, None, None), (None, None, tp)]
        elif len(eff) == 2:  # tokens (B, S)
            cands = [(bat, None), (None, None)]
        elif len(eff) == 1:
            cands = [(bat,), (None,)]
        s = first_fit(eff, cands + [()], mesh)
        return Spec(*((None,) + tuple(s))) if grouped else s

    return tree_map_with_path(spec, tree)


def to_placements(spec: Spec, mesh, ndim: Optional[int] = None) -> list:
    """A spec as DTensor placements over ``mesh`` (a named ``DeviceMesh``):
    one ``Shard(d)`` or ``Replicate()`` per mesh dim. A tensor dim named
    by a tuple of axes is sharded over those mesh dims, the first the major
    one (JAX's order): DTensor shards the mesh dims' placements left to
    right, so the tuple's axes must appear in mesh order, as every rule
    here writes them. ``ndim`` checks the spec against the tensor's rank.
    The counterpart of the reference's ``to_named``."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    if ndim is not None and len(spec) > ndim:
        raise ValueError(f"spec {spec} names {len(spec)} dims of a rank-{ndim} tensor")
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        axes = tuple(ax) if isinstance(ax, (tuple, list)) else (ax,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} are not in the mesh's order {names}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"spec {spec} uses mesh axis {names[i]!r} twice")
            out[i] = Shard(d)
    return out

