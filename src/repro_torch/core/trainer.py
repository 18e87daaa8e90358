"""ElasticTrainer: the mega-batch training engine, in PyTorch.

Port of ``repro/core/trainer.py`` on one process. Everything that
distinguishes one algorithm from another lives in the strategy the
``core/algorithms`` registry resolves from ``cfg.algorithm``; the engine
drives it through its hooks:

  init_state_extras → plan → round_transforms → merge → adapt

Placements, as in the reference (``cfg.placement``):

  * ``vmap`` (default) — every replica on the trainer's device, each round
    one batched program over the leading R dim.
  * ``sharded`` — the replica dim split over a replica mesh
    (``sharding.rules``: a tuple of devices, ``mesh=`` or one drawn from a
    ``ReplicaMeshPool``): shard s holds a contiguous block of the replica
    and momentum leaves (a ``utils.tree.ShardedTree``) on its device and
    runs the same round, mega-batch and merge code as ``vmap`` on that
    block, in a worker thread of its own with a CUDA stream of its own
    (``sharding.executor.ShardExecutor``, one per shard count, cached).
    Where the reference has collectives the shards meet at a rendezvous
    over the replica axis, summing in shard order: the metric sums, the
    live gate of a round, the algorithms' in-round means
    (``replica_axis_name``), the merge's partials (``normalized_merge``'s
    axis branch, the momentum term added to the complete sum); norms and
    finite rows are gathered per shard. Globals live once, on the mesh's
    first device (copied once per other device where a shard needs them).
    Staging packs each shard's column block of the plan into the staging
    slot and uploads it on the shard's stream; a measured speed model gets
    one window per shard (``ShardWindowTimer``). With one shard the
    trajectory is the vmap one's, bitwise on the CPU.

The engine is the reference's ``scan``: the plan's payloads are stacked
into (n_rounds, R, ...) arrays and uploaded once per mega-batch; a Python
loop runs the rounds on the device, each one a batched forward/backward
over all R replicas and an in-place SGD update; the per-round loss /
accuracy / sample counts reduce on the device with the reference's
normalization, and the host reads them once per mega-batch. Rounds are not
padded to a power of two: the reference's padding rounds are masked no-ops
that only bound XLA recompiles.

Gradients: the model's row-sparse ``sparse_grad_fn`` when it has one and
``sparse_grads`` is True; otherwise dense autograd through ``loss_fn``
(the reference's ``jax.vmap(jax.value_and_grad(loss_fn))``, its oracle for
the sparse path), which reaches ``w1`` through ``spmm``'s backward kernel.
The LM (``models.model.make_model``) has only the dense path; its kernel
flags must be off, since its kernels have no backward (``make_model``
refuses them).

``train_round`` and ``merge_replicas`` are the round and the merge as
plain functions; the engine and ``launch.steps`` both run them.

Elastic membership and faults, as in the reference: ``resize`` changes the
replica count between mega-batches (a final normalized merge folds every
current replica in; survivors carry their state, joiners clone the merged
global with zero momentum), ``remove_replicas`` evicts given slots (a
crashed replica's rows are zeroed and its merge weight is 0), the
non-finite guard heals poisoned replicas before the barrier, and
``checkpoint_payload``/``restore_checkpoint`` write and read the
reference's crash-consistent checkpoint format (``checkpoint.store``).
``run`` drives them from a resize schedule, a ``core.fleet``
``FleetController`` and a ``CheckpointManager``. Every merge among them
goes through the ``weighted_merge`` kernel on the card; under the sharded
placement a resize or a restore redraws the mesh from the pool and moves
the state onto it.

Multi-process training (``multihost=``, a ``launch.multihost.
MultihostContext``; the sharded placement only): every
process runs the identical host loop at the *global* R (the same plans,
b/lr adaptation, speed model and fleet decisions) and holds only its
contiguous block of replica slots (``_span_slice``) on a process-local
mesh (the context's local devices). Host-side vectors (b, lr, alphas, the
plan grid's columns) stay global and each shard reads its own global rows.
The context completes what crosses processes: the merge's partial (each
shard's no-momentum ``weighted_merge``, summed over the local shards, then
over the processes; the alpha mass rides along and renormalizes the sum
when a peer died mid-mega-batch; the momentum term added once, in f32), the
mega-batch's metric sums (``allreduce_sum`` before the f32 normalization),
the replica norms and finite masks (``allgather``) and the checkpoint's
rows. Under a host span it does so through the file exchange and refuses
algorithms with in-round collectives; under a device span the replica
axis's collectives themselves cross processes (``sharding.executor``), so
the merge and metric sums are complete when the shards return.
Membership changes at process grain only: ``remove_replicas`` evicts whole
process blocks (survivors renumbered first, the local width unchanged, so
no executor is rebuilt) and ``resize`` refuses.

Staging, on both paths: the plan, its fused pack into one of two
``StagingBuffers`` slots (pinned on the card) and one asynchronous upload
on the current stream; the slot is released at the barrier. The
overlapped mega-batch pipeline (``overlap=True``, the default):
``run_megabatch`` issues mega-batch N's rounds from a pre-staged plan and,
before the one host sync that collects N's metrics, does N+1's host work
while the device runs N: the merge-cost clock bump, ``algo.adapt``, then
N+1's staging, queued behind N's rounds. The host-stateful steps keep the
sequential order (… plan N → clock bump N → plan N+1 …), so a run is
bitwise the sequential one's on the CPU (``overlap=False``, the oracle:
stage, rounds, collect, barrier). A staged plan is revocable:
``invalidate_prefetch`` rolls the provider, clocks and speed model back
to the snapshot taken before it was planned (a resize, an eviction, a
stall's start or end, a restore), and a checkpoint taken while it is
staged stores that snapshot, so a restore replays it. ``run`` evaluates
asynchronously: the test set is uploaded once, evaluation is issued at a
boundary and collected at the next.

The speed model behind the scheduler's virtual clock is the simulated
``SpeedModel`` (the default) or a ``MeasuredSpeedModel``, which closes the
paper's §3.1 feedback loop: each mega-batch's window, from ``begin`` just
before its rounds are issued to ``elapsed`` just after their metrics are
collected, is attributed per replica by its scheduled share
(``_observe_window``), and the next plan runs on those relative speeds;
under the sharded placement each shard's own window
(``ShardWindowTimer``) goes to ``observe_shards`` instead. The timer is
read exactly twice a mega-batch, at the reference's points, so the same
readings give the same plans. Under the pipeline plan N+1 is made before
window N is observed (one window stale), as in the reference.
``keep_global_copies=False`` is the paper's §4 memory-lean merging: the
algorithms that keep global/prev-global copies (``adaptive``,
``elastic``) start without them and merge without the momentum term until
their barriers have produced both.

Device rule: ``device=None`` means CUDA and raises where there is none;
the CPU runs only when asked for (``device="cpu"``, or a mesh of CPU
devices), as the tests do. Under the sharded placement ``mesh=None`` means
every visible card (or ``[device]`` when a device is given). On the card
the input layer and the merge run in the port's CUDA kernels.
"""
from __future__ import annotations

import collections
import copy
import dataclasses
import time
import weakref
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.checkpoint import store as ckpt_store
from repro_torch.configs.base import ElasticConfig
from repro_torch.core import adaptive_sgd as asgd
from repro_torch.core import algorithms
from repro_torch.core.heterogeneity import (
    CostModel,
    MeasuredSpeedModel,
    ShardWindowTimer,
    SpeedModel,
)
from repro_torch.core.scheduler import DynamicScheduler
from repro_torch.data.batcher import StagingBuffers
from repro_torch.models.protocol import TrainableModel
from repro_torch.optim.sgd import SGDConfig, init_momentum, sgd_update
from repro_torch.sharding.executor import ShardExecutor
from repro_torch.sharding.rules import REPLICA_AXIS, ReplicaMeshPool, mesh_devices, replica_block
from repro_torch.utils import trace
from repro_torch.utils import tree as tu
from repro_torch.utils.device import resolve_device
from repro_torch.utils.logging import MetricsLog, log

MERGE_COST = 5e-3  # default virtual seconds charged per merge (the all-reduce)
PLACEMENTS = ("vmap", "sharded")
# the trainer's own arrays in a staging slot, beside the provider's fields
_STAGED_MASK, _STAGED_LR = "_update_mask", "_lr"


@dataclass
class ElasticState:
    replicas: Any                    # leaves (R, ...); a ShardedTree if sharded
    global_model: Optional[dict]
    prev_global: Optional[dict]
    momentum: Any                    # as replicas, or None
    b: np.ndarray                    # per-replica batch size (may be fractional)
    lr: np.ndarray                   # per-replica learning rate
    megabatch_idx: int = 0


@dataclass
class _PlanView:
    """The slice of ElasticState the planning hook reads (``algo.plan``
    consumes only b / lr / the index): lets the overlap pipeline plan
    mega-batch N+1 from ``adapt``'s outputs before N's merged state
    exists."""

    b: np.ndarray
    lr: np.ndarray
    megabatch_idx: int


@dataclass
class _StagedMegaBatch:
    """A staged mega-batch: plan, device tensors, and (staged ahead) the
    cursor snapshot that makes it revocable.

    ``snapshot`` holds the provider's stream state, the virtual clocks and
    the speed model's state from before the staging plan ran:
    ``invalidate_prefetch`` rolls the trainer back to it, and
    ``checkpoint_payload`` stores it, so a checkpoint taken while this
    mega-batch is staged restores to replay it. A staging for the
    mega-batch about to run is never revoked, and takes none.
    """

    plan: Any                 # MegaBatchPlan
    shards: list              # per shard, on its device: (batches, mask, lr)
    mask_host: np.ndarray     # host (n_rounds, R) mask: which rounds have a live replica
    b: np.ndarray             # host copies the plan was made for (validation)
    lr: np.ndarray
    megabatch_idx: int
    n_replicas: int
    slot_id: int              # its StagingBuffers slot
    snapshot: Optional[dict]  # pre-staging cursor state (see above)


def _to_device(arrays: dict, device: torch.device, non_blocking: bool = False) -> dict:
    """Host arrays (numpy or torch) as tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device, non_blocking=non_blocking)
            for k, v in arrays.items()}


def _close_executors(executors: dict) -> None:
    for ex in executors.values():
        ex.close()


def _nested(tree: Optional[dict]) -> Optional[dict]:
    """A flat parameter dict as the nested tree its dotted keys spell (the
    layout checkpoints store, as the reference's pytrees do)."""
    return None if tree is None else tu.unflatten(tree)


def _json_cursor(cursor):
    """A provider cursor (``provider.cursor()``) in its ``state_dict``
    form, as checkpoint metadata stores it: arrays as lists."""
    if isinstance(cursor, dict):
        return {k: _json_cursor(v) for k, v in cursor.items()}
    return cursor.tolist() if isinstance(cursor, np.ndarray) else cursor


def dense_value_and_grad(loss_fn, replicas: dict, batch: dict):
    """((loss, aux), grads) of every replica on its own batch, by autograd
    through ``loss_fn`` over the replica-stacked leaves. The leaves share
    storage with ``replicas``, and replica r's loss depends on replica r's
    parameters alone, so the gradient of the summed loss is every replica's
    own gradient."""
    leaves = {k: p.detach().requires_grad_(True) for k, p in replicas.items()}
    with torch.enable_grad():
        loss, aux = loss_fn(leaves, batch)
        grads = torch.autograd.grad(loss.sum(), list(leaves.values()))
    aux = {k: v.detach() for k, v in aux.items()}
    return (loss.detach(), aux), dict(zip(leaves, grads))


def train_round(grads_fn, replicas, momentum, batch, lr_vec, update_mask, sgd: SGDConfig,
                transforms=None, live: bool = True):
    """One lockstep round over all R replicas: ``grads_fn``'s batched loss
    and gradients, the algorithm's gradient transform, then the in-place
    SGD update. ``live`` (host) says whether any replica is unmasked; a
    round without one leaves the replicas as they are, the post-round hook
    included. Returns (replicas, momentum, loss, aux)."""
    (loss, aux), grads = grads_fn(replicas, batch)
    if transforms is not None and transforms.grad_transform is not None:
        grads = transforms.grad_transform(grads, update_mask)
    replicas, momentum = sgd_update(
        replicas, grads, lr_vec, sgd, momentum_state=momentum, update_mask=update_mask,
    )
    if transforms is not None and transforms.post_round is not None and live:
        replicas = transforms.post_round(replicas)
    return replicas, momentum, loss, aux


def merge_replicas(replicas, alphas, global_model, prev_global, gamma):
    """Normalized merge (Alg. 2 tensor math): returns (new_global,
    replicas reset to it). gamma=0 / None globals skip the global-momentum
    term — a plain weighted average."""
    new_global = asgd.normalized_merge(replicas, alphas, global_model, prev_global, gamma)
    n_replicas = next(iter(replicas.values())).shape[0]
    return new_global, tu.tree_broadcast_replicas(new_global, n_replicas)


@dataclass
class ElasticTrainer:
    model: TrainableModel
    provider: Any
    cfg: ElasticConfig
    sgd: SGDConfig = field(default_factory=SGDConfig)
    base_lr: float = 0.05
    speed: Optional[SpeedModel | MeasuredSpeedModel] = None
    seed: int = 0
    device: Any = None               # None = CUDA (raises without a card)
    sparse_grads: bool = True        # use the model's row-sparse grad path if
                                     # it provides one; False = dense autograd
    merge_cost: float = MERGE_COST   # virtual seconds per merge (all-reduce)
    keep_global_copies: bool = True  # False = paper §4 memory-lean merging
    overlap: bool = True             # overlapped mega-batch pipeline (module
                                     # doc); False = the sequential oracle
    mesh: Any = None                 # replica mesh for cfg.placement='sharded'
                                     # (devices; None = every visible card)
    multihost: Any = None            # launch.multihost.MultihostContext: span
                                     # this trainer across processes (module
                                     # doc). None = one process.

    def __post_init__(self):
        if self.cfg.placement not in PLACEMENTS:
            raise ValueError(
                f"cfg.placement must be one of {PLACEMENTS}, got {self.cfg.placement!r}"
            )
        self._sharded = self.cfg.placement == "sharded"
        self._axis = algorithms.replica_axis_name(self.cfg)
        self.algo = algorithms.get(self.cfg.algorithm)
        self._mesh_pool = None
        self._executors: dict = {}       # shard count -> ShardExecutor
        self._executor = None
        self._span = None                # the MultihostContext, when spanning
        if self.multihost is not None:
            self._setup_span()
        if self._sharded:
            self._setup_mesh()
        elif self.mesh is not None:
            raise ValueError("a replica mesh needs cfg.placement='sharded'")
        else:
            self.device = resolve_device(self.device)
        self.init_seconds = None  # set by init_state
        if self.speed is None:
            self.speed = SpeedModel(self.cfg.n_replicas, seed=self.seed)
        # one window per shard for a measured speed model (sharded only)
        self._shard_timer = (
            ShardWindowTimer()
            if self._sharded and isinstance(self.speed, MeasuredSpeedModel) else None
        )
        self.cost = CostModel(self.speed)
        self.scheduler = DynamicScheduler(self.cfg, self.cost)
        self._transforms = self.algo.round_transforms(self.cfg)
        self._eval_batches = None        # the test set, uploaded once
        self._eval_batches_src = None    # pins the staged list + its payloads
        self._eval_batches_key = None    # fingerprint of that list
        self._staged = None              # prefetched _StagedMegaBatch
        self._staging = StagingBuffers(pin_memory=self.device.type == "cuda")
        # one entry a staged mega-batch: host seconds to snapshot the
        # cursors (0.0 unless staged ahead), plan, pack and upload, and the
        # bytes uploaded
        self.staging_log = collections.deque(maxlen=1024)

    # ------------------------------------------------------------------
    # process spanning
    # ------------------------------------------------------------------
    def _setup_span(self) -> None:
        """Validate and adopt a multi-process context: this process runs the
        global host loop but holds only its own block of replica slots. The
        refusals are the reference's: the vmap placement has no per-shard
        executors to localize, the process-local
        mesh is built here, a measured speed model would feed each process
        other factors and fork the plans, and (host span) in-round
        collectives cannot cross the file exchange."""
        ctx = self.multihost
        span = f"{ctx.spanning}-span multihost"
        if self.cfg.placement != "sharded":
            raise ValueError(f"{span} needs cfg.placement='sharded'")
        if self.mesh is not None:
            raise ValueError(f"{span} builds its own process-local mesh; do not pass one")
        if isinstance(self.speed, MeasuredSpeedModel):
            raise ValueError(
                f"{span} needs the simulated SpeedModel: every process must plan from "
                "identical speed factors"
            )
        if ctx.spanning == "host" and getattr(self.algo, "round_collectives", False):
            raise ValueError(
                f"algorithm {self.cfg.algorithm!r} reduces across replicas inside every "
                "round (round_collectives=True); its collectives cannot span processes on "
                "the host-exchange path"
            )
        ctx.assign_slots(self.cfg.n_replicas)
        self._span = ctx

    def _mesh_width(self) -> int:
        """The replica count the local mesh holds: this process's block
        under a span, the global R otherwise."""
        return self._span.local_count() if self._span is not None else self.cfg.n_replicas

    def _span_slice(self) -> slice:
        """This process's rows of any global (R, ...) array."""
        if self._span is None:
            return slice(None)
        lo, hi = self._span.local_bounds()
        return slice(lo, hi)

    def process_slots(self, pid: int) -> Optional[list[int]]:
        """Global replica slots of fleet process ``pid`` (None when not
        spanning or unknown): the FleetController's resolution of
        process-grain events."""
        if self._span is None:
            return None
        return self._span.slots_of(pid)

    # ------------------------------------------------------------------
    # the sharded placement: mesh, executors, per-shard work
    # ------------------------------------------------------------------
    def _setup_mesh(self) -> None:
        """The replica mesh and its pool (the reference's ``mesh=None``:
        every visible card, or the given device, or under a span the
        context's local devices; a given mesh must split R evenly and seeds
        the pool), the home device (the mesh's first: the globals,
        evaluation, checkpoints) and the executor."""
        if self.mesh is None:
            devices = None if self.device is None else [self.device]
            if self._span is not None and self._span.local_devices:
                devices = self._span.local_devices
            self._mesh_pool = ReplicaMeshPool(devices)
            self.mesh = self._mesh_pool.mesh_for(self._mesh_width())
        else:
            self.mesh = mesh_devices(self.mesh)
            if self.cfg.n_replicas % len(self.mesh):
                raise ValueError(
                    f"n_replicas={self.cfg.n_replicas} not divisible by the replica mesh "
                    f"({len(self.mesh)} devices)"
                )
            # a resize may need meshes of other shard counts: drawn from
            # the devices the caller chose
            self._mesh_pool = ReplicaMeshPool(self.mesh)
            self._mesh_pool.adopt(self.mesh)
        home = self._mesh_pool.devices[0]
        if self.device is not None and mesh_devices([self.device])[0] != home:
            raise ValueError(f"device {self.device} is not the mesh's first device {home}")
        self.device = resolve_device(home)
        weakref.finalize(self, _close_executors, self._executors)
        self._install_executor()

    def _install_executor(self) -> None:
        """The executor of the current mesh's shard count: built once,
        reused by every later resize back to that count."""
        n = len(self.mesh)
        if n not in self._executors:
            # the device span's replica axis runs across the processes
            cross = None
            if (self._span is not None and self._span.spanning == "device"
                    and self._span.n_processes > 1):
                cross = self._span
            self._executors[n] = ShardExecutor(self.mesh, REPLICA_AXIS, cross=cross)
        self._executor = self._executors[n]

    def close(self) -> None:
        """Stop the sharded placement's worker threads (a no-op under vmap;
        they are daemons, and are stopped when the trainer is collected)."""
        _close_executors(self._executors)
        self._executors.clear()
        self._executor = None

    @property
    def _n_shards(self) -> int:
        return len(self.mesh) if self._sharded else 1

    def _rows(self, s: int) -> slice:
        """The rows of this process's replica trees that shard ``s`` holds
        (all of them under vmap)."""
        if not self._sharded:
            return slice(0, self.cfg.n_replicas)
        return replica_block(self._mesh_width(), len(self.mesh), s)

    def _grows(self, s: int) -> slice:
        """Shard ``s``'s rows of the global (R,) host vectors: ``_rows``
        offset by this process's block under a span."""
        rows = self._rows(s)
        lo = self._span.local_bounds()[0] if self._span is not None else 0
        return slice(lo + rows.start, lo + rows.stop)

    def _shard_device(self, s: int) -> torch.device:
        return self.mesh[s] if self._sharded else self.device

    def _shards(self, fn, *trees) -> list:
        """``fn(s, *blocks)`` for every shard, the results in shard order:
        under vmap once, inline, on the whole trees; under sharded in every
        shard's worker (its device and stream current, the replica axis
        bound), on the shard's blocks. A tree is a replica tree in the
        placement's layout, or None."""
        if not self._sharded:
            return [fn(0, *trees)]
        blocks = [[None] * len(self.mesh) if t is None else t.blocks for t in trees]
        return self._executor.run(lambda s: fn(s, *(b[s] for b in blocks)))

    def _layout(self, blocks: list):
        """Per-shard blocks as the placement's replica tree."""
        if blocks[0] is None:
            return None
        return tu.ShardedTree(blocks) if self._sharded else blocks[0]

    def _replicated(self, tree: Optional[dict]) -> dict:
        """``tree`` (no replica dim) on every device of the mesh: one copy a
        distinct device, keyed by device (the tree itself on its own). The
        bytes copied between devices count as the open span's
        ``copy_bytes``."""
        if tree is None:
            return {}
        devices = dict.fromkeys(self.mesh if self._sharded else (self.device,))
        moved = sum(l.numel() * l.element_size() for d in devices for l in tree.values()
                    if l.device != d)
        if moved:
            trace.add("copy_bytes", moved)
        return {d: tu.tree_map(lambda l, d=d: l.to(d), tree) for d in devices}

    def _whole(self, tree):
        """A replica tree as one (R, ...) dict on the home device."""
        return tree.gather(self.device) if isinstance(tree, tu.ShardedTree) else tree

    def _take_rows(self, tree, rows, n_total: int, fill: Optional[dict] = None):
        """A new replica tree of ``n_total`` replicas in the current layout:
        replica j is a copy of ``tree``'s replica ``rows[j]`` (``tree`` in
        either layout, on the devices it was on), and every replica past
        ``len(rows)`` is ``fill`` (one replica) or zeros."""
        src = tree.blocks if isinstance(tree, tu.ShardedTree) else [tree]
        per_src = next(iter(src[0].values())).shape[0]
        per_dst = n_total // self._n_shards
        fills = self._replicated(fill)

        def row(j, k, dev):
            if j < len(rows):
                b, i = divmod(rows[j], per_src)
                return src[b][k][i:i + 1].to(dev)
            like = src[0][k]
            if fill is None:
                return torch.zeros((1,) + like.shape[1:], dtype=like.dtype, device=dev)
            return fills[dev][k].to(like.dtype).unsqueeze(0)

        return self._layout([
            {k: torch.cat([row(j, k, self._shard_device(s))
                           for j in range(s * per_dst, (s + 1) * per_dst)]) for k in src[0]}
            for s in range(self._n_shards)
        ])

    def _broadcast(self, tree: dict):
        """``tree`` copied into every replica, in the current layout."""
        copies = self._replicated(tree)
        return self._layout([
            tu.tree_broadcast_replicas(copies[self._shard_device(s)],
                                       self._rows(s).stop - self._rows(s).start)
            for s in range(self._n_shards)
        ])

    # ------------------------------------------------------------------
    # tensor math exposed to Algorithm.merge implementations
    # ------------------------------------------------------------------
    def merge_models(self, replicas, alphas, global_model, prev_global, gamma):
        """``merge_replicas`` under the placement: (new_global, replicas
        reset to it). Under sharded, every shard merges its own replicas
        and the partials are summed over the shards (``normalized_merge``'s
        axis branch)."""
        return self._merge(replicas, alphas, global_model, prev_global, gamma)

    def _merge(self, replicas, alphas, global_model, prev_global, gamma, broadcast=True):
        """(new global on the home device, the replicas reset to it in the
        placement's layout, or None without ``broadcast``)."""
        if self._span is not None:
            return self._merge_spanning(replicas, alphas, global_model, prev_global, gamma,
                                        broadcast)
        if not self._sharded:
            if broadcast:
                return merge_replicas(replicas, alphas, global_model, prev_global, gamma)
            return asgd.normalized_merge(replicas, alphas, global_model, prev_global,
                                         gamma), None
        alphas = np.asarray(alphas, np.float64)
        g, gp = self._replicated(global_model), self._replicated(prev_global)

        def one(s, block):
            dev, rows = self.mesh[s], self._rows(s)
            new = asgd.normalized_merge(block, alphas[rows], g.get(dev), gp.get(dev), gamma,
                                        axis=self._axis)
            return new, (tu.tree_broadcast_replicas(new, rows.stop - rows.start)
                         if broadcast else None)

        outs = self._shards(one, replicas)
        return outs[0][0], self._layout([o[1] for o in outs]) if broadcast else None

    def _merge_spanning(self, replicas, alphas, global_model, prev_global, gamma,
                        broadcast=True):
        """Algorithm 2's merge across processes.

        ``alphas`` is the global (R,) weight vector. Each local shard
        computes its share of the weighted sum through ``weighted_merge``'s
        no-momentum branch, summed over the local shards in shard order
        (``normalized_merge``'s axis branch); under a device span that axis
        already crosses the processes. Under a host span the exchange sums
        the processes' partials in process order, and the contributed alpha
        mass rides along: when a peer died mid-mega-batch its partial is
        absent, and scaling the sum by the expected over the contributed
        mass is exactly ``remove_replicas``' crash semantics (the dead
        replicas' weight redistributes over the survivors). The
        global-momentum term is added once, to the sum, in f32, as the
        one-process path adds it."""
        span = self._span
        lo, hi = span.local_bounds()
        a = np.asarray(alphas, np.float64)
        outs = self._shards(
            lambda s, block: asgd.normalized_merge(block, a[self._grows(s)], None, None, 0.0,
                                                   axis=self._axis),
            replicas)
        merged = outs[0]
        if span.spanning == "host":
            payload = {"partial": _nested(merged), "mass": np.float64(a[lo:hi].sum())}
            total, contributors = span.allreduce_sum("merge", payload)
            flat = tu.flatten(total["partial"])
            scale = None
            if len(contributors) < len(span.active_processes()):
                contributed = float(total["mass"])
                if contributed <= 0.0:
                    raise FloatingPointError(
                        "every process holding nonzero merge weight died mid-mega-batch; "
                        "nothing to merge"
                    )
                scale = np.float32(float(a.sum()) / contributed)
            merged = {
                k: torch.from_numpy(flat[k] if scale is None else (flat[k] * scale).astype(
                    flat[k].dtype)).to(self.device, v.dtype)
                for k, v in merged.items()
            }
        if not (global_model is None or prev_global is None or gamma == 0.0):
            merged = asgd.add_global_momentum(merged, global_model, prev_global, gamma)
        return merged, self._broadcast(merged) if broadcast else None

    def replica_norms(self, replicas) -> np.ndarray:
        """(R,) per-replica L2 norms on the host (feeds Alg. 2's
        perturbation condition); per shard under sharded."""
        with trace.span("trainer.merge.norms"):
            outs = self._shards(lambda s, b: tu.tree_l2_norm_per_replica(b), replicas)
            local = np.concatenate([o.cpu().numpy() for o in outs])
            if self._span is None:
                return local
            # the norms are per replica (no cross-replica sum): a gather
            # reassembles the global vector; a dead peer's rows read 0, its
            # merge weight is redistributed at the merge anyway
            out = np.zeros(self.cfg.n_replicas, local.dtype)
            for pid, arr in self._span.allgather("norms", local).items():
                plo, phi = self._span.bounds_of(pid)
                out[plo:phi] = arr
            return out

    def apply_replicas(self, fn, replicas):
        """``fn(replicas, axis) -> (replica tree, extra)`` over the whole
        population under the placement: once on the whole tree (axis None)
        under vmap, on every shard's block with the replica axis bound under
        sharded. Returns (the replicas in the placement's layout, shard 0's
        extra, on the home device)."""
        outs = self._shards(lambda s, b: fn(b, self._axis), replicas)
        return self._layout([o[0] for o in outs]), outs[0][1]

    # ------------------------------------------------------------------
    # state init
    # ------------------------------------------------------------------
    def init_state(self) -> ElasticState:
        # a CPU generator: the same seed gives the same weights on every
        # device (about 10 s for a 1.1 B-parameter LM; ``init_seconds``)
        t0 = time.perf_counter()
        params = self.model.init(torch.Generator().manual_seed(self.seed))
        params = {k: v.to(self.device) for k, v in params.items()}
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.init_seconds = time.perf_counter() - t0
        replicas = self._broadcast(params)
        momentum = self._layout([
            init_momentum(b, self.sgd)
            for b in (replicas.blocks if self._sharded else [replicas])
        ])
        extras = self.algo.init_state_extras(self.cfg, params, self.keep_global_copies)
        b = np.asarray(extras.b, np.float64)
        lr = self.base_lr * b / self.cfg.b_max  # linear-scaling rule
        return ElasticState(
            replicas=replicas,
            global_model=extras.global_model,
            prev_global=extras.prev_global,
            momentum=momentum,
            b=b,
            lr=lr,
        )

    # ------------------------------------------------------------------
    # elastic membership: resize R between mega-batches
    # ------------------------------------------------------------------
    def resize(self, state: ElasticState, new_R: int) -> ElasticState:
        """Change the replica count between mega-batches.

        * **merge first** — every current replica (leavers included)
          contributes a final normalized merge, weights ``b_i / sum(b)``
          (Algorithm 2 line 3), through the ``weighted_merge`` kernel on
          the card: leaving replicas' updates are never dropped.
        * **carry state** — under ``resize_policy='merge'`` the new
          population restarts from the merged global; under ``'preserve'``
          (CROSSBOW) survivors keep their own parameters and joiners clone
          the merged global. Survivors keep their momentum, joiners start
          at zero. The global-momentum pair restarts (``prev_global :=
          merged``). Batch sizes and lrs resize through ``algo.resize_b``.
        * **re-plan** — ``_adopt_width``: config, speed factors (joiners at
          1.0) and virtual clocks (joiners at the barrier time).

        Survivors' rows are copied, never kept as views, so a shrink frees
        the leavers' memory. The new global and prev_global hold the same
        tensors: nothing writes a global in place (merges, the guard's
        restart and checkpoints only read them). Resolves through
        ``algo.resolve_n_replicas`` first (``single`` makes any schedule a
        no-op). A prefetched plan was made for the old R: it is revoked
        (``invalidate_prefetch``) before anything changes, but not by a
        resize to the current R, so a constant schedule keeps it. Treat the
        input state as consumed. Under the sharded placement the final
        merge runs on the old mesh, then the mesh for ``new_R`` comes from
        the pool (``_adopt_width``) and the carried rows are copied onto its
        shards (the reference's re-shard).
        """
        new_R = int(self.algo.resolve_n_replicas(int(new_R)))
        R = self.cfg.n_replicas
        if new_R == R:
            return state
        if self._span is not None:
            raise ValueError(
                "a spanning trainer changes membership at process grain (heartbeat-driven "
                "fleet events); resize() is unsupported"
            )
        if new_R < 1:
            raise ValueError(f"cannot resize to {new_R} replicas")
        self.invalidate_prefetch()

        # ---- final normalized merge over the outgoing population ----
        alphas = np.asarray(state.b, np.float64)
        merged, _ = self._merge(state.replicas, alphas / alphas.sum(), None, None, 0.0,
                                broadcast=False)

        # ---- re-plan: config, batch plan, speeds, virtual clocks, mesh ----
        new_cfg = dataclasses.replace(self.cfg, n_replicas=new_R)
        new_b, new_lr = self.algo.resize_b(new_cfg, state.b, state.lr, self.base_lr)
        self._adopt_width(new_R)

        # ---- carry parameters / momentum to the new population: copies of
        # the survivors' rows, then a fill for every joiner ----
        survivors = list(range(min(R, new_R)))
        if self.algo.resize_policy == "preserve":
            new_replicas = self._take_rows(state.replicas, survivors, new_R, fill=merged)
        else:  # 'merge': everyone restarts from the merged global
            new_replicas = self._broadcast(merged)
        new_momentum = None
        if state.momentum is not None:
            new_momentum = self._take_rows(state.momentum, survivors, new_R)
        new_global = merged if state.global_model is not None else None
        new_prev = merged if state.prev_global is not None else None
        return ElasticState(
            replicas=new_replicas,
            global_model=new_global,
            prev_global=new_prev,
            momentum=new_momentum,
            b=np.asarray(new_b, np.float64),
            lr=np.asarray(new_lr, np.float64),
            megabatch_idx=state.megabatch_idx,
        )

    def _adopt_width(self, new_R: int) -> None:
        """Adopt a new replica count: config, speed model, scheduler and,
        under the sharded placement, the pool's mesh for ``new_R`` and its
        cached executor. The population-agnostic half of ``resize``, reused
        by ``restore_checkpoint`` when the checkpointed width differs from
        the trainer's construction width."""
        self.cfg = dataclasses.replace(self.cfg, n_replicas=new_R)
        self.speed.resize(new_R)
        self.scheduler.resize(self.cfg)
        if self._sharded:
            self.mesh = self._mesh_pool.mesh_for(self._mesh_width())
            self._install_executor()

    def _place_state(self, replicas, momentum, global_model, prev_global):
        """Move restored (R, ...) state trees onto the placement: the
        trainer's device under vmap; under sharded each shard's block onto
        its device (copies) and the globals onto the home device (the
        reference's device_put onto the replica mesh)."""
        def put(tree):
            return None if tree is None else tu.tree_map(lambda l: l.to(self.device), tree)

        def split(tree):
            if tree is None or not self._sharded:
                return put(tree)
            n = self._mesh_width()
            return self._take_rows(tree, list(range(n)), n)

        return split(replicas), split(momentum), put(global_model), put(prev_global)

    def remove_replicas(self, state: ElasticState, indices,
                        merge_leavers: bool = True) -> ElasticState:
        """Evict specific replica slots between mega-batches.

        ``resize`` only drops tail rows, so targeted eviction first permutes
        survivors to the front (every per-replica array — state rows, b/lr,
        speed factors, virtual clocks — moves with its replica), then
        shrinks.

        ``merge_leavers``: a preempted replica got notice, so its updates
        fold into the final merge like any graceful leaver (True); a crashed
        or poisoned replica is excluded — its rows are zeroed and its merge
        weight set to 0, so the normalization redistributes b_i over the
        survivors and a NaN never reaches the weighted sum (0 * NaN is NaN,
        hence the zeroing). A prefetched plan is revoked first: the
        permutation moves speed factors and clocks it consumed in the old
        order. Under the sharded placement the permuted rows are copied
        across the shards; a spanning trainer evicts whole process blocks
        (``_remove_replicas_spanning``).
        """
        R = self.cfg.n_replicas
        drop = sorted({int(i) for i in indices})
        if not drop:
            return state
        bad = [i for i in drop if i < 0 or i >= R]
        if bad:
            raise ValueError(f"replica indices {bad} out of range for R={R}")
        if len(drop) >= R:
            raise ValueError(f"cannot remove all {R} replicas (removal of {drop})")
        if self._span is not None:
            return self._remove_replicas_spanning(state, drop, merge_leavers)
        self.invalidate_prefetch()
        survivors = [i for i in range(R) if i not in set(drop)]
        perm = survivors + drop

        if perm != list(range(R)):
            state = ElasticState(
                replicas=self._take_rows(state.replicas, perm, R),
                global_model=state.global_model,
                prev_global=state.prev_global,
                momentum=(
                    self._take_rows(state.momentum, perm, R)
                    if state.momentum is not None else None
                ),
                b=np.asarray(state.b, np.float64)[perm],
                lr=np.asarray(state.lr, np.float64)[perm],
                megabatch_idx=state.megabatch_idx,
            )
            self.speed.permute(perm)
            self.scheduler.clock.permute(perm)

        if not merge_leavers:
            keep = R - len(drop)
            b = np.asarray(state.b, np.float64).copy()
            b[keep:] = 0.0
            state = dataclasses.replace(
                state, replicas=tu.tree_fill_rows(state.replicas, range(keep, R), 0.0), b=b
            )

        return self.resize(state, R - len(drop))

    def _remove_replicas_spanning(self, state, drop, merge_leavers):
        """Evict whole peer processes from a spanning fleet.

        The drop set must cover exact process blocks (the monitor emits
        process-grain events, so it does); this process's replica count is
        untouched: the same mesh and executor. Every surviving process runs
        this identically:

        * a final merge over the survivors: a dead process contributes no
          partial, and with its alphas zeroed the exchange's mass
          renormalization is ``merge_leavers=False``'s crash semantics (a
          graceful leaver still exchanges, and its updates fold in);
        * survivors-first renumbering preserves order, so every slot block
          stays contiguous; the host-global vectors (b, lr, speed factors,
          virtual clocks) permute and shrink as on one process.
        """
        span = self._span
        R = self.cfg.n_replicas
        victims = span.processes_for_slots(drop)
        self.invalidate_prefetch()

        alphas = np.asarray(state.b, np.float64).copy()
        if not merge_leavers:
            alphas[drop] = 0.0
        if alphas.sum() <= 0:
            alphas = np.ones(R, np.float64)
            if not merge_leavers:
                alphas[drop] = 0.0
        alphas = alphas / alphas.sum()
        merged, merged_replicas = self._merge(state.replicas, alphas, None, None, 0.0)

        dropset = set(drop)
        survivors = [i for i in range(R) if i not in dropset]
        perm = survivors + list(drop)
        if perm != list(range(R)):
            self.speed.permute(perm)
            self.scheduler.clock.permute(perm)
        new_R = R - len(drop)
        b_perm = np.asarray(state.b, np.float64)[perm]
        lr_perm = np.asarray(state.lr, np.float64)[perm]
        for pid in victims:
            span.remove_process(pid)
        self._adopt_width(new_R)
        new_b, new_lr = self.algo.resize_b(self.cfg, b_perm[:new_R], lr_perm[:new_R],
                                           self.base_lr)
        # 'merge': everyone restarts from the merged global; 'preserve':
        # survivors keep their own rows, which are exactly this process's.
        # Survivors keep their momentum.
        new_replicas = state.replicas if self.algo.resize_policy == "preserve" \
            else merged_replicas
        return ElasticState(
            replicas=new_replicas,
            global_model=merged if state.global_model is not None else None,
            prev_global=merged if state.prev_global is not None else None,
            momentum=state.momentum,
            b=np.asarray(new_b, np.float64),
            lr=np.asarray(new_lr, np.float64),
            megabatch_idx=state.megabatch_idx,
        )

    # ------------------------------------------------------------------
    # rounds
    # ------------------------------------------------------------------
    def _grads(self, replicas, batch):
        """((loss, aux), grads) of every replica on its own batch."""
        if self.sparse_grads and self.model.sparse_grad_fn is not None:
            return self.model.sparse_grad_fn(replicas, batch)
        return dense_value_and_grad(self.model.loss_fn, replicas, batch)

    def _round(self, replicas, momentum, batch, lr_vec, update_mask, live: bool):
        """``train_round`` with this trainer's gradients, SGD settings and
        the algorithm's round transforms."""
        return train_round(self._grads, replicas, momentum, batch, lr_vec, update_mask,
                           self.sgd, self._transforms, live)

    def _live(self, mask_row) -> bool:
        """Whether a round has an unmasked replica anywhere: the shard's own
        row of the mask, and under sharded the maximum over the shards
        where the round has a post-round hook (its only reader)."""
        live = bool(np.any(mask_row))
        if self._transforms.post_round is not None:
            live = bool(tu.replica_all_max(live, self._axis))
        return live

    def _dispatch_rounds(self, state: ElasticState, shards: list, mask_host: np.ndarray,
                         live_rows: int):
        """Issue every round of a stacked plan on every shard; returns
        ``(replicas, momentum, stats)`` with ``stats`` the (n_rounds, 4)
        device tensor of per-round (loss, accuracy, samples, live), reduced
        with the reference's normalization. ``shards`` holds each shard's
        (batches, mask, lr) on its device, ``mask_host`` the host copy of
        the whole (n_rounds, R) mask, read for each round's ``live``: no
        host sync. Under sharded each shard marks its window for a measured
        speed model (``ShardWindowTimer``) around its rounds, and the
        per-round metric sums are summed over the shards before the
        normalization (the reference's psum in the scan). The span counts
        the rows the rounds compute and, of them, the ``live_rows`` that
        hold a sample (``_live_rows``)."""
        timer = self._shard_timer

        def one(s, replicas, momentum):
            with trace.span("trainer.dispatch.shard", shard=s):
                batches, mask, lr = shards[s]
                local = mask_host[:, self._rows(s)]
                stream = torch.cuda.current_stream(mask.device) if mask.is_cuda else None
                if timer is not None:
                    timer.mark_start(s, stream)
                sums = []
                for r in range(len(local)):
                    m = mask[r]
                    replicas, momentum, loss, aux = self._round(
                        replicas, momentum, {k: v[r] for k, v in batches.items()}, lr, m,
                        live=self._live(local[r]),
                    )
                    sums.append(torch.stack([
                        (loss * m).sum(),
                        (aux["accuracy"] * m).sum(),
                        (aux["n_valid"] * m).sum(),
                        m.sum(),
                    ]))
                if timer is not None:
                    timer.mark_end(s, stream)
                sums = tu.replica_all_sum(torch.stack(sums), self._axis)
                if self._span is not None and self._span.spanning == "host":
                    return replicas, momentum, sums   # the exchange completes them
                denom = sums[:, 3].clamp_min(1.0)
                stats = torch.stack(
                    [sums[:, 0] / denom, sums[:, 1] / denom, sums[:, 2],
                     (sums[:, 3] > 0).float()],
                    dim=1,
                )
                return replicas, momentum, stats

        with trace.span("trainer.dispatch", rows=mask_host.size * self.cfg.b_max,
                        live_rows=int(live_rows)):
            outs = self._shards(one, state.replicas, state.momentum)
        return (self._layout([o[0] for o in outs]), self._layout([o[1] for o in outs]),
                outs[0][2])

    def _live_rows(self, plan) -> int:
        """The rows of this process's rounds that hold a sample: the plan's
        samples in its replica columns."""
        return int(plan.per_round_sizes(self.cfg.n_replicas)[:, self._span_slice()].sum())

    def _finish_metrics(self, stats) -> tuple[float, float]:
        """A mega-batch's (loss, accuracy) from ``_dispatch_rounds``'s
        stats: the one host sync of the mega-batch. Under a host span the
        stats are this process's raw per-round sums: the exchange completes
        them over the processes and the host mirrors the normalization in
        f32 (a dead peer contributes nothing: that mega-batch's metrics
        cover the survivors)."""
        with trace.span("trainer.collect"):
            if self._span is not None and self._span.spanning == "host":
                f32 = np.float32
                total, _ = self._span.allreduce_sum("metrics", {"sums": stats.cpu().numpy()})
                sums = np.asarray(total["sums"], f32)
                denom = np.maximum(sums[:, 3], f32(1.0))
                loss_r, acc_r = sums[:, 0] / denom, sums[:, 1] / denom
                n_live = np.maximum((sums[:, 3] > 0).astype(f32).sum(dtype=f32), f32(1.0))
                return (float(loss_r.sum(dtype=f32) / n_live),
                        float(acc_r.sum(dtype=f32) / n_live))
            n_live = stats[:, 3].sum().clamp_min(1.0)
            loss, acc = (torch.stack([stats[:, 0].sum(), stats[:, 1].sum()]) / n_live).tolist()
            return loss, acc

    def _pack_plan(self, grid, lr, b_slots: int, host: dict):
        """Each shard's column block of the plan grid, packed into the views
        ``host[(name, shard)]`` of a staging slot: a list of host array
        dicts (the provider's fields, the update mask under
        ``_STAGED_MASK``, the shard's learning rates under ``_STAGED_LR``);
        and the whole (n_rounds, R) host mask."""
        lr32 = np.asarray(lr, np.float32)
        packed, masks = [], []
        for s in range(self._n_shards):
            # the grid and lr are global: each shard packs its own global
            # columns (under a span, only this process's are packed and
            # uploaded; packing is a pure gather of payloads the plan fetched)
            rows = self._grows(s)
            sub = [row[rows] for row in grid]
            with trace.span("trainer.pack.shard", shard=s):
                fields = [k for k, i in host if i == s and k not in (_STAGED_MASK, _STAGED_LR)]
                _, mask_np = self.provider.stack_plan(
                    sub, b_slots, out={k: host[(k, s)].numpy() for k in fields})
                host[(_STAGED_MASK, s)].numpy()[...] = mask_np
                host[(_STAGED_LR, s)].numpy()[...] = lr32[rows]
                arrays = {k: host[(k, s)] for k in fields + [_STAGED_MASK, _STAGED_LR]}
            packed.append(arrays)
            masks.append(mask_np)
        return packed, np.concatenate(masks, axis=1)

    def _upload(self, packed: list) -> list:
        """Each shard's packed arrays onto its device, asynchronously on its
        stream: ``[(batches, mask, lr)]`` in shard order."""
        def one(s):
            arrays = _to_device(packed[s], self._shard_device(s), non_blocking=True)
            mask, lr = arrays.pop(_STAGED_MASK), arrays.pop(_STAGED_LR)
            return arrays, mask, lr

        return self._shards(one)

    # ------------------------------------------------------------------
    # non-finite guard
    # ------------------------------------------------------------------
    def _finite_rows(self, replicas) -> np.ndarray:
        """(R,) bool on the host: replica i's leaves are all finite (this
        process's rows under a span)."""
        def one(s, block):
            parts = [torch.isfinite(l.float()).flatten(1).all(dim=1) for l in block.values()]
            return torch.stack(parts).all(dim=0)

        return np.concatenate([o.cpu().numpy() for o in self._shards(one, replicas)])

    def _global_finite_rows(self, replicas) -> np.ndarray:
        """(R,) bool over the global population: under a span the local
        masks are gathered, so every process agrees on the rows to repair
        (and issues the same repair exchanges); a dead peer's rows read
        finite: its weight is handled by eviction, not by the guard."""
        finite_local = self._finite_rows(replicas)
        if self._span is None:
            return finite_local
        out = np.ones(self.cfg.n_replicas, bool)
        for pid, arr in self._span.allgather("finite", finite_local).items():
            plo, phi = self._span.bounds_of(pid)
            out[plo:phi] = np.asarray(arr, bool)
        return out

    def _repair_nonfinite(self, state, replicas, momentum, finite):
        """Re-clone non-finite replicas from a finite donor.

        The poisoned rows are zeroed first (``0 * NaN`` is still NaN), then
        overwritten with the donor: the Algorithm-2 normalized merge of the
        finite rows, weights ``b_i`` restricted to them (summed over the
        shards under sharded, and over the processes under a span, where
        ``finite`` is the agreed global mask and each shard applies its own
        rows of it). A fully diverged population restarts from the last
        barrier global; without one the guard raises. Healed replicas
        continue with zeroed momentum.
        """
        if not finite.any() and state.global_model is None:
            raise FloatingPointError(
                "all replicas diverged to non-finite values and algorithm "
                f"{self.algo.name!r} keeps no global model to restart from"
            )

        def keep_rows(s, l, fill):
            keep = torch.from_numpy(finite[self._grows(s)].copy()).to(l.device)
            return torch.where(keep.view((-1,) + (1,) * (l.ndim - 1)), l, fill)

        def zero(s, block, mom):
            block = tu.tree_map(lambda l: keep_rows(s, l, torch.zeros_like(l)), block)
            if mom is not None:
                mom = tu.tree_map(lambda l: keep_rows(s, l, torch.zeros_like(l)), mom)
            return block, mom

        outs = self._shards(zero, replicas, momentum)
        replicas, momentum = (self._layout([o[0] for o in outs]),
                              self._layout([o[1] for o in outs]))
        if finite.any():
            alphas = np.where(finite, np.asarray(state.b, np.float64), 0.0)
            donor, _ = self._merge(replicas, alphas / alphas.sum(), None, None, 0.0,
                                   broadcast=False)
        else:
            donor = state.global_model
        donors = self._replicated(donor)

        def fill(s, block):
            d = donors[self._shard_device(s)]
            return tu.tree_map(lambda l, g: keep_rows(s, l, g.to(l.dtype).expand_as(l)),
                               block, d)

        return self._layout(self._shards(fill, replicas)), momentum

    # ------------------------------------------------------------------
    # one mega-batch
    # ------------------------------------------------------------------
    def run_megabatch(
        self, state: ElasticState, prefetch: Optional[bool] = None
    ) -> tuple[ElasticState, dict]:
        """Plan, execute, and merge one mega-batch; returns (new_state, info).

        ``algo.plan`` → rounds (with ``algo.round_transforms``) →
        non-finite guard → ``algo.merge`` → ``algo.adapt`` → merge-cost
        accounting. The mega-batch runs from the plan staged ahead for it,
        or stages its own. With ``overlap`` on, ``algo.adapt`` and the
        clock bump run while the device runs the rounds, and
        ``prefetch=True`` also stages the next mega-batch (``run`` asks for
        it on all but the last; module doc); a bare call leaves no staged
        plan behind. Off, they run in the barrier, after the merge. The
        rounds update ``state.replicas``/``state.momentum`` in place:
        continue from the returned state only. Its ``trainer.megabatch``
        span is the root of the mega-batch's spans (``utils.trace``).

        Under the pipeline the host-stateful steps keep the sequential
        path's relative order (… plan N → merge-cost clock bump N → plan
        N+1 …), and ``merge``, ``adapt`` and the guard are pure functions
        of (state, plan, device results), so the trajectory is the
        sequential one's under the simulated speed model. Under a measured
        one, plan N+1 is made with factors one window stale: window N is
        observed after the collect."""
        cfg = self.cfg
        idx = int(state.megabatch_idx)
        with trace.span("trainer.megabatch", megabatch=idx):
            if not self.overlap:
                # a stale prefetch (overlap turned off between calls) must
                # not leak its advanced cursors into the sequential path
                self.invalidate_prefetch()
            staged = self._take_staged(state) or self._stage_megabatch(state.b, state.lr, idx)
            plan = staged.plan
            # measured-speed feedback: the window brackets the rounds up to
            # the collect of their metrics
            measure = isinstance(self.speed, MeasuredSpeedModel)
            t_start = self.speed.begin() if measure else None
            if self._shard_timer is not None:
                self._shard_timer.reset(self._n_shards)
            replicas, momentum, stats = self._dispatch_rounds(state, staged.shards,
                                                              staged.mask_host,
                                                              self._live_rows(plan))
            if self.overlap:
                # ---- host work overlapped with the rounds on the device ----
                new_b, new_lr, virtual_time = self._adapt(state, plan)
                if prefetch:
                    self._staged = self._stage_megabatch(new_b, new_lr, idx + 1, ahead=True)

            # ---- collect: the one host sync of the mega-batch ----
            train_loss, train_acc = self._finish_metrics(stats)
            with trace.span("trainer.barrier"):
                # every shard's rounds, the slot's consumers, are done on
                # the device (the collect waited for them all): reusable
                self._staging.release(staged.slot_id)
                trace.file_tallies()
                if measure:
                    self._observe_window(plan, cfg.n_replicas, self.speed.elapsed(t_start))
                # ---- non-finite guard, then the merge (the barrier) ----
                replicas, momentum, guard_repaired = self._guard(state, replicas, momentum)
                outcome = self._merge_barrier(state, plan, replicas)
                if not self.overlap:
                    new_b, new_lr, virtual_time = self._adapt(state, plan)
                return self._megabatch_result(state, plan, outcome, momentum, new_b, new_lr,
                                              train_loss, train_acc, virtual_time,
                                              guard_repaired)

    def _adapt(self, state, plan):
        """The merge-cost clock bump and ``algo.adapt``: (new b, new lr, the
        virtual time after the bump)."""
        with trace.span("trainer.adapt"):
            self.scheduler.clock.t[:] += self.merge_cost * self.algo.merges_per_megabatch(plan)
            new_b, new_lr = self.algo.adapt(state, plan, self.cfg)
            return new_b, new_lr, float(self.scheduler.clock.t.max())

    def _guard(self, state, replicas, momentum):
        """The non-finite guard: heal poisoned replicas before the barrier;
        inert while every replica is finite. Returns (replicas, momentum,
        the rows it repaired)."""
        repaired: list[int] = []
        with trace.span("trainer.guard"):
            finite = self._global_finite_rows(replicas)
            if not finite.all():
                replicas, momentum = self._repair_nonfinite(state, replicas, momentum, finite)
                repaired = np.flatnonzero(~finite).tolist()
        return replicas, momentum, repaired

    def _merge_barrier(self, state, plan, replicas):
        """``algo.merge`` in its span, which counts the bytes the merge
        copied between devices (``copy_bytes``)."""
        with trace.span("trainer.merge", copy_bytes=0):
            return self.algo.merge(self, state, plan, replicas)

    def _observe_window(self, plan, R: int, seconds: float) -> None:
        """Feed one mega-batch's measurement window to the speed model: the
        shards' own windows (``observe_shards``) when the sharded executors
        marked a complete set, else the whole window, attributed per
        replica by its scheduled share of the plan (the vmap placement)."""
        windows = self._shard_timer.take() if self._shard_timer is not None else None
        if windows is not None:
            self.speed.observe_shards(
                windows, plan.per_replica_work(R), u=plan.u, n_rounds=plan.n_rounds,
            )
        else:
            self.speed.observe_plan(
                plan.per_replica_work(R), seconds, u=plan.u, n_rounds=plan.n_rounds,
            )

    def _megabatch_result(self, state, plan, outcome, momentum, new_b, new_lr,
                          train_loss, train_acc, virtual_time, guard_repaired):
        """(new_state, info) of a mega-batch."""
        with trace.span("trainer.result"):
            R = self.cfg.n_replicas
            alphas = outcome.alphas if outcome.alphas is not None else np.full(R, 1.0 / R)
            new_state = ElasticState(
                replicas=outcome.replicas,
                global_model=outcome.global_model,
                prev_global=outcome.prev_global,
                momentum=momentum,
                b=np.asarray(new_b, np.float64),
                lr=np.asarray(new_lr, np.float64),
                megabatch_idx=state.megabatch_idx + 1,
            )
            info = {
                "n_replicas": R,
                "u": plan.u.tolist(),
                "b": np.round(np.asarray(new_b), 2).tolist(),
                "lr": np.round(np.asarray(new_lr), 6).tolist(),
                "alphas": np.round(np.asarray(alphas, np.float64), 4).tolist(),
                "pert_active": bool(outcome.pert_active),
                "train_loss": train_loss,
                "train_accuracy": train_acc,
                "virtual_time": virtual_time,
                "n_rounds": plan.n_rounds,
            }
            if guard_repaired:
                info["guard_repaired"] = guard_repaired
            return new_state, info

    # ------------------------------------------------------------------
    # staging: plan → fused pack → one asynchronous upload, revocable
    # ------------------------------------------------------------------
    def _cursor_snapshot(self) -> dict:
        """Copies of every host cursor a staging plan advances: the
        provider's stream (sample RNG and position; ``provider.cursor()``,
        whose sample order is an array, not the ``state_dict`` list), the
        virtual clocks and, for the simulated speed model, whose planning
        draws jitter, its state. A measured model is not snapshotted
        (``None``): planning does not change it, and rolling it back would
        drop windows observed after the snapshot."""
        return {
            "provider": self.provider.cursor(),
            "clock_t": np.asarray(self.scheduler.clock.t, np.float64).copy(),
            "speed": (
                None if isinstance(self.speed, MeasuredSpeedModel)
                else copy.deepcopy(self.speed.state_dict())
            ),
        }

    def _stage_megabatch(self, b, lr, megabatch_idx: int,
                         ahead: bool = False) -> _StagedMegaBatch:
        """Plan one mega-batch and stage it on the device.

        Fetches through the provider's ``fetch_staged`` (XML: ids and work
        units only), packs the plan grid into a ``StagingBuffers`` slot
        (pinned on the card; XML: one fused gather), the update mask and
        the learning rates beside it, and issues one asynchronous copy of
        each array on the current stream: queued behind the rounds already
        issued, so nothing waits on the host. Under sharded the slot holds
        every shard's column block apart, and each is copied to its shard's
        device on the shard's stream. Logs one ``staging_log`` entry. A
        staging ``ahead`` of its mega-batch (the pipeline's prefetch) takes
        the cursor snapshot first (its ``trainer.snapshot`` span and the
        entry's ``snapshot_s``), which makes it revocable
        (``invalidate_prefetch``) and checkpoint-safe
        (``checkpoint_payload``).
        """
        cfg = self.cfg
        R = cfg.n_replicas
        b_slots = cfg.b_max
        mega_samples = cfg.mega_batch * cfg.b_max
        provider = self.provider

        def fetch(i, take):
            return provider.fetch_staged(take, b_slots)

        with trace.span("trainer.stage", megabatch=int(megabatch_idx)):
            b = np.asarray(b, np.float64).copy()
            lr = np.asarray(lr, np.float64).copy()
            snapshot, snapshot_s = None, 0.0
            if ahead:
                with trace.span("trainer.snapshot") as snap_span:
                    snapshot = self._cursor_snapshot()
                snapshot_s = snap_span.seconds
            with trace.span("trainer.plan") as plan_span:
                plan = self.algo.plan(self.scheduler, _PlanView(b, lr, megabatch_idx),
                                      mega_samples, fetch)
                grid = plan.payload_grid(R)
            with trace.span("trainer.pack") as pack:
                spec = {}
                for s in range(self._n_shards):
                    n = self._rows(s).stop - self._rows(s).start
                    for k, v in provider.staging_spec(len(grid), n, b_slots).items():
                        spec[(k, s)] = v
                    spec[(_STAGED_MASK, s)] = ((len(grid), n), np.float32)
                    spec[(_STAGED_LR, s)] = ((n,), np.float32)
                slot_id, host = self._staging.acquire(spec)
                packed, mask_np = self._pack_plan(grid, lr, b_slots, host)
            with trace.span("trainer.upload") as upload:
                shards = self._upload(packed)
            self.staging_log.append({
                "megabatch": int(megabatch_idx),
                "snapshot_s": snapshot_s,
                "plan_s": plan_span.seconds,
                "pack_s": pack.seconds,
                "upload_s": upload.seconds,
                "bytes": int(sum(a.nbytes for a in host.values())),
            })
        return _StagedMegaBatch(
            plan=plan, shards=shards, mask_host=mask_np,
            b=b, lr=lr, megabatch_idx=int(megabatch_idx), n_replicas=R,
            slot_id=slot_id, snapshot=snapshot,
        )

    def _take_staged(self, state: ElasticState) -> Optional[_StagedMegaBatch]:
        """Consume the prefetched mega-batch if it matches ``state``: the
        same mega-batch index, width and b/lr vectors. Any mismatch (a
        change that did not go through ``invalidate_prefetch``) discards it
        with a cursor rollback, so the plan is simply made again."""
        s = self._staged
        if s is None:
            return None
        self._staged = None
        if (
            s.megabatch_idx == int(state.megabatch_idx)
            and s.n_replicas == self.cfg.n_replicas
            and np.array_equal(s.b, np.asarray(state.b, np.float64))
            and np.array_equal(s.lr, np.asarray(state.lr, np.float64))
        ):
            return s
        self._discard_staged(s)
        return None

    def invalidate_prefetch(self) -> None:
        """Revoke the prefetched mega-batch (if any) and roll every host
        cursor back to its pre-staging snapshot. Called before anything
        that invalidates a staged plan (a resize, an eviction, a stall's
        start or end, a checkpoint restore), so the next mega-batch plans
        from unconsumed cursors."""
        s = self._staged
        if s is None:
            return
        self._staged = None
        self._discard_staged(s)

    def _discard_staged(self, s: _StagedMegaBatch) -> None:
        snap = s.snapshot
        self.provider.load_state_dict(snap["provider"])
        self.scheduler.clock.t[:] = snap["clock_t"]
        if snap["speed"] is not None:
            self.speed.load_state_dict(snap["speed"])
        # staged before the collect that ended the last mega-batch, so its
        # upload has completed: the slot is free to rewrite
        self._staging.release(s.slot_id)

    # ------------------------------------------------------------------
    # evaluation + full run
    # ------------------------------------------------------------------
    @staticmethod
    def _eval_cache_key(test_batches: list) -> tuple:
        """Fingerprint of a test set: the list's identity, its length and
        the identities of its first and last payloads (a rebuilt or
        extended list re-stages; a swap of only a middle element does not,
        so pass a fresh list after one)."""
        return (
            id(test_batches),
            len(test_batches),
            id(test_batches[0]) if test_batches else None,
            id(test_batches[-1]) if test_batches else None,
        )

    def _staged_test_batches(self, test_batches: list) -> list:
        """Stack and upload the test set once; reuse the device tensors
        while the fingerprint holds. The source list and its payloads stay
        referenced, so no fingerprinted id can be recycled."""
        key = self._eval_cache_key(test_batches)
        if self._eval_batches_key != key:
            staged = []
            for payload in test_batches:
                stacked = self.provider.stack([payload])
                staged.append(_to_device({k: v[0] for k, v in stacked.items()}, self.device))
            self._eval_batches = staged
            self._eval_batches_key = key
            self._eval_batches_src = (test_batches, list(test_batches))
        return self._eval_batches

    @torch.no_grad()
    def evaluate_async(self, params: dict, test_batches: list):
        """Issue the evaluation of ``params`` (no replica dim) on every
        staged test batch without a host sync; returns a collector that
        reads the results back in one sync and returns the sample-weighted
        test loss and top-1 accuracy. ``run`` issues it at a boundary and
        collects it at the next, so its device work queues behind the next
        mega-batch's instead of stalling the host between them."""
        with trace.span("trainer.eval"):
            per_batch = []
            for batch in self._staged_test_batches(test_batches):
                loss, aux = self.model.loss_fn(params, batch)
                per_batch.append(torch.stack([loss, aux["accuracy"], aux["n_valid"]]))
            pending = torch.stack(per_batch) if per_batch else None

        def collect() -> dict:
            with trace.span("trainer.eval.collect"):
                rows = pending.tolist() if pending is not None else []
            tot_acc, tot_loss, tot_n = 0.0, 0.0, 0.0
            for loss, acc, n in rows:
                tot_acc += acc * n
                tot_loss += loss * n
                tot_n += n
            return {
                "accuracy": tot_acc / max(tot_n, 1.0),
                "loss": tot_loss / max(tot_n, 1.0),
            }

        return collect

    def evaluate(self, params: dict, test_batches: list) -> dict:
        """Sample-weighted test loss and top-1 accuracy of ``params``."""
        return self.evaluate_async(params, test_batches)()

    # ------------------------------------------------------------------
    # crash-consistent checkpointing
    # ------------------------------------------------------------------
    def checkpoint_payload(self, state: ElasticState) -> tuple[dict, dict]:
        """Everything a restored run needs to continue the exact
        trajectory: ``(tensor_tree, json_metadata)`` for
        ``checkpoint.store.save``, in the reference's layout. Tensors: the
        model state (replicas, globals, momentum; a model's dotted leaf
        keys become nested paths, so the store keys them as the reference
        does), the per-replica b/lr, the virtual clocks and the speed
        factors; metadata: the mega-batch index, width, algorithm, seed,
        the speed model's RNG and the provider's stream cursor and RNG.
        The tensors are the live ones: ``CheckpointManager`` copies them.

        When a mega-batch for this exact ``state`` is staged but not yet
        trained on, the cursors from before its staging plan (provider,
        clocks, speed model) are stored instead of the live ones, so a
        restore replays it instead of skipping it (a measured speed model's
        EMAs are observation history, not plan cursors, and stay live).
        Under sharded the shards' blocks are gathered into whole trees on
        the home device, so the format is the same under either placement.
        Under a span every process's rows are gathered into width-complete
        trees (``_span_gather_state``), so a single-process run restores
        it: every process builds the payload on the same interval (the
        gather is an exchange) and only the publishing manager writes
        (``CheckpointManager(publisher=)``)."""
        speed_sd = self.speed.state_dict()
        provider_sd = (
            self.provider.state_dict() if hasattr(self.provider, "state_dict") else None
        )
        clock_t = np.asarray(self.scheduler.clock.t, np.float64)
        staged = self._staged
        if staged is not None and staged.megabatch_idx == int(state.megabatch_idx):
            snap = staged.snapshot
            provider_sd = _json_cursor(snap["provider"])
            clock_t = np.asarray(snap["clock_t"], np.float64)
            if snap["speed"] is not None:
                speed_sd = snap["speed"]
        if self._span is not None:
            replicas_ckpt, momentum_ckpt = self._span_gather_state(state)
        else:
            replicas_ckpt = _nested(self._whole(state.replicas))
            momentum_ckpt = _nested(self._whole(state.momentum))
        tree = {
            "replicas": replicas_ckpt,
            "momentum": momentum_ckpt,
            "global_model": _nested(state.global_model),
            "prev_global": _nested(state.prev_global),
            "b": np.asarray(state.b, np.float64),
            "lr": np.asarray(state.lr, np.float64),
            "clock_t": clock_t,
            "speed": speed_sd["arrays"],
        }
        metadata = {
            "format": 1,
            "megabatch_idx": int(state.megabatch_idx),
            "n_replicas": int(self.cfg.n_replicas),
            "algorithm": self.cfg.algorithm,
            "seed": int(self.seed),
            "has": {
                "momentum": state.momentum is not None,
                "global_model": state.global_model is not None,
                "prev_global": state.prev_global is not None,
            },
            "speed_meta": speed_sd["meta"],
        }
        if provider_sd is not None:
            metadata["provider"] = provider_sd
        return tree, metadata

    def _span_gather_state(self, state: ElasticState):
        """Width-complete ``(replicas, momentum)`` host trees under a span:
        every live process's rows gathered and laid into global-R arrays by
        slot block (nested, as checkpoints store them). Rows of a peer that
        dies during this exchange take the global model (replicas) or zeros
        (momentum), what a crash eviction would have merged away anyway."""
        span = self._span
        R = int(self.cfg.n_replicas)

        def local(tree):
            return None if tree is None else _nested(self._whole(tree))

        gathered = span.allgather(
            "ckpt", {"replicas": local(state.replicas), "momentum": local(state.momentum)})
        fills = {"replicas": state.global_model, "momentum": None}

        def assemble(key: str):
            if gathered[span.process_id][key] is None:
                return None
            by_pid = {pid: tu.flatten(tree[key]) for pid, tree in gathered.items()}
            out = {}
            for k, leaf in by_pid[span.process_id].items():
                g = np.zeros((R,) + leaf.shape[1:], leaf.dtype)
                if fills[key] is not None:
                    g[:] = fills[key][k].cpu().numpy()[None]
                for pid, leaves in by_pid.items():
                    lo, hi = span.bounds_of(pid)
                    g[lo:hi] = leaves[k]
                out[k] = g
            return tu.unflatten(out)

        return assemble("replicas"), assemble("momentum")

    def restore_checkpoint(self, path: str) -> ElasticState:
        """Rebuild the full training state from a checkpoint written by
        this trainer or by the reference's.

        ``path`` is one checkpoint directory or a manager directory (the
        newest complete checkpoint is taken). The trainer must be built
        with the same model/algorithm/config family as the writer —
        structural mismatches raise ``checkpoint.store.CheckpointError`` —
        but its replica count may differ: the checkpointed width is
        adopted (``_adopt_width``). A prefetched plan belongs to the
        pre-restore trajectory and is revoked first. Under a span the
        checkpoint is width-complete: its width is re-split over the live
        processes and this process keeps only its own block.
        """
        self.invalidate_prefetch()
        path = ckpt_store.resolve_checkpoint(path)
        meta = ckpt_store.load_metadata(path)
        if meta.get("algorithm") != self.cfg.algorithm:
            raise ckpt_store.CheckpointError(
                f"checkpoint {path} was written by algorithm {meta.get('algorithm')!r}; "
                f"this trainer runs {self.cfg.algorithm!r}"
            )
        new_R = int(meta["n_replicas"])
        if new_R != self.cfg.n_replicas:
            if self._span is not None:
                # re-split the checkpointed global width over the live
                # processes before adopting it (raises if indivisible)
                self._span.assign_slots(new_R)
            self._adopt_width(new_R)
        speed_sd = self.speed.state_dict()
        ckpt_kind = meta.get("speed_meta", {}).get("kind")
        if ckpt_kind != speed_sd["meta"]["kind"]:
            raise ckpt_store.CheckpointError(
                f"checkpoint {path} carries a {ckpt_kind!r} speed model; "
                f"this trainer uses {speed_sd['meta']['kind']!r}"
            )
        has = meta.get("has", {})
        if bool(has.get("momentum")) != (self.sgd.momentum != 0.0):
            raise ckpt_store.CheckpointError(
                f"checkpoint {path} {'has' if has.get('momentum') else 'lacks'} momentum "
                "but this trainer's SGD config disagrees"
            )
        # shape and dtype template: one init on the CPU, held as meta
        # tensors (no replicas on the device beside the loaded copy)
        params = self.model.init(torch.Generator().manual_seed(self.seed))
        params_like = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
                       for k, v in params.items()}
        del params
        replicas_like = {k: v.expand((new_R,) + v.shape) for k, v in params_like.items()}
        # global/prev presence follows the checkpoint, not init_state:
        # algorithms without global copies publish one from their first
        # barrier on
        like = {
            "replicas": _nested(replicas_like),
            "momentum": _nested(replicas_like) if has.get("momentum") else None,
            "global_model": _nested(params_like) if has.get("global_model") else None,
            "prev_global": _nested(params_like) if has.get("prev_global") else None,
            "b": np.zeros(new_R, np.float64),
            "lr": np.zeros(new_R, np.float64),
            "clock_t": np.zeros(new_R, np.float64),
            "speed": speed_sd["arrays"],
        }
        tree, _ = ckpt_store.load(path, like)
        self.scheduler.clock.t[:] = np.asarray(tree["clock_t"], np.float64)
        self.speed.load_state_dict({"arrays": tree["speed"], "meta": meta["speed_meta"]})
        if isinstance(self.speed, MeasuredSpeedModel):
            # the first window after a restore carries one-time costs
            self.speed.discard_next_window()
        if "provider" in meta and hasattr(self.provider, "load_state_dict"):
            self.provider.load_state_dict(meta["provider"])

        def flat(nested, rows=slice(None)):
            # the model's own leaf order (the per-replica norms sum in it);
            # ``rows`` keeps this process's block under a span
            if nested is None:
                return None
            leaves = tu.flatten(nested)
            return {k: leaves[k][rows] for k in params_like}

        sl = self._span_slice()
        replicas, momentum, global_model, prev_global = self._place_state(
            flat(tree["replicas"], sl), flat(tree["momentum"], sl),
            flat(tree["global_model"]), flat(tree["prev_global"]),
        )
        return ElasticState(
            replicas=replicas,
            global_model=global_model,
            prev_global=prev_global,
            momentum=momentum,
            b=np.asarray(tree["b"], np.float64),
            lr=np.asarray(tree["lr"], np.float64),
            megabatch_idx=int(meta["megabatch_idx"]),
        )

    def _validate_resize_schedule(self, resize_schedule: dict) -> dict[int, int]:
        """Normalize + validate a resize schedule at launch: rejects
        negative mega-batch indices, entries that collide after int
        normalization (``{"3": 4, 3: 6}``), and replica targets below 1."""
        out: dict[int, int] = {}
        for raw_mb, raw_R in resize_schedule.items():
            mb, target = int(raw_mb), int(raw_R)
            if mb != float(raw_mb) or target != float(raw_R):
                raise ValueError(
                    f"resize schedule entry {raw_mb!r}: {raw_R!r} is not an integer pair"
                )
            if mb < 0:
                raise ValueError(f"resize schedule has negative mega-batch index {mb}")
            if mb in out:
                raise ValueError(
                    f"resize schedule defines mega-batch {mb} twice "
                    "(duplicate after normalization)"
                )
            resolved = int(self.algo.resolve_n_replicas(target))
            if resolved < 1:
                raise ValueError(f"resize schedule targets {target} replicas at mega-batch {mb}")
            out[mb] = target
        return out

    def run(
        self,
        n_megabatches: int,
        test_batches: Optional[list] = None,
        eval_every: int = 1,
        verbose: bool = False,
        resize_schedule: Optional[dict[int, int]] = None,
        fleet: Optional[Any] = None,
        checkpoint: Optional[Any] = None,
        restore_from: Optional[str] = None,
    ) -> tuple[ElasticState, MetricsLog]:
        """Train up to mega-batch ``n_megabatches``, evaluating the global
        model on ``test_batches`` (when given) every ``eval_every``
        mega-batches.

        ``resize_schedule`` maps a 0-based mega-batch index to the replica
        count that takes effect before that mega-batch (``resize``; an
        entry equal to the current R is a no-op). ``fleet`` — a
        ``core.fleet.FleetController`` whose ``step(trainer, state, mb)``
        runs at each boundary, after any scheduled resize. ``checkpoint`` —
        a ``checkpoint.store.CheckpointManager``: ``maybe_save`` after
        every mega-batch, the last write joined before returning.
        ``restore_from`` — a checkpoint path (or manager directory) to
        resume from instead of ``init_state``; training continues at the
        checkpointed mega-batch index.

        With the overlap pipeline (``overlap``), every mega-batch but the
        last stages the next one, and evaluation is
        issued at a boundary and collected at the next, then written into
        the record of the mega-batch it belongs to (its progress line waits
        for it); the last is collected before returning.
        """
        if resize_schedule is not None:
            resize_schedule = self._validate_resize_schedule(resize_schedule)
        if restore_from is not None:
            state = self.restore_checkpoint(restore_from)
        else:
            state = self.init_state()
            if verbose:
                log("init", seconds=round(self.init_seconds, 3),
                    params=tu.tree_size(state.replicas) // self._mesh_width())
        mlog = MetricsLog()
        pending_eval = None  # (record to backfill, collector)

        def emit_line(record):
            if verbose:
                log(
                    f"[{self.cfg.algorithm}] mb={record['megabatch']}",
                    loss=round(record["train_loss"], 4),
                    acc=round(record.get("accuracy", float("nan")), 4),
                    u=record["u"],
                    b=record["b"],
                    vt=round(record["virtual_time"], 3),
                )

        def drain_eval():
            nonlocal pending_eval
            if pending_eval is not None:
                record, collect = pending_eval
                ev = collect()
                record.update(accuracy=ev["accuracy"], test_loss=ev["loss"])
                pending_eval = None
                emit_line(record)

        t0 = time.perf_counter()
        for mb in range(int(state.megabatch_idx), n_megabatches):
            if resize_schedule is not None and mb in resize_schedule:
                state = self.resize(state, resize_schedule[mb])
            if fleet is not None:
                state = fleet.step(self, state, mb)
            # the last mega-batch stages nothing: run ends with every host
            # cursor consumed
            state, info = self.run_megabatch(
                state, prefetch=self.overlap and mb + 1 < n_megabatches
            )
            if checkpoint is not None:
                checkpoint.maybe_save(self, state)
            # the previous boundary's evaluation ran behind this mega-batch
            drain_eval()
            collect = None
            if test_batches is not None and (mb + 1) % eval_every == 0:
                if self.overlap:
                    collect = self.evaluate_async(state.global_model, test_batches)
                else:
                    ev = self.evaluate(state.global_model, test_batches)
                    info.update(accuracy=ev["accuracy"], test_loss=ev["loss"])
            info["megabatch"] = mb + 1
            info["wall_clock"] = time.perf_counter() - t0
            mlog.append(**info)
            if collect is not None:
                # MetricsLog.append copies: backfill the stored record
                pending_eval = (mlog.records[-1], collect)
            else:
                emit_line(mlog.records[-1])
        drain_eval()
        if checkpoint is not None:
            checkpoint.wait()
        return state, mlog
