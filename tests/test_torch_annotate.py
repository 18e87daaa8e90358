"""Logical-axis annotations (``repro_torch.sharding.annotate``) against
the reference's ``repro.sharding.annotate``: the spec of a logical tuple,
an axis's extent, the identity without a context, the rank-mismatch skip,
the dropped replica dim of serving paths, and the placements a DTensor
takes under a (2, 2) fake mesh."""
from __future__ import annotations

import pytest
import torch

from repro.sharding import annotate as REF
from repro.sharding import rules as REF_RULES
from repro_torch.configs.archs import ARCHS
from repro_torch.sharding import annotate as A
from repro_torch.sharding.rules import MeshAxes, Spec

SIZES = {"data": 2, "model": 2}


class _StandIn:
    def __init__(self, shape):
        self.shape = dict(shape)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "kimi-k2-1t-a32b"])
@pytest.mark.parametrize("serve", [False, True])
def test_logical_to_spec_and_axis_size_match_reference(arch, serve):
    from repro.configs.archs import ARCHS as REF_ARCHS

    for sizes in (SIZES, {"pod": 2, "data": 16, "model": 16}):
        ax = MeshAxes(ARCHS[arch], sizes)
        ref_ax = REF_RULES.MeshAxes(REF_ARCHS[arch], _StandIn(sizes))
        rules = ax.serve_rules() if serve else ax.activation_rules()
        ref_rules = ref_ax.serve_rules() if serve else ref_ax.activation_rules()
        for axes in (("replica", "batch", "seq", "heads", None), ("batch", None, None, None),
                     ("experts", None, None), ("replica", "batch", "seq", "ff")):
            assert tuple(A.logical_to_spec(axes, rules)) == tuple(
                REF.logical_to_spec(axes, ref_rules))
        with A.sharding_context(sizes, rules):
            REF.set_context(_StandIn(sizes), ref_rules)
            try:
                for name in ("replica", "batch", "heads", "ff", "experts", "vocab"):
                    assert A.logical_axis_size(name) == REF.logical_axis_size(name), name
            finally:
                REF.set_context(None, None)
    assert A.logical_axis_size("experts") == 1   # no context


def test_replica_rules_match_reference():
    assert A.replica_rules() == REF.replica_rules()


def test_shard_is_the_identity_without_a_context_or_for_a_plain_tensor():
    x = torch.randn(2, 3, 4)
    assert A.shard(x, "batch", "seq", None) is x
    with A.sharding_context(SIZES, {"batch": "data"}):
        assert A.shard(x, "batch", "seq", None) is x
        assert A.logical_axis_size("batch") == 2
    assert A.logical_axis_size("batch") == 1


@pytest.fixture(scope="module")
def mesh():
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_fake_process_group, make_debug_mesh

    init_fake_process_group(4)
    yield make_debug_mesh(2, 2, device_type="cpu")
    dist.destroy_process_group()


def _dt(local, mesh, placements):
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local, mesh, placements, run_check=False)


def test_shard_places_a_dtensor(mesh):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard

    rules = {"replica": None, "batch": "data", "heads": "model", "ff": "model",
             "experts": "model"}
    with FakeTensorMode(), A.sharding_context(mesh, rules):
        x = _dt(torch.empty(4, 8, 6, 3), mesh, [Replicate(), Replicate()])
        # (B, S, H, hd): batch over data, heads over model
        y = A.shard(x, "replica", "batch", "seq", "heads", None)   # replica dropped
        assert list(y.placements) == [Shard(0), Shard(2)]
        assert tuple(y.to_local().shape) == (2, 8, 3, 3)
        assert A.shard(y, "replica", "batch", "seq", "heads", None) is y
        # a rank mismatch is skipped
        assert A.shard(x, "batch", None) is x
        # a dim that does not split evenly stays whole
        odd = _dt(torch.empty(3, 8), mesh, [Replicate(), Replicate()])
        assert list(A.shard(odd, "batch", None).placements) == [Replicate(), Replicate()]
        # the spec a tuple of axes maps to (batch over both mesh dims)
        assert A.placements_for(mesh, "batch", None) == [Shard(0), Replicate()]
    both = {"batch": ("data", "model")}
    with A.sharding_context(mesh, both):
        assert A.placements_for(mesh, "batch", None) == [Shard(0), Shard(0)]
        assert A.logical_to_spec(("batch", None)) == Spec(("data", "model"), None)
        assert A.logical_axis_size("batch") == 4


def test_constrain_gives_a_partial_sum_its_gradient_whole(mesh):
    """The all-reduce's conjugate: a partial-sum input's gradient comes
    back replicated (Megatron's f/g), not as another partial sum."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Partial, Replicate

    with FakeTensorMode():
        x = _dt(torch.empty(4, 6), mesh, [Partial(), Replicate()]).requires_grad_(True)
        y = A.constrain(x, [Replicate(), Replicate()])
        assert list(y.placements) == [Replicate(), Replicate()]
        (g,) = torch.autograd.grad(y.sum(), [x])
        assert not any(p.is_partial() for p in g.placements)
