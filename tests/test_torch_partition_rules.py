"""The partitioned program's specs against the reference's, exactly: for
every registered arch at full size, on both production meshes, with and
without the replica dim, ``param_specs`` equals ``repro.sharding.rules.
param_specs`` leaf for leaf, and so do ``train_batch_specs`` and
``serve_specs`` over the input specs of every mode and the ``MeshAxes``
roles. The rules read only the mesh's axis sizes: the reference side takes
a stand-in mesh object and ``jax.eval_shape`` trees, the port side a
mapping of axis sizes and fake-tensor shapes."""
from __future__ import annotations

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs.archs import ARCHS as REF_ARCHS
from repro.launch import specs as REF_SP
from repro.models import model as REF_MDL
from repro.sharding import rules as REF
from repro_torch.configs.archs import ARCHS
from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import (
    MULTI_POD_AXES,
    MULTI_POD_SHAPE,
    PRODUCTION_AXES,
    PRODUCTION_SHAPE,
)
from repro_torch.sharding import rules as R
from repro_torch.sharding.rules import Spec

MESHES = {
    "singlepod": dict(zip(PRODUCTION_AXES, PRODUCTION_SHAPE)),
    "multipod": dict(zip(MULTI_POD_AXES, MULTI_POD_SHAPE)),
}


class _StandIn:
    """What the reference's rules read of a mesh: ``.shape``."""

    def __init__(self, shape: dict):
        self.shape = dict(shape)


def _ref_flat(tree) -> dict:
    leaves = jax.tree_util.tree_leaves_with_path(tree, is_leaf=lambda x: isinstance(x, P))
    return {tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): tuple(leaf)
            for path, leaf in leaves}


def _port_flat(tree, path=()) -> dict:
    if isinstance(tree, Spec):
        return {path: tuple(tree)}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(_port_flat(v, path + (str(k),)))
    return out


def _with_r(tree, r):
    if isinstance(tree, dict):
        return {k: _with_r(v, r) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_with_r(v, r) for v in tree]
    if isinstance(tree, tuple) and len(tree) == 2 and isinstance(tree[1], torch.dtype):
        return ((r,) + tuple(tree[0]), tree[1])
    return tree


@pytest.fixture(scope="module")
def shapes():
    ref = {a: jax.eval_shape(lambda k, c=REF_ARCHS[a]: REF_MDL.init(c, k), jax.random.PRNGKey(0))
           for a in REF_ARCHS}
    port = {a: SP.param_shapes(ARCHS[a]) for a in ARCHS}
    return ref, port


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_specs_match_reference(shapes, arch, mesh):
    ref_shapes, port_shapes = shapes
    cfg, ref_cfg, sizes = ARCHS[arch], REF_ARCHS[arch], MESHES[mesh]
    ref = _ref_flat(REF.param_specs(ref_cfg, ref_shapes[arch], _StandIn(sizes)))
    got = _port_flat(R.param_specs(cfg, port_shapes[arch], sizes))
    assert got == ref
    # the leaves' shapes agree too, so the specs are of the same tensors
    ref_sh = {tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in p): tuple(l.shape)
              for p, l in jax.tree_util.tree_leaves_with_path(ref_shapes[arch])}
    got_sh = {k: tuple(v[0]) for k, v in _leaf_pairs(port_shapes[arch]).items()}
    assert got_sh == ref_sh
    # with the replica dim: the replica axis leads every spec
    ax = REF.MeshAxes(ref_cfg, _StandIn(sizes))
    r = ax.n_replicas
    ref_r = jax.tree_util.tree_map(
        lambda s: jax.ShapeDtypeStruct((r,) + tuple(s.shape), s.dtype), ref_shapes[arch])
    ref = _ref_flat(REF.param_specs(ref_cfg, ref_r, _StandIn(sizes), with_replica_dim=True))
    got = _port_flat(R.param_specs(cfg, _with_r(port_shapes[arch], r), sizes,
                                   with_replica_dim=True))
    assert got == ref


def _leaf_pairs(tree, path=()):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {path: tree}
    out = {}
    for k, v in items:
        out.update(_leaf_pairs(v, path + (str(k),)))
    return out


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_batch_and_serve_specs_and_roles_match_reference(arch, mesh):
    cfg, ref_cfg, sizes = ARCHS[arch], REF_ARCHS[arch], MESHES[mesh]
    stand = _StandIn(sizes)
    ref_ax, ax = REF.MeshAxes(ref_cfg, stand), R.MeshAxes(cfg, sizes)
    for role in ("tp", "replica", "fsdp", "ep", "batch", "n_replicas"):
        assert getattr(ax, role) == getattr(ref_ax, role), role
    assert ax.activation_rules() == ref_ax.activation_rules()
    assert ax.serve_rules() == ref_ax.serve_rules()
    for shape in INPUT_SHAPES.values():
        r = ax.n_replicas
        if shape.mode == "train":
            b = shape.global_batch // r
            ref_b = jax.tree_util.tree_map(
                lambda s: jax.ShapeDtypeStruct((r,) + tuple(s.shape), s.dtype),
                REF_SP.train_specs(ref_cfg, b, shape.seq_len))
            got = R.train_batch_specs(cfg, _with_r(SP.train_specs(cfg, b, shape.seq_len), r),
                                      sizes)
            assert _port_flat(got) == _ref_flat(REF.train_batch_specs(ref_cfg, ref_b, stand))
        elif shape.mode == "prefill":
            ref_b = REF_SP.prefill_specs(ref_cfg, shape.global_batch, shape.seq_len)
            got = R.serve_specs(cfg, SP.prefill_specs(cfg, shape.global_batch, shape.seq_len),
                                sizes)
            assert _port_flat(got) == _ref_flat(REF.serve_specs(ref_cfg, ref_b, stand))
        else:
            window = SP.decode_window(cfg, shape)
            ref_in = REF_SP.decode_specs(ref_cfg, shape.global_batch, shape.seq_len, window)
            got_in = SP.decode_specs(cfg, shape.global_batch, shape.seq_len, window)
            assert (_port_flat(R.serve_specs(cfg, got_in, sizes))
                    == _ref_flat(REF.serve_specs(ref_cfg, ref_in, stand)))


def test_to_placements():
    from torch.distributed.tensor import Replicate, Shard

    class _Mesh:
        mesh_dim_names = MULTI_POD_AXES
        shape = MULTI_POD_SHAPE

    mesh = _Mesh()
    assert R.to_placements(Spec(), mesh) == [Replicate()] * 3
    assert R.to_placements(Spec(None, "model"), mesh) == [Replicate(), Replicate(), Shard(1)]
    # a tuple entry: one tensor dim over (pod, data), major to minor
    assert R.to_placements(Spec(("pod", "data"), None, "model"), mesh) == [
        Shard(0), Shard(0), Shard(2)]
    with pytest.raises(ValueError):
        R.to_placements(Spec(("data", "pod")), mesh)
    with pytest.raises(ValueError):
        R.to_placements(Spec("model", "model"), mesh)
    assert R.first_fit((8, 16), [("model", None), (None, "model")], dict(model=16)) == Spec(
        None, "model")
    assert R.first_fit((8, 12), [("model", None)], dict(model=16)) == Spec()
