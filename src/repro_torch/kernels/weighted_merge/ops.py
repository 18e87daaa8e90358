"""Public entry for the weighted-merge kernel (Algorithm 2's model merge).

``merge`` runs the plain version (``ref.weighted_merge_ref``) on CPU
tensors and the CUDA kernel (``csrc/weighted_merge.cu``) on CUDA tensors.
``merge_pytree`` applies it leaf by leaf over a dict of replica-stacked
parameters; ``core.adaptive_sgd.normalized_merge`` routes every merge
through it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

from .ref import weighted_merge_ref


def merge(replicas, alphas, g=None, gp=None, gamma: float = 0.0):
    """replicas (R, N); alphas (R,) f32. Returns merged (N,)."""
    tensors = [replicas, alphas] + [t for t in (g, gp) if t is not None]
    if all(t.device.type == "cpu" for t in tensors):
        return weighted_merge_ref(replicas, alphas, g, gp, gamma)
    return merge_cuda(replicas, alphas, g, gp, gamma)


def merge_cuda(replicas, alphas, g=None, gp=None, gamma: float = 0.0):
    """Launch the CUDA kernel; raises on anything it does not take."""
    momentum = g is not None and gamma != 0.0
    if momentum and gp is None:
        raise ValueError("the momentum term needs both g and gp")
    tensors = [replicas, alphas] + ([g, gp] if momentum else [])
    if replicas.device.type != "cuda" or any(t.device != replicas.device for t in tensors):
        raise ValueError("merge_cuda needs all its tensors on one CUDA device")
    if replicas.dtype not in _build.DTYPE_CODES or alphas.dtype != torch.float32:
        raise TypeError("merge_cuda needs float32/bfloat16 replicas and float32 alphas")
    if replicas.ndim != 2 or alphas.shape != replicas.shape[:1]:
        raise ValueError(
            f"need replicas (R, N) and alphas (R,); got {tuple(replicas.shape)} "
            f"and {tuple(alphas.shape)}"
        )
    R, N = replicas.shape
    if momentum and (
        g.shape != (N,) or gp.shape != (N,)
        or g.dtype != replicas.dtype or gp.dtype != replicas.dtype
    ):
        raise ValueError("momentum needs g and gp of shape (N,) in the replicas' dtype")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("merge_cuda needs contiguous tensors")
    out = torch.empty((N,), dtype=replicas.dtype, device=replicas.device)
    with torch.cuda.device(replicas.device):
        err = _build.library().weighted_merge(
            replicas.data_ptr(), alphas.data_ptr(),
            g.data_ptr() if momentum else None, gp.data_ptr() if momentum else None,
            ctypes.c_float(gamma), out.data_ptr(), R, N,
            _build.DTYPE_CODES[replicas.dtype], int(momentum),
            torch.cuda.current_stream(replicas.device).cuda_stream,
        )
    _build.check(err, "weighted_merge")
    _build.count_launch(merge_cuda, no_momentum_launches=not momentum)
    return out


merge_cuda.launches = 0  # kernel launches since the last reset
merge_cuda.no_momentum_launches = 0  # of them, without the momentum term


def merge_pytree(replica_tree: dict, alphas, global_tree=None, prev_tree=None,
                 gamma: float = 0.0) -> dict:
    """Leaf-wise Algorithm-2 merge over a dict whose leaves carry a leading
    replica dim R. Leaves are flattened to (R, N) for the kernel and
    reshaped back. Returns a dict shaped like one replica."""
    def leaf(k):
        x = replica_tree[k]
        flat = x.reshape(x.shape[0], -1)
        if global_tree is not None and gamma != 0.0:
            out = merge(flat, alphas, global_tree[k].reshape(-1),
                        prev_tree[k].reshape(-1), gamma)
        else:
            out = merge(flat, alphas)
        return out.reshape(x.shape[1:])

    return {k: leaf(k) for k in replica_tree}
