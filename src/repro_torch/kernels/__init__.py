"""The port's kernels: each package's ``ops`` is the public entry (the
CUDA kernel on CUDA tensors, its plain version on CPU tensors) and its
``ref`` the plain PyTorch version."""
from __future__ import annotations

import torch


def refuse_grad(name: str, *tensors: torch.Tensor) -> None:
    """Raise where autograd would record ``name``: the LM kernels are
    forward-only, as the reference's are (its only ``custom_vjp`` is
    spmm's), and a kernel's output has no ``grad_fn``, so the gradient
    would stop there without an error. Checked on every device, so that a
    run on the CPU (the plain versions, which autograd could follow) fails
    as the same run on the card would."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} has no backward: call it under torch.no_grad(), or train "
            "with the kernel flag off"
        )
