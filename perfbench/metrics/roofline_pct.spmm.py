"""roofline_pct.spmm: the ``spmm`` kernel (``csrc/spmm.cu``,
``spmm_rows_kernel``) in the traced stretch: the sum of each launch's
bound (``roofline.spmm``: the distinct unmasked W rows its inputs name)
over the kernel's device time."""
import torch

from perfbench import roofline

KERNEL = "spmm_rows_kernel"


def read(run):
    p = run.profile
    if p is None:
        return None
    t = sum(b - a for name, _, a, b in p.ops if KERNEL in name) / 1e6
    bound = 0.0
    for idx, mask, w_shape, elt in p.launches["spmm"]:
        nf, h = w_shape[-2:]
        k = idx.shape[-1]
        live = mask.bool().reshape(-1, k)
        rep = (torch.arange(idx.numel() // (idx.shape[-2] * k), device=idx.device)
               .repeat_interleave(idx.shape[-2]).view(-1, 1))
        rows = (idx.long().reshape(-1, k) + rep * nf)[live]
        n_bytes, flops = roofline.spmm(idx.numel(), idx.numel() // k, int(live.sum()),
                                       int(torch.unique(rows).numel()), h, elt)
        bound += roofline.bound_s(n_bytes, flops, run.config["peak_flops"])
    return 100.0 * bound / t if t > 0 and bound > 0 else None
