"""roofline_pct.weighted_merge: the ``weighted_merge`` kernel
(``csrc/weighted_merge.cu``, ``merge_kernel``) in the traced stretch: the
sum of each launch's byte bound (``roofline.weighted_merge``: R replicas,
the global and previous global where the momentum term is fused, the
output) over the kernel's device time."""
from perfbench import roofline

KERNEL = "merge_kernel"


def read(run):
    p = run.profile
    if p is None:
        return None
    t = sum(b - a for name, _, a, b in p.ops if KERNEL in name) / 1e6
    bound = sum(roofline.bound_s(*roofline.weighted_merge(r, n, elt, momentum),
                                 run.config["peak_flops"])
                for r, n, elt, momentum in p.launches["weighted_merge"])
    return 100.0 * bound / t if t > 0 and bound > 0 else None
