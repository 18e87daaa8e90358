"""roofline_pct.moe_experts: the held experts' grouped GEMMs in the traced
stretch. ``torch._grouped_mm`` in bf16 runs CUTLASS's grouped GEMMs, whose
names hold ``GroupProblemShape``, each after a ``prepare_grouped_gemm_data``
kernel: the names ``KERNEL`` matches in a trace. The sum of each recorded
call's bound (``roofline_lm.expert_gemms``: the three SwiGLU products over
the call's rows, and the backward's six for a call autograd records
outside a checkpoint's recompute) over those kernels' device time."""
import re

from perfbench import roofline, roofline_lm

KERNEL = re.compile(r"grouped|GroupProblemShape", re.IGNORECASE)


def read(run):
    p = run.profile
    if p is None or "moe_experts" not in p.launches:
        return None
    t = sum(b - a for name, _, a, b in p.ops if KERNEL.search(name)) / 1e6
    peak = run.config["peak_flops"]
    bound = 0.0
    for n, d, f, e, elt, grad, recompute in p.launches["moe_experts"]:
        bound += roofline.bound_s(*roofline_lm.expert_gemms(n, d, f, e, elt,
                                                            grad and not recompute), peak)
    return 100.0 * bound / t if t > 0 and bound > 0 else None
