"""roofline_pct.mla_attention: the latent attention's kernels in the
traced stretch. ``scaled_dot_product_attention`` in bf16 runs on an H100 as
cuDNN's flash attention: its forward and backward kernels and the
backward's ``compute_dot_do_o`` and ``convert_dq_to_16bits``, the four
names ``KERNEL`` matches in a trace. The sum of each recorded call's bound
(``roofline_lm.mla_attention``: causal q k^T over q/k heads of 192 and p v
over the unpadded v heads of 128, forward, and the backward's twice that
for a call autograd records outside a checkpoint's recompute) over those
kernels' device time."""
import re

from perfbench import roofline, roofline_lm

KERNEL = re.compile(r"_sdpa_|flash|compute_dot_do_o|convert_dq")


def read(run):
    p = run.profile
    if p is None or "mla_attention" not in p.launches:
        return None
    t = sum(b - a for name, _, a, b in p.ops if KERNEL.search(name)) / 1e6
    peak = run.config["peak_flops"]
    bound = sum(roofline.bound_s(*roofline_lm.mla_attention(shape, dv, grad and not recompute),
                                 peak)
                for shape, dv, grad, recompute in p.launches["mla_attention"])
    return 100.0 * bound / t if t > 0 and bound > 0 else None
