"""roofline_pct.xml_head: the XML head's cuBLAS f32 GEMMs (TF32 off) in the
traced stretch: the sum of each GEMM's bound (``roofline.head_gemms`` at
the configuration's peak) over the device time of the kernels whose names
match ``GEMM``. The GEMMs are counted from the recorded ``spmm`` launches:
a training round (a replica dim) runs the forward and two backward GEMMs,
an evaluation batch the forward."""
import re

from perfbench import roofline

GEMM = re.compile(r"gemm|splitKreduce", re.IGNORECASE)


def read(run):
    p = run.profile
    if p is None:
        return None
    t = sum(b - a for name, _, a, b in p.ops if GEMM.search(name)) / 1e6
    h, nc = run.config["hidden"], run.config["n_classes"]
    bound = 0.0
    for idx, _, w_shape, elt in p.launches["spmm"]:
        reps = w_shape[0] if len(w_shape) == 3 else 1
        rows = idx.numel() // idx.shape[-1]
        for n_bytes, flops in roofline.head_gemms(reps, rows, h, nc, len(w_shape) == 3, elt):
            bound += roofline.bound_s(n_bytes, flops, run.config["peak_flops"])
    return 100.0 * bound / t if t > 0 and bound > 0 else None
