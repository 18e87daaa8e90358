"""The yardstick: one H100's peaks and the operations and bytes of each
kernel the rooflines read, from the shapes and data of each launch.

The peaks are NVIDIA's data sheet for the H100 SXM (dense): HBM3 at
3.35 TB/s, f32 outside the tensor cores at 67 TFLOP/s. A configuration
states the peak of its own dtype (``peak_flops``). The bound of a launch is
the larger of its bytes over the bandwidth and its operations over the
peak; a roofline share is the bounds' sum over the matched kernels' device
time. As in ``chip_smoke.py`` (PERF.md's kernel table), each input byte is
counted read once and each output byte written once, and a sparse product
counts the rows its data needs.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12


def bound_s(n_bytes: float, flops: float, peak_flops: float) -> float:
    return max(n_bytes / HBM_BYTES_PER_S, flops / peak_flops)


def spmm(n_slots: int, n_rows: int, n_live: int, w_rows: int, h: int, elt: int):
    """(bytes, flops) of one ``spmm`` launch: idx, val and mask of every
    slot (4 + 4 + 1 bytes), each distinct W row an unmasked slot names, the
    (rows, H) output, and a multiply-add per unmasked slot and column."""
    return w_rows * h * elt + n_slots * 9 + n_rows * h * elt, 2 * n_live * h


def weighted_merge(r: int, n: int, elt: int, momentum: bool):
    """(bytes, flops) of one ``weighted_merge`` launch over (R, N) replicas:
    the replicas, the R weights, the output, and with the momentum term the
    global and previous global."""
    n_bytes = (r + 1) * n * elt + r * 4 + (2 * n * elt if momentum else 0)
    return n_bytes, 2 * r * n + (3 * n if momentum else 0)


def head_gemms(replicas: int, rows: int, h: int, nc: int, train: bool, elt: int = 4):
    """[(bytes, flops)] of the head's GEMMs for ``rows`` samples over
    ``replicas`` copies of W2 (H, NC): the forward ``h @ w2``, and in a
    training round the backward ``dlogits @ w2^T`` and ``h^T @ dlogits``."""
    w2, logits, act = replicas * h * nc * elt, rows * nc * elt, rows * h * elt
    flops = 2 * rows * h * nc
    out = [(act + w2 + logits, flops)]
    if train:
        out += [(logits + w2 + act, flops), (act + logits + w2, flops)]
    return out


def model_flops(n_samples: int, nnz: int, h: int, nc: int) -> float:
    """Forward and backward of the MLP for ``n_samples`` samples with
    ``nnz`` features in all: the input layer (2 nnz H forward, 2 nnz H into
    W1's gradient), the head (2 H NC a sample forward, 4 H NC for dh and
    dW2). No recomputed work; the biases and ReLU are left out."""
    return 4.0 * nnz * h + 6.0 * h * nc * n_samples
