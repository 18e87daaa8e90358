"""Mamba2 (SSD — state-space duality) blocks [arXiv:2405.21060].

Port of ``repro/models/mamba2.py``. Chunked SSD for prefill (quadratic
within chunks, linear across), O(1)-state recurrent step for decode.
Depthwise causal conv on the (x, B, C) stream, gated RMSNorm output,
per-head scalar A. ``use_kernel`` routes the chunked scan to the CUDA
kernel (``kernels/ssd_scan``).

Layout: d_inner = expand * d_model, H = d_inner // head_dim heads,
state size N, single B/C group (G=1, broadcast over heads).

Under a sharding context (``sharding.annotate``) the in-projection's
output is made whole on its feature dim before the split: ``in_proj`` is
tensor-parallel over that dim, whose z / xBC / dt boundaries do not fall on
shard boundaries. The reference leaves that resharding to GSPMD. The
chunked scan then runs on each rank's own batch rows and heads as plain
tensors (``_local_scan``), the heads sharded over the logical ``heads``
axis.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.sharding.annotate import (
    constrain,
    gathered,
    is_dtensor,
    placements_for,
    shard,
)

from .layers import contiguous_stride, ninit, residual, rmsnorm


def init_mamba2(
    generator, d_model: int, *, expand: int, head_dim: int, state: int, conv: int, dtype
):
    d_inner = expand * d_model
    n_heads = d_inner // head_dim
    d_conv_in = d_inner + 2 * state  # conv runs over [x, B, C]
    dev = generator.device
    return {
        "in_proj": ninit(
            generator, (d_model, 2 * d_inner + 2 * state + n_heads), d_model ** -0.5, dtype
        ),
        "conv_w": ninit(generator, (conv, d_conv_in), conv ** -0.5, dtype),
        "conv_b": torch.zeros((d_conv_in,), dtype=dtype, device=dev),
        "A_log": torch.zeros((n_heads,), dtype=torch.float32, device=dev),  # A = -1 init
        "D": torch.ones((n_heads,), dtype=torch.float32, device=dev),
        "dt_bias": torch.full((n_heads,), math.log(math.expm1(0.01)), device=dev),
        "gate_norm": torch.zeros((d_inner,), dtype=dtype, device=dev),
        "out_proj": ninit(generator, (d_inner, d_model), d_inner ** -0.5, dtype),
        "norm": torch.zeros((d_model,), dtype=dtype, device=dev),
    }


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """Lower-triangular segment sums: out[..., i, j] = sum_{j<k<=i} x[..., k]."""
    c = x.shape[-1]
    cs = x.cumsum(dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool, device=x.device))
    return torch.where(mask, out, float("-inf"))


def ssd_chunked(
    x: torch.Tensor,    # (B, L, H, P)  — already dt-discretized (x * dt)
    dA: torch.Tensor,   # (B, L, H)     — dt * A  (negative)
    Bm: torch.Tensor,   # (B, L, H, N)
    Cm: torch.Tensor,   # (B, L, H, N)
    chunk: int,
    initial_state=None,  # (B, H, P, N)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan. Returns (y (B,L,H,P), final_state (B,H,P,N)), f32."""
    b, l, h, p = x.shape
    n = Bm.shape[-1]
    assert l % chunk == 0, (l, chunk)
    nc = l // chunk
    xr = x.reshape(b, nc, chunk, h, p).float()
    br = Bm.reshape(b, nc, chunk, h, n).float()
    cr = Cm.reshape(b, nc, chunk, h, n).float()
    a = dA.reshape(b, nc, chunk, h).permute(0, 3, 1, 2).float()       # (B,H,nc,c)
    a_cs = a.cumsum(dim=-1)

    # 1) intra-chunk (diagonal blocks); exp(-inf) = 0 above the diagonal
    decay = torch.exp(_segsum(a))                                       # (B,H,nc,c,c)
    scores = torch.einsum("bclhn,bcshn->bhcls", cr, br) * decay
    y_diag = torch.einsum("bhcls,bcshp->bclhp", scores, xr)

    # 2) chunk states
    decay_states = torch.exp(a_cs[..., -1:] - a_cs)                     # (B,H,nc,c)
    states = torch.einsum(
        "bclhn,bclhp->bchpn", br, xr * decay_states.permute(0, 2, 3, 1)[..., None]
    )

    # 3) inter-chunk recurrence (sequential over chunks)
    chunk_decay = torch.exp(a_cs[..., -1])                              # (B,H,nc)
    state = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
             if initial_state is None else initial_state.float())
    prev = []
    for ci in range(nc):
        prev.append(state)  # the state *entering* chunk ci
        state = state * chunk_decay[:, :, ci, None, None] + states[:, ci]
    prev_states = torch.stack(prev, dim=1)                              # (B,nc,H,P,N)

    # 4) inter-chunk contribution to outputs
    state_decay_out = torch.exp(a_cs).permute(0, 2, 3, 1)[..., None]    # (B,nc,c,H,1)
    y_off = torch.einsum("bclhn,bchpn->bclhp", cr, prev_states) * state_decay_out

    y = (y_diag + y_off).reshape(b, l, h, p)
    return y, state


def _local_scan(scan, x, dA, Bm, Cm, chunk: int):
    """``scan(x, dA, Bm, Cm, chunk)``; on DTensors, on this rank's batch
    rows and heads (module doc)."""
    if not is_dtensor(x):
        return scan(x, dA, Bm, Cm, chunk)
    from torch.distributed.tensor import DTensor, Shard

    mesh = x.device_mesh
    x_pl = placements_for(mesh, "batch", None, "heads", None, shape=x.shape)
    a_pl = placements_for(mesh, "batch", None, "heads", shape=dA.shape)
    s_pl = [Shard(1) if p.is_shard() and p.dim == 2 else p for p in x_pl]   # (B, H, P, N)
    y, state = scan(x.redistribute(mesh, x_pl).to_local(), dA.redistribute(mesh, a_pl).to_local(),
                    Bm.redistribute(mesh, x_pl).to_local(), Cm.redistribute(mesh, x_pl).to_local(),
                    chunk)
    b, _, h, p = x.shape
    n = Bm.shape[-1]
    return (DTensor.from_local(y.contiguous(), mesh, x_pl, run_check=False, shape=x.shape,
                               stride=contiguous_stride(x.shape)),
            DTensor.from_local(state.contiguous(), mesh, s_pl, run_check=False, shape=(b, h, p, n),
                               stride=contiguous_stride((b, h, p, n))))


def _ssm_step(state, xdt, da, bm, cm):
    """One recurrence step: state (B,H,P,N) decayed by da (B,H) plus the
    outer product of x*dt (B,H,P) and B (B,N); y (B,H,P) reads it with C
    (B,N). Returns (new state, y)."""
    bx = torch.einsum("bhp,bn->bhpn", xdt, bm.float())
    new = state * da[..., None, None] + bx
    return new, torch.einsum("bhpn,bn->bhp", new, cm.float())


def _local_ssm_step(state, xdt, da, bm, cm):
    """``_ssm_step``; on a DTensor state (sharded on its batch, head or head
    dim by the serving specs), on this rank's part of it as plain tensors:
    DTensor's einsum would flatten a sharded dim."""
    if not is_dtensor(state):
        return _ssm_step(state, xdt, da, bm, cm)
    from torch.distributed.tensor import DTensor, Replicate

    mesh, pl = state.device_mesh, list(state.placements)
    if any(p.is_shard() and p.dim == 3 for p in pl):
        pl = [Replicate() if p.is_shard() and p.dim == 3 else p for p in pl]
        state = state.redistribute(mesh, pl)

    def on(x, dims):   # x's placements: the state's on ``dims``, whole elsewhere
        want = [p if p.is_shard() and p.dim in dims else Replicate() for p in pl]
        return x.redistribute(mesh, want).to_local()

    new, y = _ssm_step(state.to_local(), on(xdt, (0, 1, 2)), on(da, (0, 1)), on(bm, (0,)),
                       on(cm, (0,)))
    b, h, p, n = state.shape
    y_pl = [p_ if not (p_.is_shard() and p_.dim > 2) else Replicate() for p_ in pl]
    return (DTensor.from_local(new, mesh, pl, run_check=False, shape=state.shape,
                               stride=contiguous_stride(state.shape)),
            DTensor.from_local(y.contiguous(), mesh, y_pl, run_check=False, shape=(b, h, p),
                               stride=contiguous_stride((b, h, p))))


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d. xbc: (B, L, C); w: (K, C)."""
    k, l = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    return sum(pad[:, i : i + l, :] * w[i] for i in range(k)) + b


def mamba2_forward(
    params: dict,
    x: torch.Tensor,
    *,
    head_dim: int,
    state: int,
    chunk: int,
    norm_eps: float = 1e-5,
    use_kernel: bool = False,
) -> torch.Tensor:
    """Pre-norm Mamba2 block: x + ssd(norm(x)). x: (B, L, D)."""
    b, l, _ = x.shape
    h_in = rmsnorm(x, params["norm"], norm_eps)
    zxbcdt = shard(h_in @ gathered(params["in_proj"], 1), "replica", "batch", "seq", None)
    n_heads = params["A_log"].shape[0]
    d_inner = n_heads * head_dim
    z, xbc, dt = zxbcdt.split([d_inner, d_inner + 2 * state, n_heads], dim=-1)
    xbc = F.silu(_causal_conv(xbc, params["conv_w"], params["conv_b"]))
    xs, bm, cm = xbc.split([d_inner, state, state], dim=-1)
    xs = xs.reshape(b, l, n_heads, head_dim)
    dt = F.softplus(dt.float() + params["dt_bias"])                     # (B,L,H)
    a = -torch.exp(params["A_log"])                                     # (H,)
    pad = (-l) % chunk
    if pad:
        xs = F.pad(xs, (0, 0, 0, 0, 0, pad))
        bm = F.pad(bm, (0, 0, 0, pad))
        cm = F.pad(cm, (0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
    # B and C are shared by all heads: a stride-0 view, never copied per head
    lp = l + pad
    bm = bm[:, :, None, :].expand(b, lp, n_heads, state)
    cm = cm[:, :, None, :].expand(b, lp, n_heads, state)
    scan = ssd_ops.ssd_scan if use_kernel else ssd_chunked
    y, _ = _local_scan(scan, xs.float() * dt[..., None], dt * a, bm, cm, chunk)
    y = y[:, :l] + params["D"][None, None, :, None] * xs[:, :l].float()
    y = y.reshape(b, l, d_inner).to(x.dtype)
    y = rmsnorm(y, params["gate_norm"], norm_eps) * F.silu(z)
    return x + residual(y @ gathered(params["out_proj"], 0))


# --------------------------------------------------------------------------
# decode (recurrent) path
# --------------------------------------------------------------------------


def mamba2_init_cache(batch: int, params: dict, *, head_dim: int, state: int, dtype):
    n_heads = params["A_log"].shape[0]
    d_inner = n_heads * head_dim
    k = params["conv_w"].shape[0]
    dev = params["A_log"].device
    return {
        "conv": torch.zeros((batch, k - 1, d_inner + 2 * state), dtype=dtype, device=dev),
        "ssm": torch.zeros((batch, n_heads, head_dim, state), dtype=torch.float32, device=dev),
    }


def mamba2_decode_step(
    params: dict,
    x: torch.Tensor,           # (B, 1, D)
    cache: dict,
    *,
    head_dim: int,
    state: int,
    norm_eps: float = 1e-5,
) -> tuple[torch.Tensor, dict]:
    """One token through the recurrence. ``cache`` ({"conv", "ssm"}) is
    updated in place (the reference returns a new one) and returned."""
    b = x.shape[0]
    n_heads = params["A_log"].shape[0]
    d_inner = n_heads * head_dim
    h_in = rmsnorm(x, params["norm"], norm_eps)
    zxbcdt = shard((h_in @ gathered(params["in_proj"], 1))[:, 0], "batch", None)  # (B, E)
    z, xbc, dt = zxbcdt.split([d_inner, d_inner + 2 * state, n_heads], dim=-1)

    # rolling conv buffer
    conv_in = torch.cat([cache["conv"], xbc[:, None, :]], dim=1)        # (B,K,C)
    xbc = F.silu(torch.einsum("bkc,kc->bc", conv_in, params["conv_w"]) + params["conv_b"])

    xs, bm, cm = xbc.split([d_inner, state, state], dim=-1)
    xs = xs.reshape(b, n_heads, head_dim).float()
    dt = F.softplus(dt.float() + params["dt_bias"])                     # (B,H)
    da = torch.exp(dt * -torch.exp(params["A_log"]))                    # (B,H)
    new_ssm, y = _local_ssm_step(cache["ssm"], xs * dt[..., None], da, bm, cm)
    y = y + params["D"][None, :, None] * xs
    if is_dtensor(y):  # whole heads and head dims before they are flattened
        y = constrain(y, placements_for(y.device_mesh, "batch", None, None, shape=y.shape))
    y = y.reshape(b, d_inner).to(x.dtype)
    y = rmsnorm(y, params["gate_norm"], norm_eps) * F.silu(z)
    out = x + residual((y @ gathered(params["out_proj"], 0))[:, None, :])
    cache["conv"].copy_(conv_in[:, 1:])
    cache["ssm"].copy_(new_ssm)
    return out, cache
