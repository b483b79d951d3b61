"""Kernel B1: bilaterally weighted NCC of candidate planes against one
source view's s-volume.

``svolume_cost`` launches ``csrc/ncc.cu`` on CUDA tensors and runs
``svolume_cost_plain`` on CPU tensors. Both evaluate, per pixel of the
dense grid (parity None) or of one packed parity class (H, W/2), the cost
that ``tsar_mvs_tpu.ops.svolume.svolume_cost_ab`` defines: each window
sample linearly interpolates the two s-planes bracketing its plane
coordinate at the edge-clamped dense offset pixel, accumulated centred on
the reference centre pixel. A candidate whose plane coordinate is
non-finite at any offset (d = 0 padding) costs cost_max. This replaces the
TPU kernel ``tsar_mvs_tpu/ops/pallas_ncc.py::_svol_ncc_kernel``.
"""

from __future__ import annotations

import torch

from tsar_mvs_tpu.config import AlgorithmParams
from tsar_mvs_tpu_torch import _build
from tsar_mvs_tpu_torch.ops.ncc import RefStats, ncc_epilogue, window_offsets

# Kernel launches since the last reset (read by chip_smoke.py).
LAUNCHES = 0

# Candidates per launch: the kernel keeps each candidate's moments in
# registers.
MAX_C = 8


def _dense_columns(Hc: int, Wc: int, parity: int | None,
                   device) -> tuple[torch.Tensor, torch.Tensor]:
    """(y (Hc, 1), x (Hc, Wc)) int64 dense coordinates of the grid."""
    y = torch.arange(Hc, device=device)[:, None]
    xp = torch.arange(Wc, device=device)[None, :]
    if parity is None:
        return y, xp.expand(Hc, Wc)
    return y, 2 * xp + (parity + y) % 2


def svolume_cost_plain(vol: torch.Tensor, s_lo: float, inv_ds: float,
                       s0: torch.Tensor, sx: torch.Tensor, sy: torch.Tensor,
                       stats: RefStats, params: AlgorithmParams,
                       parity: int | None) -> torch.Tensor:
    """Plain PyTorch cost: vol (S, H, W) bf16; s0/sx/sy (..., Hc, Wc);
    stats on the same grid. Returns (..., Hc, Wc) f32."""
    S, H, W = vol.shape
    Hc, Wc = s0.shape[-2:]
    flat = vol.reshape(-1)
    yy, xx = _dense_columns(Hc, Wc, parity, s0.device)
    s_lo32 = torch.tensor(s_lo, dtype=torch.float32, device=s0.device)
    inv_ds32 = torch.tensor(inv_ds, dtype=torch.float32, device=s0.device)
    acc_s = acc_ss = acc_rs = torch.zeros_like(s0)
    bad = torch.zeros(s0.shape, dtype=torch.bool, device=s0.device)
    for o, (i, j) in enumerate(window_offsets(params)):
        s_o = s0 + float(i) * sx + float(j) * sy
        t = (s_o - s_lo32) * inv_ds32
        finite = torch.isfinite(t)
        bad = bad | ~finite
        t = torch.clamp(torch.where(finite, t, 0.0), 0.0, float(S - 1))
        k0 = torch.floor(torch.clamp(t, max=float(S - 2)))
        pix = (torch.clamp(yy + j, 0, H - 1) * W
               + torch.clamp(xx + i, 0, W - 1))
        idx = k0.to(torch.int64) * (H * W) + pix
        a = flat[idx].to(torch.float32)
        b = flat[idx + H * W].to(torch.float32)
        src = a + (b - a) * (t - k0) - stats.center
        ws = stats.weights[o] * src
        acc_s = acc_s + ws
        acc_ss = acc_ss + ws * src
        acc_rs = acc_rs + ws * stats.ref_centered[o]
    cost = ncc_epilogue(acc_s, acc_ss, acc_rs, stats, params)
    return torch.where(bad, params.cost_max, cost)


def svolume_cost(vol: torch.Tensor, s_lo: float, inv_ds: float,
                 s0: torch.Tensor, sx: torch.Tensor, sy: torch.Tensor,
                 stats: RefStats, params: AlgorithmParams,
                 parity: int | None) -> torch.Tensor:
    """Cost of (..., Hc, Wc) candidate plane scalars against one view's
    dense (S, H, W) bf16 volume. CUDA tensors launch the kernel (one launch
    per block of up to MAX_C candidates); CPU tensors run the plain
    version."""
    if not s0.is_cuda:
        return svolume_cost_plain(vol, s_lo, inv_ds, s0, sx, sy, stats,
                                  params, parity)
    global LAUNCHES
    S, H, W = vol.shape
    Hc, Wc = s0.shape[-2:]
    lead = s0.shape[:-2]
    if vol.dtype != torch.bfloat16 or not vol.is_contiguous():
        raise TypeError("svolume_cost: vol must be contiguous bfloat16")
    if S < 2:
        raise ValueError("svolume_cost: the volume needs >= 2 planes")
    expect = (H, W) if parity is None else (H, W // 2)
    if (Hc, Wc) != expect or sx.shape != s0.shape or sy.shape != s0.shape:
        raise ValueError(f"svolume_cost: grid {(Hc, Wc)} does not match "
                         f"volume {(H, W)} at parity {parity}")
    fields = [stats.weights, stats.ref_centered, stats.mean_ref,
              stats.var_ref, stats.inv_wsum, stats.center]
    O = len(window_offsets(params))
    if (stats.weights.shape != (O, Hc, Wc)
            or stats.ref_centered.shape != (O, Hc, Wc)
            or any(f.shape != (Hc, Wc) for f in fields[2:])):
        raise ValueError("svolume_cost: stats do not match the grid")
    for tsr in (s0, sx, sy, vol, *fields):
        if tsr.device != s0.device:
            raise ValueError("svolume_cost: tensors on different devices")
    for tsr in (s0, sx, sy, *fields):
        if tsr.dtype != torch.float32:
            raise TypeError("svolume_cost: float32 inputs expected")
    fields = [f.contiguous() for f in fields]
    C = 1
    for n in lead:
        C *= n
    s0c, sxc, syc = (a.reshape(C, Hc, Wc).contiguous()
                     for a in (s0, sx, sy))
    out = torch.empty((C, Hc, Wc), dtype=torch.float32, device=s0.device)
    lib = _build.load_library()
    stream = torch.cuda.current_stream(s0.device).cuda_stream
    for c0 in range(0, C, MAX_C):
        n = min(MAX_C, C - c0)
        code = lib.tsar_svol_ncc(
            s0c[c0].data_ptr(), sxc[c0].data_ptr(), syc[c0].data_ptr(),
            n, Hc, Wc, *(f.data_ptr() for f in fields), vol.data_ptr(),
            S, H, W, float(s_lo), float(inv_ds),
            -1 if parity is None else int(parity), params.hrad,
            params.vrad, params.win_increment, float(params.cost_max),
            float(params.min_var), out[c0].data_ptr(), stream)
        _build.check(code, "tsar_svol_ncc")
        LAUNCHES += 1
    return out.reshape(*lead, Hc, Wc)
