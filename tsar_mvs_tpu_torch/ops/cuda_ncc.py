"""Kernel B1: bilaterally weighted NCC of candidate planes against the
source views' s-volumes, aggregated over the views.

``multiview_cost`` launches ``csrc/ncc.cu`` on CUDA tensors, once for all
views and up to MAX_C candidates, and runs ``multiview_cost_plain`` on
CPU tensors. Per view both evaluate, per pixel of the dense grid (parity
None) or of one packed parity class (H, W/2), the cost that
``tsar_mvs_tpu.ops.svolume.svolume_cost_ab`` defines: each window sample
linearly interpolates the two s-planes bracketing its plane coordinate at
the edge-clamped dense offset pixel, accumulated centred on the reference
centre pixel. A candidate whose plane coordinate is non-finite at any
offset (d = 0 padding) costs cost_max. Over the views both keep the
running best and second-best cost (``ncc.aggregate_streaming``): cost,
best / second ratio and the best view's id. This replaces the TPU kernel
``tsar_mvs_tpu/ops/pallas_ncc.py::_svol_ncc_kernel`` and the per-view loop
around it.
"""

from __future__ import annotations

import ctypes
from collections import Counter
from typing import Sequence

import torch

from tsar_mvs_tpu_torch import _build
from tsar_mvs_tpu_torch.config import AlgorithmParams
from tsar_mvs_tpu_torch.ops.ncc import (MultiviewCost, RefStats,
                                        aggregate_streaming, ncc_epilogue,
                                        window_offsets)

# Kernel launches since the last reset (read by chip_smoke.py), in all and
# by (grid rows, grid columns, candidates of the launch).
LAUNCHES = 0
LAUNCHES_BY_SHAPE: Counter = Counter()

# Candidates per launch (the kernel keeps each candidate's moments and
# running top-2 in registers) and source views per launch (its view table
# is a kernel argument).
MAX_C = 8
MAX_V = 32


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


def multiview_cost_plain(vols: Sequence[torch.Tensor], s_lo: float,
                         inv_ds: Sequence[float], ids: torch.Tensor,
                         s0: torch.Tensor, sx: torch.Tensor,
                         sy: torch.Tensor, stats: RefStats,
                         params: AlgorithmParams,
                         parity: int | None) -> MultiviewCost:
    """Plain PyTorch multi-view cost: the per-view plain costs streamed
    through the top-2 aggregation."""
    per_view = [lambda v=v: svolume_cost_plain(vols[v], s_lo, inv_ds[v], s0,
                                               sx, sy, stats, params, parity)
                for v in range(len(vols))]
    return aggregate_streaming(per_view, ids)


def multiview_cost(vols: Sequence[torch.Tensor], s_lo: float,
                   inv_ds: Sequence[float], ids: torch.Tensor,
                   s0: torch.Tensor, sx: torch.Tensor, sy: torch.Tensor,
                   stats: RefStats, params: AlgorithmParams,
                   parity: int | None) -> MultiviewCost:
    """Aggregated cost of (..., Hc, Wc) candidate plane scalars against
    the views' dense (S_v, H, W) bf16 volumes; ids (V,) are the view ids
    reported in best_view. CUDA tensors launch the kernel (one launch per
    block of up to MAX_C candidates, all views inside); CPU tensors run
    the plain version."""
    if not s0.is_cuda:
        return multiview_cost_plain(vols, s_lo, inv_ds, ids, s0, sx, sy,
                                    stats, params, parity)
    global LAUNCHES
    V = len(vols)
    if not 1 <= V <= MAX_V or len(inv_ds) != V or ids.shape != (V,):
        raise ValueError(f"multiview_cost: 1 to {MAX_V} views with one "
                         f"inv_ds and one id each, got {V}")
    H, W = vols[0].shape[-2:]
    Hc, Wc = s0.shape[-2:]
    lead = s0.shape[:-2]
    for vol in vols:
        if vol.dtype != torch.bfloat16 or not vol.is_contiguous():
            raise TypeError("multiview_cost: volumes must be contiguous "
                            "bfloat16")
        if vol.dim() != 3 or vol.shape[0] < 2 or vol.shape[1:] != (H, W):
            raise ValueError("multiview_cost: volumes are (S >= 2, H, W) "
                             "of one image size")
    expect = (H, W) if parity is None else (H, W // 2)
    if (Hc, Wc) != expect or sx.shape != s0.shape or sy.shape != s0.shape:
        raise ValueError(f"multiview_cost: grid {(Hc, Wc)} does not match "
                         f"volume {(H, W)} at parity {parity}")
    fields = [stats.weights, stats.ref_centered, stats.mean_ref,
              stats.var_ref, stats.inv_wsum, stats.center]
    O = len(window_offsets(params))
    if (stats.weights.shape != (O, Hc, Wc)
            or stats.ref_centered.shape != (O, Hc, Wc)
            or any(f.shape != (Hc, Wc) for f in fields[2:])):
        raise ValueError("multiview_cost: stats do not match the grid")
    for tsr in (s0, sx, sy, *vols, *fields):
        if tsr.device != s0.device:
            raise ValueError("multiview_cost: tensors on different devices")
    for tsr in (s0, sx, sy, *fields):
        if tsr.dtype != torch.float32:
            raise TypeError("multiview_cost: float32 inputs expected")
    fields = [f.contiguous() for f in fields]
    ids = ids.to(device=s0.device, dtype=torch.int64).contiguous()
    C = 1
    for n in lead:
        C *= n
    s0c, sxc, syc = (a.reshape(C, Hc, Wc).contiguous()
                     for a in (s0, sx, sy))
    cost = torch.empty((C, Hc, Wc), dtype=torch.float32, device=s0.device)
    ratio = torch.empty_like(cost)
    best_view = torch.empty((C, Hc, Wc), dtype=torch.int32,
                            device=s0.device)
    vol_ptrs = (ctypes.c_void_p * V)(*(v.data_ptr() for v in vols))
    planes = (ctypes.c_int * V)(*(int(v.shape[0]) for v in vols))
    inv = (ctypes.c_float * V)(*(float(x) for x in inv_ds))
    lib = _build.load_library()
    stream = torch.cuda.current_stream(s0.device).cuda_stream
    for c0 in range(0, C, MAX_C):
        n = min(MAX_C, C - c0)
        code = lib.tsar_svol_ncc_multiview(
            s0c[c0].data_ptr(), sxc[c0].data_ptr(), syc[c0].data_ptr(),
            n, Hc, Wc, *(f.data_ptr() for f in fields), vol_ptrs, planes,
            inv, V, ids.data_ptr(), H, W, float(s_lo),
            -1 if parity is None else int(parity), params.hrad,
            params.vrad, params.win_increment, float(params.cost_max),
            float(params.min_var), cost[c0].data_ptr(),
            ratio[c0].data_ptr(), best_view[c0].data_ptr(), stream)
        _build.check(code, "tsar_svol_ncc_multiview")
        LAUNCHES += 1
        LAUNCHES_BY_SHAPE[(Hc, Wc, n)] += 1
    shape = (*lead, Hc, Wc)
    return MultiviewCost(cost=cost.reshape(shape),
                         best_view=best_view.reshape(shape),
                         ratio=ratio.reshape(shape))
