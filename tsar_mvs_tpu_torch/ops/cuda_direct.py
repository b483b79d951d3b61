"""Kernel B3: the direct sampler's multi-view NCC cost of candidate
planes, with the view aggregation.

``multiview_cost_direct`` launches ``csrc/direct.cu`` on CUDA tensors, once
for all views and up to MAX_C candidates, and runs
``multiview_cost_direct_plain`` on CPU tensors. Per view both evaluate,
per pixel of the dense grid (parity None) or of one packed parity class
(H, W/2), ``ncc.direct_cost``: the factored plane-induced warp with one
bilinear gather of the bf16 4-corner-packed source per window sample and
channel (one channel with ``ncc.RefStats``, three with
``ncc_color.ColorRefStats``), and cost_max for a candidate whose plane
coordinate is non-finite at any offset (d = 0 padding). Over the views
both aggregate as ``ncc.aggregate`` does: the streaming top-2 for n_best
== 1, the best-n mean of ``ncc.aggregate_view_costs`` above. This replaces
the JAX package's XLA direct sampler (``tsar_mvs_tpu/ops/ncc.py::
pm_cost_ab`` and ``tsar_mvs_tpu/ops/ncc_color.py::pm_cost_ab_color`` with
their aggregation); the JAX package has no TPU kernel for it.
"""

from __future__ import annotations

import ctypes
from collections import Counter
from typing import NamedTuple

import torch

from tsar_mvs_tpu_torch import _build
from tsar_mvs_tpu_torch.config import AlgorithmParams
from tsar_mvs_tpu_torch.ops import checkerboard as cb
from tsar_mvs_tpu_torch.ops.ncc import (MultiviewCost, aggregate,
                                        direct_cost, window_offsets)
from tsar_mvs_tpu_torch.ops.sampling import PackedImage, pack_image

# Kernel launches since the last reset (read by chip_smoke.py), in all and
# by (grid rows, grid columns, candidates of the launch, channels, n_best).
LAUNCHES = 0
LAUNCHES_BY_SHAPE: Counter = Counter()

# Candidates per launch (their moments and aggregation state stay in
# registers), source views per launch (the view table is a kernel
# argument) and the largest n_best (the kernel's sorted register array).
MAX_C = 8
MAX_V = 32
MAX_N_BEST = 32


class DirectViews(NamedTuple):
    """The source views of one reference view for the direct sampler."""

    packed: tuple          # per view, a tuple of its channels' PackedImages
    A: torch.Tensor        # (V, 3, 3) f32 on the device
    b: torch.Tensor        # (V, 3)
    ids: torch.Tensor      # (V,) int64 view ids reported in best_view
    table: tuple           # host copies of A, b and ids for the kernel

    @property
    def channels(self) -> int:
        return len(self.packed[0])


def make_views(src_imgs: torch.Tensor, A: torch.Tensor, b: torch.Tensor,
               ids: torch.Tensor) -> DirectViews:
    """Pack the sources once per PatchMatch run: src_imgs (V, H, W)
    grayscale or (V, 3, H, W) colour f32, A (V, 3, 3), b (V, 3), ids (V,).
    The kernel's view table (host floats) is read back here, once."""
    packed = tuple(
        (pack_image(img, torch.bfloat16),) if img.dim() == 2
        else tuple(pack_image(img[c], torch.bfloat16)
                   for c in range(img.shape[0]))
        for img in src_imgs)
    A = A.to(torch.float32)
    b = b.to(torch.float32)
    table = (tuple(float(x) for x in A.reshape(-1).cpu().tolist()),
             tuple(float(x) for x in b.reshape(-1).cpu().tolist()),
             tuple(int(x) for x in ids.cpu().tolist()))
    return DirectViews(packed=packed, A=A, b=b,
                       ids=ids.to(device=A.device, dtype=torch.int64),
                       table=table)


def multiview_cost_direct_plain(views: DirectViews, s0: torch.Tensor,
                                sx: torch.Tensor, sy: torch.Tensor, stats,
                                params: AlgorithmParams,
                                parity: int | None) -> MultiviewCost:
    """Plain PyTorch multi-view cost: per view ncc.direct_cost, then
    ncc.aggregate."""
    first: PackedImage = views.packed[0][0]
    coords = (None if parity is None
              else cb.parity_coords(first.height, first.width, parity,
                                    s0.device))
    per_view = [lambda v=v: direct_cost(views.packed[v], views.A[v],
                                        views.b[v], s0, sx, sy, stats,
                                        params, coords)
                for v in range(len(views.packed))]
    return aggregate(per_view, views.ids, params)


def multiview_cost_direct(views: DirectViews, s0: torch.Tensor,
                          sx: torch.Tensor, sy: torch.Tensor, stats,
                          params: AlgorithmParams,
                          parity: int | None) -> MultiviewCost:
    """Aggregated cost of (..., Hc, Wc) candidate plane scalars against the
    views. CUDA tensors launch the kernel (one launch per block of up to
    MAX_C candidates, all views inside); CPU tensors run the plain
    version."""
    if not s0.is_cuda:
        return multiview_cost_direct_plain(views, s0, sx, sy, stats, params,
                                           parity)
    global LAUNCHES
    V, CH = len(views.packed), views.channels
    if not 1 <= V <= MAX_V or views.ids.shape != (V,):
        raise ValueError(f"multiview_cost_direct: 1 to {MAX_V} views with "
                         f"one id each, got {V}")
    if CH not in (1, 3) or any(len(p) != CH for p in views.packed):
        raise ValueError("multiview_cost_direct: every view needs the same "
                         "1 or 3 channels")
    if not 1 <= params.n_best <= MAX_N_BEST:
        raise ValueError(f"multiview_cost_direct: n_best must be 1 to "
                         f"{MAX_N_BEST}, got {params.n_best}")
    H, W = views.packed[0][0].height, views.packed[0][0].width
    srcs = [p for view in views.packed for p in view]
    for p in srcs:
        if (p.data.dtype != torch.bfloat16 or not p.data.is_contiguous()
                or p.data.shape != (H * W, 4) or p.data.data_ptr() % 8):
            raise TypeError("multiview_cost_direct: sources must be "
                            "contiguous, 8-byte aligned (H*W, 4) bfloat16 "
                            "of one image size")
    Hc, Wc = s0.shape[-2:]
    lead = s0.shape[:-2]
    expect = (H, W) if parity is None else (H, W // 2)
    if (Hc, Wc) != expect or sx.shape != s0.shape or sy.shape != s0.shape:
        raise ValueError(f"multiview_cost_direct: grid {(Hc, Wc)} does not "
                         f"match the sources {(H, W)} at parity {parity}")
    O = len(window_offsets(params))
    lead_c = () if CH == 1 else (CH,)
    if (stats.weights.shape != (O, Hc, Wc)
            or stats.ref_centered.shape != (O, *lead_c, Hc, Wc)
            or stats.center.shape != (*lead_c, Hc, Wc)
            or any(f.shape != (Hc, Wc) for f in (stats.mean_ref,
                                                  stats.var_ref,
                                                  stats.inv_wsum))):
        raise ValueError("multiview_cost_direct: stats do not match the "
                         "grid and channels")
    fields = [stats.weights, stats.ref_centered, stats.mean_ref,
              stats.var_ref, stats.inv_wsum, stats.center]
    for tsr in (s0, sx, sy, *fields, *(p.data for p in srcs)):
        if tsr.device != s0.device:
            raise ValueError("multiview_cost_direct: tensors on different "
                             "devices")
    for tsr in (s0, sx, sy, *fields):
        if tsr.dtype != torch.float32:
            raise TypeError("multiview_cost_direct: float32 inputs expected")
    fields = [f.contiguous() for f in fields]
    C = 1
    for n in lead:
        C *= n
    s0c, sxc, syc = (a.reshape(C, Hc, Wc).contiguous()
                     for a in (s0, sx, sy))
    cost = torch.empty((C, Hc, Wc), dtype=torch.float32, device=s0.device)
    ratio = torch.empty_like(cost)
    best_view = torch.empty((C, Hc, Wc), dtype=torch.int32,
                            device=s0.device)
    A_host, b_host, ids_host = views.table
    src_ptrs = (ctypes.c_void_p * len(srcs))(*(p.data.data_ptr()
                                               for p in srcs))
    A_arr = (ctypes.c_float * len(A_host))(*A_host)
    b_arr = (ctypes.c_float * len(b_host))(*b_host)
    id_arr = (ctypes.c_int * V)(*ids_host)
    lib = _build.load_library()
    stream = torch.cuda.current_stream(s0.device).cuda_stream
    for c0 in range(0, C, MAX_C):
        n = min(MAX_C, C - c0)
        code = lib.tsar_direct_multiview(
            s0c[c0].data_ptr(), sxc[c0].data_ptr(), syc[c0].data_ptr(), n,
            Hc, Wc, *(f.data_ptr() for f in fields), CH, src_ptrs, A_arr,
            b_arr, id_arr, V, H, W, -1 if parity is None else int(parity),
            params.hrad, params.vrad, params.win_increment,
            float(params.cost_max), float(params.min_var),
            int(params.n_best), cost[c0].data_ptr(), ratio[c0].data_ptr(),
            best_view[c0].data_ptr(), stream)
        _build.check(code, "tsar_direct_multiview")
        LAUNCHES += 1
        LAUNCHES_BY_SHAPE[(Hc, Wc, n, CH, int(params.n_best))] += 1
    shape = (*lead, Hc, Wc)
    return MultiviewCost(cost=cost.reshape(shape),
                         best_view=best_view.reshape(shape),
                         ratio=ratio.reshape(shape))
