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

What the kernel reads besides the plain version's inputs, built here once
per `DirectViews` with the plain version's own arithmetic: per source a
record per pixel (grayscale: the PackedImage's (H*W, 4) bf16; colour:
``color_record``, the three channels' corners in one 32-byte record) and
per window the table ``window_terms`` of T[view, offset] = i A[:, 0] + j
A[:, 1]. ``view_groups`` mirrors the kernel's compile-time split of the
views into groups whose moments share a walk of the window (``TILING``).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from tsar_mvs_tpu_torch import _build, trace
from tsar_mvs_tpu_torch.config import AlgorithmParams
from tsar_mvs_tpu_torch.ops import checkerboard as cb
from tsar_mvs_tpu_torch.ops.ncc import (MultiviewCost, aggregate,
                                        direct_cost, window_offsets)
from tsar_mvs_tpu_torch.ops.sampling import PackedImage, pack_image


# Candidates per launch (their moments and aggregation state stay in
# registers), source views per launch (the view table is a kernel
# argument) and the largest n_best (the kernel's sorted register array).
MAX_C = 8
MAX_V = 32
MAX_N_BEST = 32
# The kernel's candidate slots (a launch takes the smallest that holds
# its candidates), the (view, candidate) moment sets a thread may keep in
# registers at once, and its tiling by (slots, channels): views a thread
# walks the window with at once, offsets of a window column it takes at
# once, rows of its block (csrc/direct.cu: ACC_BUDGET, TSAR_B3_TILING).
CANDIDATE_SLOTS = (1, 4, 8)
ACC_BUDGET = 8
TILING = {(1, 1): (1, 6, 16), (1, 3): (4, 2, 8), (4, 1): (1, 3, 16),
          (4, 3): (1, 1, 16), (8, 1): (1, 2, 8), (8, 3): (1, 2, 8)}
# Shared memory the kernel stages one record per (view, window offset)
# in, and the most a block of the H100 may take.
VIEW_OFFSET_BYTES = 32
MAX_SHARED_BYTES = 232448
# The window whose columns the kernel takes in batches: (hrad, vrad,
# stride), 36 offsets.
STD_WINDOW = (5, 5, 2)


class DirectViews(NamedTuple):
    """The source views of one reference view for the direct sampler."""

    packed: tuple          # per view, a tuple of its channels' PackedImages
    records: tuple         # per view, the kernel's (H*W, 4 or 16) bf16
    A: torch.Tensor        # (V, 3, 3) f32 on the device
    b: torch.Tensor        # (V, 3)
    ids: torch.Tensor      # (V,) int64 view ids reported in best_view
    table: tuple           # host copies of A, b and ids for the kernel
    terms: dict            # window (hrad, vrad, inc) -> window_terms

    @property
    def channels(self) -> int:
        return len(self.packed[0])


def color_record(channels) -> torch.Tensor:
    """One 32-byte record per pixel from three channels' PackedImages:
    (H*W, 16) bf16 holding each channel's four bilinear corners in channel
    order, then four zeros. The values are the PackedImages' own bits, so
    the kernel reading it equals the plain version reading them."""
    data = [p.data for p in channels]
    return torch.cat(data + [torch.zeros_like(data[0])], dim=1)


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
    records = tuple(p[0].data if len(p) == 1 else color_record(p)
                    for p in packed)
    A = A.to(torch.float32)
    b = b.to(torch.float32)
    table = (tuple(float(x) for x in A.reshape(-1).cpu().tolist()),
             tuple(float(x) for x in b.reshape(-1).cpu().tolist()),
             tuple(int(x) for x in ids.cpu().tolist()))
    return DirectViews(packed=packed, records=records, A=A, b=b,
                       ids=ids.to(device=A.device, dtype=torch.int64),
                       table=table, terms={})


def window_terms(views: DirectViews, params: AlgorithmParams
                 ) -> torch.Tensor:
    """T[view, offset, r] = i * A[view, r, 0] + j * A[view, r, 1] for the
    window offsets (i, j) of `params`, the f32 expression `ncc.direct_cost`
    evaluates per offset (a multiply each, then the add): (V, O, 4) on the
    views' device, the fourth column 0. Built once per views and
    window."""
    key = (params.hrad, params.vrad, params.win_increment)
    if key not in views.terms:
        offs = window_offsets(params)
        dev = views.A.device
        fi = torch.tensor([float(i) for i, _ in offs], device=dev)
        fj = torch.tensor([float(j) for _, j in offs], device=dev)
        T = (fi[None, :, None] * views.A[:, None, :, 0]
             + fj[None, :, None] * views.A[:, None, :, 1])
        views.terms[key] = torch.cat([T, torch.zeros_like(T[..., :1])],
                                     dim=-1).contiguous()
    return views.terms[key]


def candidate_slots(C: int) -> int:
    """The kernel's candidate slots for a launch of C candidates."""
    return next(n for n in CANDIDATE_SLOTS if C <= n)


def view_groups(V: int, C: int, channels: int) -> list[range]:
    """The views a launch of C candidates in `channels` walks the window
    with at once, in order: groups of the tiling's size, the last one
    shorter (csrc/direct.cu: TSAR_B3_TILING)."""
    g = TILING[(candidate_slots(C), channels)][0]
    return [range(v, min(v + g, V)) for v in range(0, V, g)]


def instance_for(C: int, channels: int, V: int, n_best: int,
                 window: tuple[int, int, int]) -> tuple:
    """(candidate slots, channels, aggregation registers, default window)
    of the kernel instance a launch takes, as csrc/direct.cu picks it."""
    nb = 1 if n_best == 1 else (4 if n_best <= 4 or V <= 4 else MAX_N_BEST)
    return (candidate_slots(C), channels, nb, window == STD_WINDOW)


def kernel_attributes() -> list[dict]:
    """Registers and local (spilled) bytes of every kernel instance, from
    cudaFuncGetAttributes: [{"instance": [slots, channels, NB, default
    window], "registers": r, "local_bytes": l, "max_threads": t}]."""
    lib = _build.load_library()
    buf = (ctypes.c_int * (7 * 64))()
    n = lib.tsar_direct_instances(buf, 64)
    if n < 0:
        raise RuntimeError(f"tsar_direct_instances: CUDA error {-n}")
    return [{"instance": [buf[7 * k], buf[7 * k + 1], buf[7 * k + 2],
                          bool(buf[7 * k + 3])],
             "registers": buf[7 * k + 4], "local_bytes": buf[7 * k + 5],
             "max_threads": buf[7 * k + 6]} for k in range(min(n, 64))]


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
    if max(H, W) >= 1 << 22 or H * W >= 1 << 30:
        raise ValueError(f"multiview_cost_direct: image {H}x{W} is too "
                         f"large for the kernel's 32-bit indices")
    width, align = (4, 8) if CH == 1 else (16, 32)
    for rec in views.records:
        if (rec.dtype != torch.bfloat16 or not rec.is_contiguous()
                or rec.shape != (H * W, width) or rec.data_ptr() % align):
            raise TypeError(f"multiview_cost_direct: source records must "
                            f"be contiguous, {align}-byte aligned (H*W, "
                            f"{width}) bfloat16 of one image size")
    Hc, Wc = s0.shape[-2:]
    lead = s0.shape[:-2]
    expect = (H, W) if parity is None else (H, W // 2)
    if (Hc, Wc) != expect or sx.shape != s0.shape or sy.shape != s0.shape:
        raise ValueError(f"multiview_cost_direct: grid {(Hc, Wc)} does not "
                         f"match the sources {(H, W)} at parity {parity}")
    O = len(window_offsets(params))
    if VIEW_OFFSET_BYTES * V * O > MAX_SHARED_BYTES:
        raise ValueError(f"multiview_cost_direct: {V} views x {O} window "
                         f"offsets exceed the kernel's shared-memory table")
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
    terms = window_terms(views, params)
    for tsr in (s0, sx, sy, *fields, *views.records, terms):
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
    src_ptrs = (ctypes.c_void_p * V)(*(r.data_ptr() for r in views.records))
    A_arr = (ctypes.c_float * len(A_host))(*A_host)
    b_arr = (ctypes.c_float * len(b_host))(*b_host)
    id_arr = (ctypes.c_int * V)(*ids_host)
    window = (params.hrad, params.vrad, params.win_increment)
    lib = _build.load_library()
    stream = torch.cuda.current_stream(s0.device).cuda_stream
    for c0 in range(0, C, MAX_C):
        n = min(MAX_C, C - c0)
        code = lib.tsar_direct_multiview(
            s0c[c0].data_ptr(), sxc[c0].data_ptr(), syc[c0].data_ptr(), n,
            Hc, Wc, *(f.data_ptr() for f in fields), CH, src_ptrs, A_arr,
            b_arr, id_arr, V, H, W, -1 if parity is None else int(parity),
            *window, float(params.cost_max), float(params.min_var),
            int(params.n_best), terms.data_ptr(), O,
            cost[c0].data_ptr(), ratio[c0].data_ptr(),
            best_view[c0].data_ptr(), stream)
        _build.check(code, "tsar_direct_multiview")
        trace.count("launches.b3")
        trace.count("launches_by_shape.b3",
                    (Hc, Wc, n, CH, int(params.n_best)))
        trace.count("launches_by_instance.b3",
                    instance_for(n, CH, V, int(params.n_best), window))
    shape = (*lead, Hc, Wc)
    return MultiviewCost(cost=cost.reshape(shape),
                         best_view=best_view.reshape(shape),
                         ratio=ratio.reshape(shape))
