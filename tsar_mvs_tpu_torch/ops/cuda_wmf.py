"""Kernel B4: the weighted median plane of one WMF pass.

``median_plane`` launches ``csrc/wmf.cu`` once for the whole image: per
pixel the bilateral weights of its neighbours at the pass's offsets, the
weighted medians of the disparity and of the three normal components,
the donor sample of the disparity median and the count of valid
samples, as ``ops/wmf.py::_median_plane_plain`` computes them (the
dispatch, ``wmf.median_plane``, takes the plain version for CPU tensors).
It replaces the JAX package's XLA weighted median
(``tsar_mvs_tpu/ops/wmf.py`` ``_gather_samples``, ``_weighted_median`` and
``_median_plane``); the JAX package has no TPU kernel for it.

A pixel's samples spread over LANES lanes, sample o on lane o % LANES;
each weight sum adds a lane's samples in order and then the lanes in a
halving tree. ``wmf.fixed_sum`` is that order, and the sums are monotone
in the key, so the kernel's search by rank (10 sums a median) finds the
key the plain version's 32-step descent finds: the kernel equals its
plain version to the bit. This module imports nothing of ``ops/wmf.py``.
"""

from __future__ import annotations

import ctypes

import torch

from tsar_mvs_tpu_torch import _build, trace


# Lanes a pixel and samples a lane (csrc/wmf.cu): a pass takes at most
# MAX_O offsets.
LANES = 8
PER_LANE = 16
MAX_O = LANES * PER_LANE
# The grid's rows are blockIdx.y.
MAX_ROWS = 65535


def gap_of(offsets) -> int:
    """The sample gap of a square offset grid (its smallest positive
    step), 0 for a single offset."""
    steps = sorted({abs(dx) for dx, _ in offsets} - {0})
    return steps[0] if steps else 0


def median_plane(gray: torch.Tensor, disp: torch.Tensor,
                 normal: torch.Tensor, reliable: torch.Tensor, offsets,
                 factors, inv_sc: float, radius: int):
    """(med_nx, med_ny, med_nz, donor_idx, donor_disp, num) of one pass in
    one launch: gray, disp (H, W) f32, normal (H, W, 3) f32, reliable
    (H, W) bool, all on one CUDA device; offsets the (dx, dy) table, at
    most MAX_O; factors their spatial weights (rounded to float32 here,
    as torch rounds a Python float that multiplies a float32 tensor);
    inv_sc 1 / sigma_color^2. The medians are f32, donor_idx and num
    int64, as the plain version returns them. `radius` keys the launch
    count only."""
    if not gray.is_cuda:
        raise ValueError("cuda_wmf.median_plane: CUDA tensors expected")
    if gray.dim() != 2:
        raise ValueError(f"cuda_wmf.median_plane: gray must be (H, W), got "
                         f"{tuple(gray.shape)}")
    H, W = gray.shape
    if (disp.shape != (H, W) or normal.shape != (H, W, 3)
            or reliable.shape != (H, W)):
        raise ValueError("cuda_wmf.median_plane: disp (H, W), normal (H, W, "
                         "3) and reliable (H, W) must match gray")
    for t in (disp, normal, reliable):
        if t.device != gray.device:
            raise ValueError("cuda_wmf.median_plane: tensors on different "
                             "devices")
    if (gray.dtype, disp.dtype, normal.dtype) != (torch.float32,) * 3:
        raise TypeError("cuda_wmf.median_plane: gray, disp and normal must "
                        "be float32")
    if reliable.dtype != torch.bool:
        raise TypeError("cuda_wmf.median_plane: reliable must be bool")
    O = len(offsets)
    if not 1 <= O <= MAX_O or len(factors) != O:
        raise ValueError(f"cuda_wmf.median_plane: 1 to {MAX_O} offsets with "
                         f"one factor each, got {O} and {len(factors)}")
    if H > MAX_ROWS or 3 * H * W >= 1 << 31 or min(H, W) < 1:
        raise ValueError(f"cuda_wmf.median_plane: image {H}x{W} is outside "
                         f"the kernel's grid and 32-bit indices")
    gray, disp, normal, reliable = (t.contiguous() for t in
                                    (gray, disp, normal, reliable))
    dev = gray.device
    med = torch.empty((3, H, W), dtype=torch.float32, device=dev)
    donor_disp = torch.empty((H, W), dtype=torch.float32, device=dev)
    donor_idx = torch.empty((H, W), dtype=torch.int64, device=dev)
    num = torch.empty((H, W), dtype=torch.int64, device=dev)
    offs = (ctypes.c_int * (2 * O))(*(int(v) for dxy in offsets
                                      for v in dxy))
    fac = (ctypes.c_float * O)(*(float(f) for f in factors))
    lib = _build.load_library()
    code = lib.tsar_wmf_median(
        gray.data_ptr(), disp.data_ptr(), normal.data_ptr(),
        reliable.data_ptr(), H, W, offs, fac, O, float(inv_sc),
        med[0].data_ptr(), med[1].data_ptr(), med[2].data_ptr(),
        donor_idx.data_ptr(), donor_disp.data_ptr(), num.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, "tsar_wmf_median")
    trace.count("launches.b4")
    trace.count("launches_by_shape.b4",
                (H, W, int(radius), gap_of(offsets)))
    return med[0], med[1], med[2], donor_idx, donor_disp, num
