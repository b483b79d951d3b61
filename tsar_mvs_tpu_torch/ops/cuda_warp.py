"""Kernel B2: the epipolar s-volume build of one source view.

``build_svolume_view`` launches ``csrc/warp.cu`` on a CUDA tensor and runs
``build_svolume_view_plain`` on a CPU tensor. Both compute, for planes
s_k = s_lo + k*ds, the bf16 volume W(k, y, x) = bilinear(src, q) with
q = (A p~ - b s_k) / (A p~ - b s_k)_z: the source rounded to bf16, f32
interpolation, coordinates clamped to the image box (a NaN coordinate
reads pixel 0). This is the gather build of
``tsar_mvs_tpu.ops.svolume.build_svolume``; it replaces the TPU kernel
``tsar_mvs_tpu/ops/pallas_warp.py::_warp_kernel`` for every view, with no
eligibility gate.
"""

from __future__ import annotations

import torch

from tsar_mvs_tpu_torch import _build, trace
from tsar_mvs_tpu_torch.ops.sampling import (bilinear_sample_packed,
                                             pack_image)

# Planes per step of the plain version (bounds its f32 temporaries).
_PLAIN_CHUNK = 16


def build_svolume_view_plain(src: torch.Tensor, A: torch.Tensor,
                             b: torch.Tensor, s_lo: float, ds: float,
                             S: int) -> torch.Tensor:
    """Plain PyTorch volume build: (S, H, W) bf16."""
    H, W = src.shape
    packed = pack_image(src, torch.bfloat16)
    xx = torch.arange(W, dtype=torch.float32, device=src.device)[None, :]
    yy = torch.arange(H, dtype=torch.float32, device=src.device)[:, None]
    u = [A[r, 0] * xx + A[r, 1] * yy + A[r, 2] for r in range(3)]
    out = torch.empty((S, H, W), dtype=torch.bfloat16, device=src.device)
    s_lo32 = torch.tensor(s_lo, dtype=torch.float32, device=src.device)
    ds32 = torch.tensor(ds, dtype=torch.float32, device=src.device)
    for k0 in range(0, S, _PLAIN_CHUNK):
        k = torch.arange(k0, min(S, k0 + _PLAIN_CHUNK), device=src.device,
                         dtype=torch.float32)[:, None, None]
        s = s_lo32 + k * ds32
        inv_w = 1.0 / (u[2] - b[2] * s)
        qx = (u[0] - b[0] * s) * inv_w
        qy = (u[1] - b[1] * s) * inv_w
        out[k0:k0 + k.shape[0]] = bilinear_sample_packed(
            packed, qx, qy).to(torch.bfloat16)
    return out


def build_svolume_view(src: torch.Tensor, A: torch.Tensor,
                       b: torch.Tensor, s_lo: float, ds: float,
                       S: int) -> torch.Tensor:
    """(S, H, W) bf16 volume of one view. src: (H, W) f32; A: (3, 3) and
    b: (3,) f32 on src's device. CUDA tensors launch the kernel; CPU
    tensors run the plain version."""
    if not src.is_cuda:
        return build_svolume_view_plain(src, A, b, s_lo, ds, S)
    if src.dim() != 2 or A.shape != (3, 3) or b.shape != (3,):
        raise ValueError("build_svolume_view: src (H, W), A (3, 3), b (3,)")
    if not (A.is_cuda and b.is_cuda and A.device == src.device
            and b.device == src.device):
        raise ValueError("build_svolume_view: tensors on different devices")
    if src.dtype != torch.float32:
        raise TypeError("build_svolume_view: src must be float32")
    if S < 2:
        raise ValueError("build_svolume_view: S must be >= 2")
    H, W = src.shape
    src_bf = src.to(torch.bfloat16).contiguous()
    Ab = torch.cat([A.reshape(9), b]).to(torch.float32).contiguous()
    out = torch.empty((S, H, W), dtype=torch.bfloat16, device=src.device)
    lib = _build.load_library()
    code = lib.tsar_warp_build(src_bf.data_ptr(), H, W, Ab.data_ptr(),
                               float(s_lo), float(ds), int(S),
                               out.data_ptr(),
                               torch.cuda.current_stream(src.device)
                               .cuda_stream)
    _build.check(code, "tsar_warp_build")
    trace.count("launches.b2")
    trace.count("launches_by_shape.b2", (int(S), H, W))
    return out
