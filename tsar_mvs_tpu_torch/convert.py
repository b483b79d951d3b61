"""numpy -> torch converters for state carried across from the JAX
package: its CameraSet, PlaneState and RefStats fields and s-volume data,
given as numpy arrays (or anything numpy converts), become the port's
NamedTuples of tensors on a device. No jax is imported here; callers
hand over arrays."""

from __future__ import annotations

import numpy as np
import torch

from tsar_mvs_tpu_torch.geometry import CameraSet
from tsar_mvs_tpu_torch.models.patchmatch import PlaneState
from tsar_mvs_tpu_torch.ops.ncc import RefStats
from tsar_mvs_tpu_torch.ops.svolume import SVolume


def tensor(a, device, dtype=None) -> torch.Tensor:
    """One array as a tensor on `device`; bfloat16 arrays (ml_dtypes)
    travel as float32 and are rounded back to bfloat16."""
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        return torch.as_tensor(arr.astype(np.float32),
                               device=device).to(torch.bfloat16)
    t = torch.as_tensor(np.array(arr), device=device)
    return t if dtype is None else t.to(dtype)


def _fields(cls, src, device):
    return cls(**{f: tensor(getattr(src, f), device) for f in cls._fields})


def camera_set(src, device="cpu") -> CameraSet:
    """A CameraSet from any object with CameraSet's field names."""
    return _fields(CameraSet, src, device)


def plane_state(src, device="cpu") -> PlaneState:
    """A PlaneState (normal, d, cost, ratio, best_view)."""
    return _fields(PlaneState, src, device)


def ref_stats(src, device="cpu") -> RefStats:
    return _fields(RefStats, src, device)


def svolume(src, device="cpu") -> SVolume:
    """An SVolume from the JAX SVolume's data (per-view bf16 volumes),
    s_lo and inv_ds."""
    return SVolume(data=tuple(tensor(v, device, torch.bfloat16)
                              for v in src.data),
                   s_lo=float(np.asarray(src.s_lo)),
                   inv_ds=tuple(float(np.asarray(x)) for x in src.inv_ds))
