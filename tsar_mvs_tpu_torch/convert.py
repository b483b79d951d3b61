"""numpy -> torch converters for state carried across from the JAX
package: its CameraSet, PlaneState and RefStats fields and s-volume data,
given as numpy arrays (or anything numpy converts), become the port's
NamedTuples of tensors on a device, and its parameter dataclasses become
the port's. No jax is imported here; callers hand over arrays and
objects."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tsar_mvs_tpu_torch.config import AlgorithmParams, FusionParams
from tsar_mvs_tpu_torch.geometry import CameraSet
from tsar_mvs_tpu_torch.models.patchmatch import PlaneState, SceneBatch
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


def camera_set(src, device) -> CameraSet:
    """A CameraSet from any object with CameraSet's field names."""
    return _fields(CameraSet, src, device)


def plane_state(src, device) -> PlaneState:
    """A PlaneState (normal, d, cost, ratio, best_view)."""
    return _fields(PlaneState, src, device)


def scene_batch_from_jax(src, device) -> SceneBatch:
    """A SceneBatch (ref_ids, src_ids, src_valid, A, b) from the JAX
    package's."""
    return _fields(SceneBatch, src, device)


def ref_stats(src, device) -> RefStats:
    return _fields(RefStats, src, device)


def svolume(src, device) -> SVolume:
    """An SVolume from the JAX SVolume's data (per-view bf16 volumes),
    s_lo and inv_ds."""
    return SVolume(data=tuple(tensor(v, device, torch.bfloat16)
                              for v in src.data),
                   s_lo=float(np.asarray(src.s_lo)),
                   inv_ds=tuple(float(np.asarray(x)) for x in src.inv_ds))


def _params(cls, src):
    """`cls` from the same-named fields of the dataclass `src`; fields the
    port does not have (`refine_block_frac`, which only the JAX package's TPU
    kernel reads) are dropped."""
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in dataclasses.asdict(src).items()
                  if k in names})


def algorithm_params(src) -> AlgorithmParams:
    """The port's AlgorithmParams from the JAX package's (or the port's).
    The JAX package's `ncc_impl="pallas"` becomes `"svolume"`: on the card
    the port's s-volume path is the kernel that replaced the Pallas one."""
    params = _params(AlgorithmParams, src)
    if params.ncc_impl == "pallas":
        params = dataclasses.replace(params, ncc_impl="svolume")
    return params


def fusion_params(src) -> FusionParams:
    return _params(FusionParams, src)
