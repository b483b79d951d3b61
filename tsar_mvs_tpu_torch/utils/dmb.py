"""DMB binary depth/normal-map codec.

Format (reference: fileIoUtils.h:260-381, readDmb/writeDmb/readDmbNormal/
writeDmbNormal): little-endian header of four int32 `type, h, w, nb`
(type 1 = float32) followed by h*w*nb float32 values, row-major, channel-
interleaved for nb > 1.

The port's own copy of ``tsar_mvs_tpu.utils.dmb``
(same semantics, no jax).
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

_HEADER = struct.Struct("<iiii")
_FLOAT_TYPE = 1


def read_dmb(path: str | Path) -> np.ndarray:
    """Read a .dmb file -> float32 array of shape (h, w) or (h, w, nb)."""
    data = Path(path).read_bytes()
    dtype_tag, h, w, nb = _HEADER.unpack_from(data, 0)
    if dtype_tag != _FLOAT_TYPE:
        raise ValueError(f"{path}: unsupported dmb type {dtype_tag}")
    payload = np.frombuffer(data, np.float32, count=h * w * nb,
                            offset=_HEADER.size)
    if payload.size != h * w * nb:
        raise ValueError(f"{path}: truncated dmb payload")
    arr = payload.reshape(h, w, nb)
    return arr[..., 0] if nb == 1 else arr


def write_dmb(path: str | Path, arr: np.ndarray) -> None:
    """Write a float32 array (h, w) or (h, w, nb) as .dmb."""
    arr = np.ascontiguousarray(arr, np.float32)
    if arr.ndim == 2:
        h, w = arr.shape
        nb = 1
    elif arr.ndim == 3:
        h, w, nb = arr.shape
    else:
        raise ValueError(f"dmb arrays must be 2-D or 3-D, got {arr.shape}")
    with open(path, "wb") as fh:
        fh.write(_HEADER.pack(_FLOAT_TYPE, h, w, nb))
        fh.write(arr.tobytes())
