"""Kernel B6: PatchMatch's checkerboard half-pass around the cost kernel
(``csrc/halfpass.cu``), four launches a pass kind:

* ``prop_select``: per pixel of the updating grid and bank, the stored-
  cost argmin sample's plane, its valid flag and its plane scalars;
* ``prop_accept``: the depth range check and the sequential accept over
  the banks, in place into the full state;
* ``refine_propose``: one refine scale's planes and plane scalars from
  the draws made before it;
* ``refine_accept``: cost < stored cost, in place.

The grid is the packed (H, W/2) parity class or the dense (H, W) grid
(odd sides; the accepts then update the parity's pixels only). Each
equals its plain version in ``ops/halfpass.py`` to the bit; the dispatch
there takes the plain version for CPU tensors. This module imports
nothing of ``ops/halfpass.py``. It replaces the XLA work around the
cost kernel in the JAX package's jitted PatchMatch step
(``tsar_mvs_tpu/models/patchmatch.py`` ``_propagation_pass``,
``_refinement_pass``; ``tsar_mvs_tpu/ops/checkerboard.py``
``select_candidates``); the JAX package has no TPU kernel for it.
"""

from __future__ import annotations

import ctypes
from collections import Counter

import torch

from tsar_mvs_tpu_torch import _build

# Kernel launches since the last reset (read by chip_smoke.py), in all and
# by (kernel, grid rows, grid columns, banks: 1 for the refine kernels).
LAUNCHES = 0
LAUNCHES_BY_SHAPE: Counter = Counter()

# Banks a launch and samples a bank (csrc/halfpass.cu's Banks table).
MAX_BANKS = 8
MAX_SAMPLES = 11
CONSTS = 13


def _count(kernel: str, Hc: int, Wc: int, banks: int = 1) -> None:
    global LAUNCHES
    LAUNCHES += 1
    LAUNCHES_BY_SHAPE[(kernel, Hc, Wc, banks)] += 1


def _grid(H: int, W: int, packed: bool, parity: int) -> tuple[int, int]:
    if parity not in (0, 1):
        raise ValueError(f"cuda_halfpass: parity must be 0 or 1, got "
                         f"{parity}")
    if packed and (H % 2 or W % 2):
        raise ValueError(f"cuda_halfpass: the packed grid needs even sides, "
                         f"got {H}x{W}")
    if 3 * H * W >= 1 << 31:
        raise ValueError(f"cuda_halfpass: image {H}x{W} exceeds the "
                         f"kernels' 32-bit indices")
    return H, (W // 2 if packed else W)


def _check(name: str, tensors: dict, device, shapes: dict,
           dtypes: dict | None = None) -> None:
    """Every tensor on `device`, contiguous, of its shape and dtype
    (float32 unless `dtypes` says otherwise)."""
    for key, t in tensors.items():
        want = (dtypes or {}).get(key, torch.float32)
        if not t.is_cuda or t.device != device:
            raise ValueError(f"cuda_halfpass.{name}: {key} must be a CUDA "
                             f"tensor on {device}")
        if t.dtype != want:
            raise TypeError(f"cuda_halfpass.{name}: {key} must be {want}, "
                            f"got {t.dtype}")
        if tuple(t.shape) != shapes[key]:
            raise ValueError(f"cuda_halfpass.{name}: {key} must be "
                             f"{shapes[key]}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"cuda_halfpass.{name}: {key} must be "
                             f"contiguous")


def _state_shapes(H: int, W: int) -> dict:
    return {"normal": (H, W, 3), "d": (H, W), "cost": (H, W),
            "ratio": (H, W), "best_view": (H, W)}


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def prop_select(normal, d, cost, parity: int, packed: bool, rays, consts,
                banks):
    """(cand_n (B, Hc, Wc, 3), cand_d, valid (bool), s0, sx, sy (B, Hc,
    Wc)) of the banks `banks` (each a sequence of (dx, dy)) at the grid's
    positions; normal (H, W, 3), d, cost (H, W) the state, rays (Hc, Wc,
    3), consts (13,) as ops/halfpass.Grid holds them."""
    H, W = d.shape
    Hc, Wc = _grid(H, W, packed, parity)
    B = len(banks)
    if not 1 <= B <= MAX_BANKS or any(not 1 <= len(b) <= MAX_SAMPLES
                                      for b in banks):
        raise ValueError(f"cuda_halfpass.prop_select: 1 to {MAX_BANKS} "
                         f"banks of 1 to {MAX_SAMPLES} samples")
    dev = d.device
    _check("prop_select", {"normal": normal, "d": d, "cost": cost,
                           "rays": rays, "consts": consts}, dev,
           {"normal": (H, W, 3), "d": (H, W), "cost": (H, W),
            "rays": (Hc, Wc, 3), "consts": (CONSTS,)})
    cand_n = torch.empty((B, Hc, Wc, 3), dtype=torch.float32, device=dev)
    cand_d = torch.empty((B, Hc, Wc), dtype=torch.float32, device=dev)
    valid = torch.empty((B, Hc, Wc), dtype=torch.bool, device=dev)
    s0, sx, sy = (torch.empty_like(cand_d) for _ in range(3))
    table = [0] * (2 * MAX_BANKS * MAX_SAMPLES)
    for b, bank in enumerate(banks):
        for s, (dx, dy) in enumerate(bank):
            table[2 * (b * MAX_SAMPLES + s)] = int(dx)
            table[2 * (b * MAX_SAMPLES + s) + 1] = int(dy)
    lens = (ctypes.c_int * B)(*(len(b) for b in banks))
    lib = _build.load_library()
    code = lib.tsar_halfpass_prop_select(
        normal.data_ptr(), d.data_ptr(), cost.data_ptr(), H, W, Wc,
        int(parity), int(packed), rays.data_ptr(), consts.data_ptr(),
        (ctypes.c_int * len(table))(*table), lens, B, cand_n.data_ptr(),
        cand_d.data_ptr(), valid.data_ptr(), s0.data_ptr(), sx.data_ptr(),
        sy.data_ptr(), _stream(dev))
    _build.check(code, "tsar_halfpass_prop_select")
    _count("prop_select", Hc, Wc, B)
    return cand_n, cand_d, valid, s0, sx, sy


def prop_accept(state, parity: int, packed: bool, cand_n, cand_d, valid, mv,
                consts) -> None:
    """The banks' sequential accept into `state` (a PlaneState of the full
    grid: normal (H, W, 3), d, cost, ratio f32 and best_view int32 (H, W))
    in place; cand_n, cand_d, valid from prop_select, mv the cost kernel's
    MultiviewCost of them (B, Hc, Wc)."""
    H, W = state.d.shape
    Hc, Wc = _grid(H, W, packed, parity)
    B = cand_d.shape[0]
    dev = state.d.device
    ints = {"best_view": torch.int32, "mv_view": torch.int32,
            "valid": torch.bool}
    _check("prop_accept", {**state._asdict(), "cand_n": cand_n,
                           "cand_d": cand_d, "valid": valid,
                           "mv_cost": mv.cost, "mv_ratio": mv.ratio,
                           "mv_view": mv.best_view, "consts": consts}, dev,
           {**_state_shapes(H, W), "cand_n": (B, Hc, Wc, 3),
            "cand_d": (B, Hc, Wc), "valid": (B, Hc, Wc),
            "mv_cost": (B, Hc, Wc), "mv_ratio": (B, Hc, Wc),
            "mv_view": (B, Hc, Wc), "consts": (CONSTS,)}, ints)
    lib = _build.load_library()
    code = lib.tsar_halfpass_prop_accept(
        *(t.data_ptr() for t in state), H, W, Wc, int(parity), int(packed),
        cand_n.data_ptr(), cand_d.data_ptr(), valid.data_ptr(),
        mv.cost.data_ptr(), mv.ratio.data_ptr(), mv.best_view.data_ptr(), B,
        consts.data_ptr(), _stream(dev))
    _build.check(code, "tsar_halfpass_prop_accept")
    _count("prop_accept", Hc, Wc, B)


def refine_propose(normal, d, parity: int, packed: bool, rays, vv, u, r,
                   consts, min_disp: float, max_disp: float, delta_z: float,
                   delta_n: float, eps: float):
    """(n_new (Hc, Wc, 3), d_new, s0, sx, sy (Hc, Wc)) of one refine scale
    from the state's normal (H, W, 3) and d (H, W) and the draws u (Hc,
    Wc), r (Hc, Wc, 3). The scale's numbers are rounded to float32 as
    torch rounds a Python float that meets a float32 tensor: -delta_n and
    2 delta_n as the plain version forms them."""
    H, W = d.shape
    Hc, Wc = _grid(H, W, packed, parity)
    dev = d.device
    _check("refine_propose", {"normal": normal, "d": d, "rays": rays,
                              "vv": vv, "u": u, "r": r, "consts": consts},
           dev, {"normal": (H, W, 3), "d": (H, W), "rays": (Hc, Wc, 3),
                 "vv": (Hc, Wc, 3), "u": (Hc, Wc), "r": (Hc, Wc, 3),
                 "consts": (CONSTS,)})
    n_new = torch.empty((Hc, Wc, 3), dtype=torch.float32, device=dev)
    d_new = torch.empty((Hc, Wc), dtype=torch.float32, device=dev)
    s0, sx, sy = (torch.empty_like(d_new) for _ in range(3))
    lib = _build.load_library()
    code = lib.tsar_halfpass_refine_propose(
        normal.data_ptr(), d.data_ptr(), H, W, Wc, int(parity), int(packed),
        rays.data_ptr(), vv.data_ptr(), u.data_ptr(), r.data_ptr(),
        consts.data_ptr(), float(min_disp), float(max_disp), float(delta_z),
        float(-delta_n), float(2.0 * delta_n), float(eps), n_new.data_ptr(),
        d_new.data_ptr(), s0.data_ptr(), sx.data_ptr(), sy.data_ptr(),
        _stream(dev))
    _build.check(code, "tsar_halfpass_refine_propose")
    _count("refine_propose", Hc, Wc)
    return n_new, d_new, s0, sx, sy


def refine_accept(state, parity: int, packed: bool, n_new, d_new,
                  mv) -> None:
    """cost < stored cost: the proposal (n_new (Hc, Wc, 3), d_new and the
    MultiviewCost mv (Hc, Wc)) replaces the state's plane, cost, ratio and
    best view in place."""
    H, W = state.d.shape
    Hc, Wc = _grid(H, W, packed, parity)
    dev = state.d.device
    _check("refine_accept", {**state._asdict(), "n_new": n_new,
                             "d_new": d_new, "mv_cost": mv.cost,
                             "mv_ratio": mv.ratio,
                             "mv_view": mv.best_view}, dev,
           {**_state_shapes(H, W), "n_new": (Hc, Wc, 3), "d_new": (Hc, Wc),
            "mv_cost": (Hc, Wc), "mv_ratio": (Hc, Wc),
            "mv_view": (Hc, Wc)},
           {"best_view": torch.int32, "mv_view": torch.int32})
    lib = _build.load_library()
    code = lib.tsar_halfpass_refine_accept(
        *(t.data_ptr() for t in state), H, W, Wc, int(parity), int(packed),
        n_new.data_ptr(), d_new.data_ptr(), mv.cost.data_ptr(),
        mv.ratio.data_ptr(), mv.best_view.data_ptr(), _stream(dev))
    _build.check(code, "tsar_halfpass_refine_accept")
    _count("refine_accept", Hc, Wc)
