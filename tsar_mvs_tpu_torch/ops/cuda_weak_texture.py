"""Kernel B7: the weak-texture detection of one view.

``Run`` queues ``csrc/weak_texture.cu``'s launches for one gray image on
the current stream, stage by stage as ``models/weak_texture.py`` calls
them inside its part spans (``edges``, ``label`` twice, ``hough``), and
``regions`` reads the result back: ``(labels_full, labels_small, text,
cenx, ceny, size, counts)`` as numpy arrays, what the plain version
(``detect_weak_texture`` for a CPU device, numpy and scipy) returns, equal
to the bit. The JAX package and the reference run this stage on the host;
it has no TPU kernel. This module imports nothing of
``models/weak_texture.py``.

Host synchronisations a run: one read of the kernel's scalars (the
region count M, the segments drawn, the overflow flags) and one copy of
the labels and the table into pinned memory that the returned arrays own
(nothing is aliased across calls); ``upload`` sends the image through
pinned memory without waiting. The first run at a shape uploads its
constants (``constants``) once.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import numpy as np
import torch

from tsar_mvs_tpu_torch import _build, trace

# Mirrors of csrc/weak_texture.cu's constants.
THETAS = 180
PX = 256
SCAN_THREADS = 1024
MAX_LEVELS = 6
# A region's peak loop: a cluster of CLUSTER blocks, NTH_MAX angles of the
# accumulator each (16-bit cells); at most PEAK_CLUSTERS clusters.
CLUSTER = 16
NTH_MAX = -(-THETAS // CLUSTER)
PEAK_CLUSTERS = 8
# The scalars' slots (SC_*), 8 int32 in all.
SCALARS = ("nonint", "regions", "segments", "labels", "overflow")
N_SCALARS = 8
STAT_BYTES = 40
ROW = np.dtype([("cenx", "<f8"), ("ceny", "<f8"), ("count", "<i8"),
                ("size", "<i4"), ("text", "i1"), ("pad", "V3")])
# A peak block's dynamic shared memory (csrc/weak_texture.cu peak_smem: its
# cells, then 36 bytes a point) within the 227 KB a block can have, less its
# static arrays.
PEAK_BYTES_PER_POINT = 36
MAX_PEAK_SMEM = 232448 - 4096
# hough_segments' max_lines.
MAX_LINES = 64


def level_shapes(H: int, W: int, levels: int) -> list[tuple[int, int]]:
    """The image's shape, then each pyrDown level's (blurred[::2, ::2])."""
    shapes = [(H, W)]
    for _ in range(levels):
        h, w = shapes[-1]
        shapes.append(((h + 1) // 2, (w + 1) // 2))
    return shapes


def mirror(i: int, n: int) -> int:
    """scipy.ndimage's "mirror" border (reflect-101): the index that
    position i of a line of n samples reads."""
    if n == 1:
        return 0
    period = 2 * (n - 1)
    i %= period
    return i if i < n else period - i


def mirror_taps(n: int) -> np.ndarray:
    """(ceil(n / 2), 5) int32: the samples that pyrDown's five taps read
    for each kept output (2 r) of a line of n."""
    return np.array([[mirror(2 * r + k - 2, n) for k in range(5)]
                     for r in range((n + 1) // 2)], np.int32).reshape(-1, 5)


def trig_table() -> np.ndarray:
    """cos then sin of hough_segments' 180 angles, numpy's values."""
    thetas = np.deg2rad(np.arange(THETAS))
    return np.concatenate([np.cos(thetas), np.sin(thetas)])


@dataclass(frozen=True)
class Plan:
    """B7's launches for one image shape and weak_text_num: the level
    shapes, the most regions pass 1 can give (r_max), the peak loop's
    clusters, diag and the accumulator's rho bins (rows = 2 diag + 1, as
    hough_segments sizes them), the points a peak block can hold (cap,
    >= the most points one rho bin can take) and the kernels in launch
    order."""
    shapes: tuple
    r_max: int
    clusters: int
    diag: int
    rows: int
    cap: int
    kernels: tuple

    @property
    def small(self) -> tuple[int, int]:
        return self.shapes[-1]

    @property
    def peak_smem(self) -> int:
        """A peak block's dynamic shared memory (peak_smem of the
        source)."""
        cell_bytes = (NTH_MAX * self.rows + 1) // 2 * 4
        return -(-cell_bytes // 16) * 16 + PEAK_BYTES_PER_POINT * self.cap


def plan(H: int, W: int, levels: int, weak_text_num) -> Plan:
    shapes = tuple(level_shapes(H, W, levels))
    h, w = shapes[-1]
    # A region of more than weak_text_num pixels has at least `least`.
    least = max(math.floor(weak_text_num) + 1, 1)
    r_max = h * w // least
    diag = int(np.ceil(np.hypot(h, w)))
    # A rho bin is a strip one pixel wide: at most two pixels a column (a
    # row) where the line runs within 45 degrees of it.
    cap = 2 * max(h, w)
    kernels = ["pyr"] * levels if levels else ["intflag"]
    kernels.append("roberts")
    if r_max:
        kernels += ["merge", "count", "select", "bcount", "boffsets",
                    "bfill", "peaks"]
    kernels += ["init2", "merge", "roots", "scan", "rootlabel", "stats",
                "finish"]
    return Plan(shapes, r_max, min(r_max, PEAK_CLUSTERS), diag, 2 * diag + 1,
                cap, tuple(kernels))


def stage_kernels(p: Plan) -> dict[str, tuple]:
    """The plan's kernels by the entry point that launches them."""
    k = list(p.kernels)
    edges = k[:k.index("roberts") + 1]
    rest = k[len(edges):]
    label1 = rest[:2] if p.r_max else []
    rest = rest[len(label1):]
    hough = rest[:rest.index("init2") + 1]
    return {"edges": tuple(edges), "label1": tuple(label1),
            "hough": tuple(hough),
            "label2": tuple(rest[len(hough):-1]), "regions": ("finish",)}


class Args(ctypes.Structure):
    """csrc/weak_texture.cu's WeakArgs, field by field."""
    _fields_ = [(name, ctypes.c_void_p) for name in (
        "gray", "trig", "taps", "pyr", "scal", "cnt1", "bcount", "bfill",
        "edges", "parent1", "parent2", "slot_of", "boff", "pidx",
        "alive", "blockcnt", "blockoff", "stats", "out_full",
        "out_small", "table")] + [(name, ctypes.c_double) for name in (
            "rob_thr", "weak_text_num", "hough_thr", "min_line_length",
            "max_line_gap", "size_rat")] + [(name, ctypes.c_int) for name in (
                "gray_double", "H", "W", "levels", "h", "w", "max_lines",
                "r_max", "clusters", "diag", "rows", "cap")] + [
        ("level_h", ctypes.c_int * (MAX_LEVELS + 1)),
        ("level_w", ctypes.c_int * (MAX_LEVELS + 1)),
        ("taps_off", ctypes.c_longlong * MAX_LEVELS),
        ("pyr_off", ctypes.c_longlong * MAX_LEVELS)]


def _layout(sizes: list[tuple[str, int]]) -> tuple[dict, int]:
    """Byte offsets of named buffers laid one after another, each on a
    16-byte boundary, and the total."""
    off, at = {}, 0
    for name, nbytes in sizes:
        off[name] = at
        at += -(-nbytes // 16) * 16
    return off, at


def buffers(p: Plan) -> tuple[dict, int, dict, int, dict, int]:
    """(offsets, bytes) of the zeroed workspace, of the other workspace and
    of the output (labels_full, labels_small, then the table's rows)."""
    (H, W), (h, w) = p.shapes[0], p.small
    n = h * w
    bcap = min(4, p.r_max) * n
    nb = -(-n // PX)
    zero = _layout([("scal", 4 * N_SCALARS), ("cnt1", 4 * n if p.r_max
                                              else 0),
                    ("bcount", 4 * p.r_max), ("bfill", 4 * p.r_max)])
    work = _layout([("pyr", 8 * sum(a * b for a, b in p.shapes[1:])),
                    ("edges", n), ("parent1", 4 * n if p.r_max else 0),
                    ("parent2", 4 * n),
                    ("slot_of", 4 * n if p.r_max else 0),
                    ("boff", 4 * (p.r_max + 1)), ("pidx", 4 * bcap),
                    ("alive", 4 * bcap),
                    ("blockcnt", 4 * nb), ("blockoff", 4 * (nb + 1)),
                    ("stats", STAT_BYTES * (n + 1))])
    out = _layout([("out_full", 4 * H * W), ("out_small", 4 * n),
                   ("table", ROW.itemsize * (n + 1))])
    return (*zero, *work, *out)


_CONSTANTS: dict = {}


def constants(p: Plan, dev: torch.device) -> tuple[torch.Tensor, dict]:
    """The trig table and every level's mirror taps on `dev` in one
    tensor (uploaded once a device and shape) and the taps' offsets in
    int32 elements."""
    key = (dev, p.shapes)
    if key not in _CONSTANTS:
        taps, offs, at = [], [], 0
        for (sh, sw), (dh, dw) in zip(p.shapes[:-1], p.shapes[1:]):
            offs.append(at)
            taps += [mirror_taps(sh), mirror_taps(sw)]
            at += 5 * (dh + dw)
        blob = np.concatenate([trig_table().view(np.int32),
                               *(t.ravel() for t in taps)]).astype(np.int32)
        _CONSTANTS[key] = (torch.from_numpy(blob).to(dev), offs)
    return _CONSTANTS[key]


# The pinned staging buffer of `upload` by (device, shape, dtype), with the
# event that its last copy to the card completes.
_STAGING: dict = {}


def upload(gray: np.ndarray, dev) -> torch.Tensor:
    """The image on `dev`: float32 and float64 as they are, anything else
    as float64 (pyr_down's astype). To a card it goes through a pinned
    staging buffer kept a shape, without waiting for the card: the
    buffer is written again only once its last copy has completed, which
    a run's readback has waited for."""
    if gray.dtype not in (np.float32, np.float64):
        gray = gray.astype(np.float64)
    gray = np.ascontiguousarray(gray)
    dev = torch.device(dev)
    if dev.type != "cuda":
        return torch.from_numpy(gray).to(dev)
    key = (dev, gray.shape, gray.dtype.str)
    if key not in _STAGING:
        _STAGING[key] = (torch.from_numpy(gray).pin_memory(),
                         torch.cuda.Event())
    staging, copied = _STAGING[key]
    if not copied.query():
        copied.synchronize()
    staging.copy_(torch.from_numpy(gray))
    out = staging.to(dev, non_blocking=True)
    copied.record(torch.cuda.current_stream(dev))
    return out


class Run:
    """One image through B7: ``edges()``, ``label(1)``, ``hough()``,
    ``label(2)``, then ``regions()``, in that order. `gray` is an (H, W)
    float32 or float64 CUDA tensor; the parameters are
    AlgorithmParams'."""

    def __init__(self, gray: torch.Tensor, rob_thr, weak_text_num,
                 hough_thr, min_line_length, max_line_gap, size_rat,
                 pyr_levels: int = 2):
        if not isinstance(gray, torch.Tensor):
            raise ValueError("cuda_weak_texture.Run: gray must be a "
                             "tensor")
        if gray.dim() != 2:
            raise ValueError(f"cuda_weak_texture.Run: gray must be (H, W), "
                             f"got {tuple(gray.shape)}")
        if gray.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"cuda_weak_texture.Run: gray must be float32 "
                            f"or float64, got {gray.dtype}")
        if not 0 <= pyr_levels <= MAX_LEVELS:
            raise ValueError(f"cuda_weak_texture.Run: pyr_levels must lie "
                             f"in [0, {MAX_LEVELS}], got {pyr_levels}")
        H, W = gray.shape
        p = plan(H, W, pyr_levels, weak_text_num)
        h, w = p.small
        if min(h, w) < 2 or H * W >= 1 << 31:
            raise ValueError(f"cuda_weak_texture.Run: a {H}x{W} image gives "
                             f"a {h}x{w} level: at least 2x2 and fewer than "
                             f"2^31 pixels")
        if p.r_max and p.peak_smem > MAX_PEAK_SMEM:
            raise ValueError(f"cuda_weak_texture.Run: a {h}x{w} level needs "
                             f"{p.peak_smem} bytes of shared memory a peak "
                             f"block, more than a block holds")
        if not gray.is_cuda:
            raise ValueError("cuda_weak_texture.Run: gray must be a CUDA "
                             "tensor")
        dev = gray.device
        if pyr_levels == 0:
            gray = gray.double()
        self.gray = gray.contiguous()
        self.plan, self.dev = p, dev
        zoff, zbytes, woff, wbytes, ooff, obytes = buffers(p)
        self.ooff = ooff
        blob, taps_off = constants(p, dev)
        self.zero = torch.zeros(zbytes, dtype=torch.uint8, device=dev)
        self.work = torch.empty(wbytes, dtype=torch.uint8, device=dev)
        self.out = torch.empty(obytes, dtype=torch.uint8, device=dev)
        a = Args()
        a.gray = self.gray.data_ptr()
        a.trig = blob.data_ptr()
        a.taps = blob.data_ptr() + 8 * 2 * THETAS
        for offs, base in ((zoff, self.zero), (woff, self.work),
                           (ooff, self.out)):
            for name, at in offs.items():
                setattr(a, name, base.data_ptr() + at)
        a.rob_thr, a.weak_text_num, a.hough_thr = (
            float(rob_thr), float(weak_text_num), float(hough_thr))
        a.min_line_length, a.max_line_gap, a.size_rat = (
            float(min_line_length), float(max_line_gap), float(size_rat))
        a.gray_double = int(self.gray.dtype == torch.float64)
        a.H, a.W, a.levels, a.h, a.w = H, W, pyr_levels, h, w
        a.max_lines = MAX_LINES
        a.r_max, a.clusters = p.r_max, p.clusters
        a.diag, a.rows, a.cap = p.diag, p.rows, p.cap
        at = 0
        for lv, (sh, sw) in enumerate(p.shapes):
            a.level_h[lv], a.level_w[lv] = sh, sw
            if lv < pyr_levels:
                a.taps_off[lv] = taps_off[lv]
                a.pyr_off[lv] = at
                at += p.shapes[lv + 1][0] * p.shapes[lv + 1][1]
        self.args = a
        self.stages = stage_kernels(p)
        self.lib = _build.load_library()

    def _launch(self, stage: str, fn, *extra) -> None:
        code = fn(ctypes.addressof(self.args), *extra,
                  torch.cuda.current_stream(self.dev).cuda_stream)
        _build.check(code, fn.__name__)
        trace.count("launches.b7", n=len(self.stages[stage]))

    def edges(self) -> None:
        self._launch("edges", self.lib.tsar_weak_edges)

    def label(self, which: int) -> None:
        if which == 1 and not self.plan.r_max:
            return
        self._launch(f"label{which}", self.lib.tsar_weak_label, which)

    def hough(self) -> None:
        self._launch("hough", self.lib.tsar_weak_hough)

    def regions(self):
        """The region table's launch and the two readbacks: (labels_full,
        labels_small, text, cenx, ceny, size, counts)."""
        self._launch("regions", self.lib.tsar_weak_regions)
        scal = self.zero[:4 * N_SCALARS].view(torch.int32).tolist()
        if scal[SCALARS.index("overflow")]:
            raise RuntimeError(f"cuda_weak_texture: overflow "
                               f"{scal[SCALARS.index('overflow')]} (1: more "
                               f"regions than r_max, 2: more points on a "
                               f"line than cap)")
        trace.count("weak_texture.segments",
                    n=scal[SCALARS.index("segments")])
        M = scal[SCALARS.index("labels")]
        (H, W), (h, w) = self.plan.shapes[0], self.plan.small
        nbytes = self.ooff["table"] + ROW.itemsize * M
        host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        host.copy_(self.out[:nbytes], non_blocking=True)
        torch.cuda.current_stream(self.dev).synchronize()
        buf = host.numpy()
        full = buf[:4 * H * W].view(np.int32).reshape(H, W)
        at = self.ooff["out_small"]
        small = buf[at:at + 4 * h * w].view(np.int32).reshape(h, w)
        rows = buf[self.ooff["table"]:nbytes].view(ROW)
        return (full, small, np.ascontiguousarray(rows["text"]),
                np.ascontiguousarray(rows["cenx"]),
                np.ascontiguousarray(rows["ceny"]),
                np.ascontiguousarray(rows["size"]),
                np.ascontiguousarray(rows["count"]))
