"""Weak-texture (textureless-region) detection.

Rebuild of the reference's CPU stage `texture()` (main.cpp:214-596):
quarter-scale pyramid downsampling, Roberts edge + threshold, 4-connected
component labeling of the non-edge mask, Hough-line splitting of big
regions along straight region-boundary lines, relabeling, and the
bounding-box "trueweak" filter. Constants from main.cpp:59-64.

On the host (a CPU device) this is the reference's host stage in numpy
and scipy.ndimage, the plain version; on a CUDA device kernel B7
(``ops/cuda_weak_texture.py``, ``csrc/weak_texture.cu``) computes the
same ``WeakTexture`` to the bit. numpy + scipy.ndimage replace the
hand-rolled union-find; labels are
renumbered in raster first-encounter order to match Connect()'s numbering
(main.cpp:242-363). The reference's probabilistic HoughLinesP is replaced
by a deterministic accumulator-peak extractor with the same
threshold/min-length/max-gap semantics (OpenCV's random sampling isn't
reproducible anyway).

The port's own copy of ``tsar_mvs_tpu.models.weak_texture``
(same semantics, no jax).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from scipy import ndimage

from tsar_mvs_tpu_torch import trace
from tsar_mvs_tpu_torch.config import AlgorithmParams

_FOUR_CONN = np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]], bool)
_PYR_KERNEL = np.array([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0


def pyr_down(img: np.ndarray) -> np.ndarray:
    """cv::pyrDown: 5-tap Gaussian blur (reflect-101 border) + 2x decimate."""
    blurred = ndimage.correlate1d(img.astype(np.float64), _PYR_KERNEL,
                                  axis=0, mode="mirror")
    blurred = ndimage.correlate1d(blurred, _PYR_KERNEL, axis=1,
                                  mode="mirror")
    return blurred[::2, ::2]


def roberts(img: np.ndarray) -> np.ndarray:
    """Roberts cross edge magnitude (main.cpp:214-241): interior
    sqrt((I(y,x)-I(y+1,x+1))^2 + (I(y+1,x)-I(y,x+1))^2), borders forced to
    edge strength 100, saturated to uint8."""
    from tsar_mvs_tpu_torch.utils import native
    if img.dtype == np.uint8 or np.array_equal(img, np.rint(img)):
        out_native = native.roberts(img)
        if out_native is not None:
            return out_native
    img = img.astype(np.float64)
    out = np.full(img.shape, 100.0)
    d1 = img[:-1, :-1] - img[1:, 1:]
    d2 = img[1:, :-1] - img[:-1, 1:]
    mag = np.sqrt(d1 * d1 + d2 * d2)
    out[1:-1, 1:-1] = mag[1:, 1:]  # borders keep 100 (always edges)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def connect(edges: np.ndarray, weak_text_num: int
            ) -> tuple[np.ndarray, np.ndarray, list[int]]:
    """4-connected labeling of the non-edge mask (Connect,
    main.cpp:242-363): edge pixels -> label 0; components numbered 1.. in
    raster first-encounter order. Returns (labels, counts, weak_labels)
    where weak_labels have count > weak_text_num."""
    from tsar_mvs_tpu_torch.utils import native
    res = native.cc_label(edges)
    if res is not None:
        labels, _n = res
    else:
        mask = edges == 0
        raw, _n = ndimage.label(mask, structure=_FOUR_CONN)
        labels = _relabel_raster_order(raw)
    counts = np.bincount(labels.ravel())
    weak = [int(lab) for lab in range(1, counts.size)
            if counts[lab] > weak_text_num]
    return labels, counts, weak


def _relabel_raster_order(raw: np.ndarray) -> np.ndarray:
    flat = raw.ravel()
    uniq, first = np.unique(flat, return_index=True)
    order = uniq[np.argsort(first)]
    mapping = np.zeros(int(raw.max()) + 1, np.int32)
    nxt = 1
    for lab in order:
        if lab == 0:
            continue
        mapping[lab] = nxt
        nxt += 1
    return mapping[raw]


@dataclass
class Segment:
    x1: int
    y1: int
    x2: int
    y2: int


def hough_segments(mask: np.ndarray, threshold: int, min_line_length: int,
                   max_line_gap: int, max_lines: int = 64) -> list[Segment]:
    """Deterministic stand-in for cv::HoughLinesP (main.cpp:427-435 call
    site): accumulate votes over (rho, theta), repeatedly take the top
    cell, collect its supporting points ordered along the line, split at
    gaps > max_line_gap, keep runs >= min_line_length, and remove used
    points from the accumulator."""
    ys, xs = np.nonzero(mask)
    if xs.size == 0:
        return []
    pts = np.stack([xs, ys], axis=1).astype(np.float64)
    thetas = np.deg2rad(np.arange(180))
    cos_t = np.cos(thetas)
    sin_t = np.sin(thetas)
    diag = int(np.ceil(np.hypot(*mask.shape)))

    rhos = np.rint(pts[:, 0:1] * cos_t + pts[:, 1:2] * sin_t).astype(
        np.int64) + diag                       # (N, T)
    alive = np.ones(pts.shape[0], bool)
    acc = np.zeros((2 * diag + 1, 180), np.int64)
    np.add.at(acc, (rhos.ravel(),
                    np.tile(np.arange(180), pts.shape[0])), 1)

    segments: list[Segment] = []
    for _ in range(max_lines):
        peak = np.unravel_index(np.argmax(acc), acc.shape)
        if acc[peak] < threshold:
            break
        r_idx, t_idx = peak
        on_line = alive & (rhos[:, t_idx] == r_idx)
        idx = np.nonzero(on_line)[0]
        if idx.size == 0:
            acc[peak] = 0
            continue
        # Order along the line direction (-sin, cos).
        proj = -pts[idx, 0] * sin_t[t_idx] + pts[idx, 1] * cos_t[t_idx]
        order = np.argsort(proj)
        idx = idx[order]
        proj = proj[order]
        gaps = np.diff(proj)
        run_starts = np.concatenate([[0], np.nonzero(gaps > max_line_gap)[0]
                                     + 1])
        run_ends = np.concatenate([run_starts[1:], [idx.size]])
        used_any = False
        for s, e in zip(run_starts, run_ends):
            if proj[e - 1] - proj[s] >= min_line_length:
                p1, p2 = pts[idx[s]], pts[idx[e - 1]]
                segments.append(Segment(int(p1[0]), int(p1[1]),
                                        int(p2[0]), int(p2[1])))
                used = idx[s:e]
                alive[used] = False
                np.add.at(acc, (rhos[used].ravel(),
                                np.tile(np.arange(180), used.size)), -1)
                used_any = True
        if not used_any:
            acc[peak] = 0
    return segments


def draw_segment(img: np.ndarray, seg: Segment, value: int = 255) -> None:
    """Rasterize a 1-px line segment (cv::line equivalent, in-place)."""
    n = int(max(abs(seg.x2 - seg.x1), abs(seg.y2 - seg.y1))) + 1
    xs = np.rint(np.linspace(seg.x1, seg.x2, n)).astype(int)
    ys = np.rint(np.linspace(seg.y1, seg.y2, n)).astype(int)
    ok = (xs >= 0) & (xs < img.shape[1]) & (ys >= 0) & (ys < img.shape[0])
    img[ys[ok], xs[ok]] = value


def region_boundary(labels: np.ndarray, region: int) -> np.ndarray:
    """Pixels outside `region` 4-adjacent to it (main.cpp:393-421's
    boundary image)."""
    mask = labels == region
    dilated = ndimage.binary_dilation(mask, structure=_FOUR_CONN)
    return dilated & ~mask


@dataclass
class WeakTexture:
    """Output contract of texture(): per-pixel quarter-scale label map
    upsampled to full resolution (lines->canny) + per-region metadata
    (cannylines->{text, cenxi, cenyi, size})."""
    labels_full: np.ndarray   # (H, W) int32
    labels_small: np.ndarray  # (H/4, W/4) int32
    text: np.ndarray          # (M,) int8: -1 = trueweak region, +1 = normal
    cenx: np.ndarray          # (M,) float64 centroid x (full-res units)
    ceny: np.ndarray          # (M,) float64
    size: np.ndarray          # (M,) int32 max bbox side (trueweak only)
    counts: np.ndarray        # (M,) int64 quarter-scale pixel counts

    @property
    def num_regions(self) -> int:
        return self.text.shape[0]


def detect_weak_texture(gray: np.ndarray, params: AlgorithmParams,
                        pyr_levels: int = 2, device=None) -> WeakTexture:
    """Full texture() pipeline (main.cpp:365-596) on a full-res grayscale
    image in [0, 255]. pyr_levels=2 reproduces the reference's quarter
    scale (main.cpp:375-379); smaller images may use fewer levels.
    `device` None or a CPU device runs the plain version (numpy, scipy,
    the trace counter ``weak_texture.plain_calls``), a CUDA device kernel
    B7, which uploads `gray` and reads the result back. The trace counter
    ``weak_texture.segments`` counts the Hough segments drawn."""
    device = torch.device("cpu" if device is None else device)
    if device.type == "cuda":
        return _detect_b7(gray, params, pyr_levels, device)
    if device.type != "cpu":
        raise ValueError(f"detect_weak_texture: no kernel for a "
                         f"{device.type} device")
    trace.count("weak_texture.plain_calls")
    H, W = gray.shape
    scale = 2 ** pyr_levels
    with trace.span("weak_texture.edges"):
        down = gray
        for _ in range(pyr_levels):
            down = pyr_down(down)
        edges = roberts(down)
        edges = np.where(edges > params.rob_thr, 255, 0).astype(np.uint8)

    # Pass 1: find big regions, split them along straight boundary lines.
    with trace.span("weak_texture.label"):
        labels0, counts0, weak0 = connect(edges, params.weak_text_num)
    with trace.span("weak_texture.hough"):
        for region in weak0:
            boundary = region_boundary(labels0, region)
            segs = hough_segments(boundary, params.hough_thr,
                                  params.min_line_length,
                                  params.max_line_gap)
            trace.count("weak_texture.segments", n=len(segs))
            for seg in segs:
                draw_segment(edges, seg, 255)

        # Border cleanup (main.cpp:444-456): outermost row/col copies its
        # inner neighbor's non-edge status.
        edges[:, 0] = np.where(edges[:, 1] == 0, 0, edges[:, 0])
        edges[:, -1] = np.where(edges[:, -2] == 0, 0, edges[:, -1])
        edges[0, :] = np.where(edges[1, :] == 0, 0, edges[0, :])
        edges[-1, :] = np.where(edges[-2, :] == 0, 0, edges[-1, :])

    # Pass 2: final labeling + trueweak filter.
    with trace.span("weak_texture.label"):
        labels, counts, weak = connect(edges, params.weak_text_num)
    with trace.span("weak_texture.regions"):
        M = counts.size

        sy = np.arange(labels.shape[0])
        sx = np.arange(labels.shape[1])
        sum_x = np.bincount(labels.ravel(),
                            weights=np.broadcast_to(sx, labels.shape).ravel(),
                            minlength=M)
        sum_y = np.bincount(labels.ravel(),
                            weights=np.broadcast_to(sy[:, None],
                                                    labels.shape).ravel(),
                            minlength=M)
        cnt = np.maximum(counts, 1)
        cenx = sum_x * float(scale) / cnt   # full-res units (main.cpp:561-565)
        ceny = sum_y * float(scale) / cnt

        text = np.ones(M, np.int8)
        size = np.zeros(M, np.int32)
        slices = ndimage.find_objects(labels, max_label=M - 1)
        for lab in weak:
            sl = slices[lab - 1]
            if sl is None:
                continue
            ys_, xs_ = sl
            xsize = xs_.stop - 1 - xs_.start
            ysize = ys_.stop - 1 - ys_.start
            xysize = xsize * ysize
            # Trueweak: compact (bbox area < size_rat * count) or huge
            # (main.cpp:518-532).
            if xysize < params.size_rat * counts[lab] or counts[lab] > 100000:
                text[lab] = -1
                size[lab] = max(xsize, ysize)

        # Upsample labels to full res with index clamping (main.cpp:552-560).
        iy = np.minimum(np.arange(H) // scale, labels.shape[0] - 1)
        ix = np.minimum(np.arange(W) // scale, labels.shape[1] - 1)
        labels_full = labels[np.ix_(iy, ix)].astype(np.int32)

    return WeakTexture(labels_full=labels_full,
                       labels_small=labels.astype(np.int32), text=text,
                       cenx=cenx, ceny=ceny, size=size,
                       counts=counts.astype(np.int64))


def _detect_b7(gray: np.ndarray, params: AlgorithmParams, pyr_levels: int,
               device: torch.device) -> WeakTexture:
    """Kernel B7's stages inside the plain version's part spans."""
    from tsar_mvs_tpu_torch.ops import cuda_weak_texture as b7
    with trace.span("weak_texture.edges"):
        run = b7.Run(b7.upload(gray, device), params.rob_thr,
                     params.weak_text_num, params.hough_thr,
                     params.min_line_length, params.max_line_gap,
                     params.size_rat, pyr_levels)
        run.edges()
    with trace.span("weak_texture.label"):
        run.label(1)
    with trace.span("weak_texture.hough"):
        run.hough()
    with trace.span("weak_texture.label"):
        run.label(2)
    with trace.span("weak_texture.regions"):
        return WeakTexture(*run.regions())
