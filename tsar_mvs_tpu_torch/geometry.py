"""Camera geometry and plane algebra (port of ``tsar_mvs_tpu.geometry``).

Host-side camera loading and rebasing run in float64 numpy, exactly as
the JAX package does; the result is packed into float32 tensors on the
requested device.

Conventions (Hartley & Zisserman, as the reference does):

* P = K [R|t] is 3x4; after rebasing the reference camera is K[I|0].
* A plane is (n, d) with n·X + d = 0 in the rebased reference frame.
* "disparity" is f*baseline/depth with baseline 1 (an involution).
* The plane-induced warp from the reference to view j is
  q ~ A p~ - b (n·ray(p)) / d with A = K R_j K^-1, b = K t_j.

Every 3x3 product is unrolled into float32 multiply-adds (``matvec3``)
so the order of operations matches the reference.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


# ---------------------------------------------------------------------------
# Host side (numpy, float64): decomposition and rebasing
# ---------------------------------------------------------------------------

def rq3(A: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """RQ decomposition of a 3x3 matrix: A = R_up @ Q, R_up upper
    triangular with a positive diagonal, Q orthonormal."""
    P_flip = np.flipud(A).T
    Q, R = np.linalg.qr(P_flip)
    R_up = np.flipud(R.T)[:, ::-1]
    Q_out = np.flipud(Q.T)
    S = np.diag(np.sign(np.diag(R_up)))
    return R_up @ S, S @ Q_out


def decompose_projection(P: np.ndarray
                         ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """P (3x4) -> K (K[2,2] = 1), R (3x3), camera centre C (3,)."""
    K, R = rq3(P[:, :3])
    if np.linalg.det(R) < 0:
        R = -R
    K = K / K[2, 2]
    return K, R, camera_center(P)


def camera_center(P: np.ndarray) -> np.ndarray:
    """Projective camera centre of P (3x4) by the determinant method."""
    def det_drop(col: int) -> float:
        return float(np.linalg.det(P[:, [c for c in range(4) if c != col]]))

    C = np.array([det_drop(0), -det_drop(1), det_drop(2), -det_drop(3)])
    return C[:3] / C[3]


def scale_K(K: np.ndarray, scale_factor: float) -> np.ndarray:
    """Divide focal lengths and principal point by scale_factor."""
    Ks = K.copy()
    Ks[0, 0] /= scale_factor
    Ks[1, 1] /= scale_factor
    Ks[0, 2] /= scale_factor
    Ks[1, 2] /= scale_factor
    return Ks


class CameraSet(NamedTuple):
    """Per-view cameras stacked over views (float32 tensors; view 0 is the
    reference, rebased to K[I|0]). Same fields as the JAX CameraSet."""

    P: torch.Tensor          # (V, 3, 4)
    K: torch.Tensor          # (V, 3, 3)
    K_inv: torch.Tensor      # (V, 3, 3)
    R: torch.Tensor          # (V, 3, 3)
    t: torch.Tensor          # (V, 3)
    C: torch.Tensor          # (V, 3)
    M_inv: torch.Tensor      # (V, 3, 3)
    P_col4: torch.Tensor     # (V, 3)
    R_orig: torch.Tensor     # (V, 3, 3)
    R_orig_inv: torch.Tensor  # (V, 3, 3)
    A: torch.Tensor          # (V, 3, 3) K R_j K^-1
    b: torch.Tensor          # (V, 3)    K t_j
    f: torch.Tensor          # () reference focal length
    fy: torch.Tensor         # ()
    alpha: torch.Tensor      # () fx / fy
    cx: torch.Tensor         # ()
    cy: torch.Tensor         # ()
    baseline: torch.Tensor   # () 1.0
    depth_min: torch.Tensor  # ()
    depth_max: torch.Tensor  # ()

    @property
    def device(self) -> torch.device:
        return self.P.device


def build_camera_set(P_list, cam_scale: float = 1.0,
                     depth_min: float = -1.0, depth_max: float = -1.0,
                     rebase: bool = True, *,
                     device: torch.device | str) -> CameraSet:
    """Decompose, rescale and rebase projection matrices so that view 0
    becomes K[I|0] (float64 on the host, as the JAX package does), then
    pack float32 tensors on `device`. Every view's P is rebuilt with the
    shared reference K, as the reference does."""
    V = len(P_list)
    Rs, ts = [], []
    Ks = []
    for P in P_list:
        K, R, C = decompose_projection(np.asarray(P, np.float64))
        Ks.append(K)
        Rs.append(R)
        ts.append(-R @ C)

    K_ref = scale_K(Ks[0], cam_scale)
    K_all = [scale_K(K, cam_scale) for K in Ks]
    T0 = np.eye(4)
    T0[:3, :3] = Rs[0]
    T0[:3, 3] = ts[0]
    transform = np.linalg.inv(T0) if rebase else np.eye(4)

    P_out = np.zeros((V, 3, 4))
    R_out = np.zeros((V, 3, 3))
    t_out = np.zeros((V, 3))
    C_out = np.zeros((V, 3))
    M_inv = np.zeros((V, 3, 3))
    K_inv = np.zeros((V, 3, 3))
    A = np.zeros((V, 3, 3))
    b = np.zeros((V, 3))
    R_orig = np.stack(Rs)
    R_orig_inv = np.stack([np.linalg.pinv(R) for R in Rs])
    K_ref_inv = np.linalg.inv(K_ref)
    for i in range(V):
        Ti = np.eye(4)
        Ti[:3, :3] = Rs[i]
        Ti[:3, 3] = ts[i]
        Tn = Ti @ transform
        Rn, tn = Tn[:3, :3], Tn[:3, 3]
        P_out[i] = K_ref @ Tn[:3, :4]
        R_out[i] = Rn
        t_out[i] = tn
        C_out[i] = camera_center(P_out[i])
        M_inv[i] = np.linalg.inv(P_out[i][:, :3])
        K_inv[i] = np.linalg.inv(K_all[i])
        A[i] = K_ref @ Rn @ K_ref_inv
        b[i] = K_ref @ tn

    def arr(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    return CameraSet(
        P=arr(P_out), K=arr(np.stack([K_ref] * V)),
        K_inv=arr(np.stack([K_ref_inv] * V)),
        R=arr(R_out), t=arr(t_out), C=arr(C_out), M_inv=arr(M_inv),
        P_col4=arr(P_out[:, :, 3]), R_orig=arr(R_orig),
        R_orig_inv=arr(R_orig_inv), A=arr(A), b=arr(b),
        f=arr(K_ref[0, 0]), fy=arr(K_ref[1, 1]),
        alpha=arr(K_ref[0, 0] / K_ref[1, 1]),
        cx=arr(K_ref[0, 2]), cy=arr(K_ref[1, 2]),
        baseline=arr(1.0),
        depth_min=arr(depth_min), depth_max=arr(depth_max),
    )


# ---------------------------------------------------------------------------
# Device side (float32): plane algebra, broadcasting over leading dims
# ---------------------------------------------------------------------------

def matvec3(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(…, 3, 3) @ (…, 3) -> (…, 3) as unrolled float32 multiply-adds."""
    return torch.stack(
        [M[..., 0, 0] * v[..., 0] + M[..., 0, 1] * v[..., 1]
         + M[..., 0, 2] * v[..., 2],
         M[..., 1, 0] * v[..., 0] + M[..., 1, 1] * v[..., 1]
         + M[..., 1, 2] * v[..., 2],
         M[..., 2, 0] * v[..., 0] + M[..., 2, 1] * v[..., 1]
         + M[..., 2, 2] * v[..., 2]], dim=-1)


def disparity_depth(f, baseline, d):
    """disp <-> depth involution f*baseline/d."""
    return f * baseline / d


def pixel_grid(height: int, width: int, device
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """(xx (1, W), yy (H, 1)) float32 pixel coordinates."""
    xx = torch.arange(width, dtype=torch.float32, device=device)[None, :]
    yy = torch.arange(height, dtype=torch.float32, device=device)[:, None]
    return xx, yy


def pixel_rays(cams: CameraSet, height: int, width: int) -> torch.Tensor:
    """ray(p) = K_ref^-1 [x, y, 1] for every pixel: (H, W, 3)."""
    dev = cams.device
    y = torch.arange(height, dtype=torch.float32, device=dev)
    x = torch.arange(width, dtype=torch.float32, device=dev)
    yy, xx = torch.meshgrid(y, x, indexing="ij")
    p = torch.stack([xx, yy, torch.ones_like(xx)], dim=-1)
    return matvec3(cams.K_inv[0], p)


def view_vectors(cams: CameraSet, height: int, width: int) -> torch.Tensor:
    """Unit viewing rays of the reference camera: (H, W, 3)."""
    rays = pixel_rays(cams, height, width)
    return rays / torch.linalg.vector_norm(rays, dim=-1, keepdim=True)


def plane_d_from_depth(normal: torch.Tensor, rays: torch.Tensor,
                       depth: torch.Tensor) -> torch.Tensor:
    """d with n·X + d = 0 at X = depth * ray."""
    return -depth * torch.sum(normal * rays, dim=-1)


def depth_from_plane(cams: CameraSet, normal: torch.Tensor,
                     d: torch.Tensor, xx: torch.Tensor,
                     yy: torch.Tensor) -> torch.Tensor:
    """Depth induced by plane (n, d) at pixel (x, y):
    -d*fx / (nx(x-cx) + ny(y-cy)*alpha + nz*fx)."""
    denom = (normal[..., 0] * (xx - cams.cx)
             + normal[..., 1] * (yy - cams.cy) * cams.alpha
             + normal[..., 2] * cams.f)
    return -d * cams.f / denom


def hemisphere_flip(normal: torch.Tensor,
                    view_vec: torch.Tensor) -> torch.Tensor:
    """Flip normals to face the camera (negate where n·view > 0)."""
    dp = torch.sum(normal * view_vec, dim=-1, keepdim=True)
    return torch.where(dp > 0.0, -normal, normal)


def backproject(cams: CameraSet, view: int, xx: torch.Tensor,
                yy: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """3-D point of pixel (x, y) at `depth` in a view:
    X = M_inv (depth*p~ - P_col4). Returns (..., 3)."""
    pc = cams.P_col4[view]
    p = torch.stack([depth * xx - pc[0], depth * yy - pc[1],
                     depth - pc[2]], dim=-1)
    return matvec3(cams.M_inv[view], p)


def project(cams: CameraSet, view: int, X: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Project 3-D points (..., 3) into a view: ((..., 2) pixels, (...)
    projective depth w = P3·X~)."""
    Pv = cams.P[view]
    q = matvec3(Pv[:, :3], X) + Pv[:, 3]
    return q[..., :2] / q[..., 2:3], q[..., 2]


def normalize(v: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    return v * torch.rsqrt(torch.sum(v * v, dim=-1, keepdim=True) + eps)
