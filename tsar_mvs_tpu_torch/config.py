"""Algorithm configuration (the port's copy of ``tsar_mvs_tpu.config``).

One flag namespace with the reference's knob names so its scene scripts
translate 1:1 (reference: algorithmparameters.h:19-89, main.cpp:708-1009,
scripts/courtyard.sh:10-25).

Field names and defaults are those of the JAX package, less
`refine_block_frac`, which only its TPU kernel's tile-blocked refine draws
read; ``convert.algorithm_params`` builds these from the JAX package's
objects (its `ncc_impl="pallas"` becomes `"svolume"`: on the card the
s-volume path is the kernel that replaced the Pallas one).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class AlgorithmParams:
    """Mirror of AlgorithmParameters (algorithmparameters.h:19-89).

    Defaults follow the reference's constructor; the scene scripts override
    `box_hsize/box_vsize=11, iterations=8, gamma=10, cost_comb='best_n',
    n_best=1` (scripts/courtyard.sh:11-15).
    """

    # PatchMatch window (reference: box_hsize/box_vsize, default 19,
    # scripts use 11).
    box_hsize: int = 11
    box_vsize: int = 11
    # Window subsampling stride (reference: WIN_INCREMENT, gipuma.cu:37).
    win_increment: int = 2
    # PatchMatch iterations (red/black × prop+refine per iteration).
    iterations: int = 8
    # Iterations on pyramid levels WITH a lifted prior (the coarsest
    # level always runs the full `iterations`; the reference has no
    # pyramid, so this is a framework-own knob). A lifted prior leaves
    # only local (<= 2 px) error for the finer level, so a few
    # near-propagation + refine iterations converge it.
    # 0 = run the full `iterations` at every level.
    iterations_fine: int = 3
    # Bilateral NCC parameters (reference: pmCost, gipuma.cu:248-250).
    sigma_spatial: float = 5.0
    sigma_color: float = 3.0
    cost_max: float = 2.0
    min_var: float = 1e-5
    # Multi-view aggregation: mean of best n_best per-view costs
    # (reference: pmCostMultiview_cu, gipuma.cu:492-505).
    n_best: int = 1
    # Weight-function gamma (reference: gamma, used by hasImageTexture).
    gamma: float = 10.0
    # Depth range; loaded from cams/xxxx_cam.txt view 0
    # (fileIoUtils.h:145-153); disparities derived via f*baseline/depth.
    depth_min: float = -1.0
    depth_max: float = -1.0
    min_disparity: float = 0.0
    max_disparity: float = 256.0
    # Number of source views used for matching (reference: max_views=14).
    max_views: int = 14
    # Plane-refinement schedule (reference: planeRefinement_cu,
    # gipuma.cu:634-675): disparity radius max_disparity/2 shrinking /10
    # down to 0.01, normal radius 1.0 shrinking /4.
    refine_delta_z_shrink: float = 10.0
    refine_delta_n_init: float = 1.0
    refine_delta_n_shrink: float = 4.0
    refine_delta_z_min: float = 0.01
    # First random-search scale as a fraction of max_disparity
    # (reference: max_disparity/2, gipuma.cu:640). Coarse-to-fine levels
    # can shrink it since the prior already bounds the error.
    refine_dz0_frac: float = 0.5
    # refine_dz0_frac applied by the PYRAMID to levels after the
    # coarsest (run_patchmatch_pyramid): those levels start from a
    # lifted prior, so the reference's full +/-max_disparity/2
    # exploration only re-randomizes what the coarser level already
    # solved. The coarsest level keeps refine_dz0_frac.
    refine_dz0_frac_fine: float = 0.05
    # Image rescale factor applied to K (reference: cam_scale).
    cam_scale: float = 1.0
    # View-selection angles for the legacy angle-based path
    # (reference: selectViews, main.cpp:1011-1096).
    min_angle: float = 5.0
    max_angle: float = 45.0
    # Weak-texture detector constants (reference: main.cpp:59-64).
    rob_thr: int = 4
    hough_thr: int = 110
    min_line_length: int = 160
    max_line_gap: int = 18
    weak_text_num: int = 5000
    size_rat: float = 2.5
    # Region RANSAC (reference: main.cpp:1519-1730). The threshold
    # constants are world-scale dependent (the reference hardcodes
    # 0.0003/0.003/1e-4 for ETH3D metric scenes, main.cpp:1551,1645);
    # expose them so other scene scales can adapt.
    ransac_iters: int = 10000
    ransac_anneal_rounds: int = 1000
    ransac_max_points: int = 50000
    ransac_thr_base: float = 0.0003
    ransac_thr_max: float = 0.003
    ransac_thr_step: float = 0.0001
    # Ring of reliable pixels around a weak region also feeding its plane
    # fit. Default 0 = the reference behavior (points strictly inside the
    # region, main.cpp:1526-1535). A from-scratch prior can benefit from
    # anchoring the fit on the coplanar textured surround: set > 0 to
    # dilate the support (opt-in divergence).
    ransac_ring: int = 0
    # SLIC (reference: main.cpp:609-615). The reference configures
    # GIVEN_SIZE, so spixel_size governs the segment count; no_segs=4256
    # is informational there and is derived here from the image size.
    slic_spixel_size: int = 20
    slic_coh_weight: float = 5.0
    slic_iters: int = 5
    # WMF schedules (reference: gipuma_WMF / gipuma_WMF_Final,
    # gipuma.cu:1294-1698).
    wmf_iters: int = 4
    wmf_final_iters: int = 6
    wmf_sigma_spatial: float = 2.0
    wmf_sigma_color: float = 3.0
    # Median-drift outlier threshold in disparity units, halved per
    # iteration (24/2^i, gipuma.cu:1673,1686). Scale-dependent: 24 suits
    # ETH3D-resolution disparity ranges.
    wmf_drift_thr: float = 24.0
    # Confidence / LR check.
    lr_diff_clamp: float = 1.0
    # Region border-consistency veto (main.cpp:1735-1780): measure each
    # filled region's mean |depth jump| across its border (fed by
    # fakecuda's fake-depth map, gipuma.cu:1852-1877) and drop region
    # planes whose jump exceeds border_check_thr * depth_min. The
    # reference computes fakedepth but keeps the veto behind
    # `if (false)`; default True is a DOCUMENTED quality divergence:
    # good views keep completeness 1.0 while bad region planes veto out,
    # lifting the fused 2K scene's F1@2cm 0.906 -> 0.963 (RESULTS.md).
    # `--no_border_check` on the CLI restores reference-exact behavior.
    border_check: bool = True
    border_check_thr: float = 0.1
    # Color (float4-equivalent) matching (-color_processing,
    # main.cpp:766,909): 3-channel bilateral NCC on the direct sampler
    # (ops/ncc_color.py documents the reference divergence — its own
    # color path reads a float4 texture through tex2D<float>, UB).
    color_processing: bool = False
    # NCC sampler implementation for the PatchMatch hot loop.
    #   "auto"    — the epipolar s-volume when n_best == 1 (ops/svolume.py,
    #               kernels B1 and B2 on the card), the direct sampler
    #               otherwise (models/patchmatch.resolve_ncc_impl);
    #   "direct"  — always the exact per-sample gather path (ops/ncc.py,
    #               kernel B3 on the card);
    #   "svolume" — always the s-volume path.
    ncc_impl: str = "auto"
    # s-volume quality/memory knobs (ops/svolume.py): target epipolar
    # motion between adjacent planes (px), fractional s-range margin for
    # slanted windows, and a total volume memory budget that coarsens
    # step_px when exceeded. Default 2.0: the NCC window (11x11 stride
    # 2) does not resolve 1-px epipolar fidelity, and the volume halves.
    svolume_step_px: float = 2.0
    svolume_margin: float = 0.125
    svolume_budget_mb: int = 4096
    # Propagation banks used on pyramid levels WITH a lifted prior
    # (reference: 8 banks — 4 near V-shapes + 4 far combs,
    # gipuma.cu:874-1042; the coarsest level always keeps all 8).
    # The far combs exist to escape local minima during from-random
    # convergence; a lifted prior has already converged globally, so
    # fine levels only need the near banks' local propagation. 4 =
    # near-only (half the propagation candidates). 8 restores
    # reference-bank parity on all levels.
    prop_banks_fine: int = 4
    # EFFECTIVE bank count for a single run_patchmatch call (set by
    # run_patchmatch_pyramid from prop_banks_fine on lifted levels;
    # not a user knob). Banks are taken from the END of the table
    # (near banks last).
    prop_banks: int = 8

    @property
    def hrad(self) -> int:
        return (self.box_hsize - 1) // 2

    @property
    def vrad(self) -> int:
        return (self.box_vsize - 1) // 2

    def with_depth_range(self, depth_min: float, depth_max: float,
                         f: float, baseline: float = 1.0) -> "AlgorithmParams":
        """Set depth range and derive the disparity range.

        Mirrors main.cpp:1388-1399: min_disparity corresponds to depth_max
        and vice versa via disp = f*baseline/depth.
        """
        return dataclasses.replace(
            self,
            depth_min=float(depth_min),
            depth_max=float(depth_max),
            min_disparity=float(f) * baseline / float(depth_max),
            max_disparity=float(f) * baseline / float(depth_min),
        )


@dataclasses.dataclass(frozen=True)
class FusionParams:
    """Fusibile-style fusion operating point (reference: x/1.sh:19-30)."""

    depth_diff: float = 0.01
    normal_thresh_deg: float = 15.0
    num_consistent: int = 1
    reproj_error: float = 2.0
    used_list: bool = True
