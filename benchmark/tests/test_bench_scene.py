"""The benchmark's card-side render against the program's numpy scene.

CPU only: ``benchmark.scene.make_scene`` on the CPU against
``tsar_mvs_tpu_torch.utils.synthetic.make_scene`` (geometry_jitter 0,
planar weak patch, no noise) at two sizes and three seeds, one of them
above 2**31 as the harness's seeds are.
"""

import numpy as np
import pytest

from benchmark import scene as bench_scene
from tsar_mvs_tpu_torch.utils.synthetic import make_scene


@pytest.mark.parametrize("height,width", [(96, 128), (160, 224)])
@pytest.mark.parametrize("seed", [0, 7, 3000000019])
def test_render_matches_program_scene(height, width, seed):
    ref = make_scene(height=height, width=width, num_views=5, seed=seed)
    got = bench_scene.make_scene(height, width, 5, seed, "cpu")
    img = got.images.numpy()
    # Images: float64 sums in another order can move a lattice
    # coordinate across an integer, and then the hash's floor picks
    # another cell at that pixel; allow such pixels, one in 10^4.
    off = np.abs(img - ref.images) > 1e-3
    assert off.mean() <= 1e-4
    # Depth: the program keeps float32 depths, the render float64; the
    # float32 rounding is 2**-24 relative, 6e-8.
    fin = np.isfinite(ref.depth)
    depth = got.depth.numpy()
    assert (np.isfinite(depth) == fin).all()
    assert (np.abs(depth[fin] - ref.depth[fin]) / ref.depth[fin]).max() \
        <= 2e-7
    # Normals: a rectangle's unit normal, float32 in the program.
    assert np.abs(got.normal_world.numpy() - ref.normal_world).max() <= 1e-7
    assert (got.weak_mask.numpy() == ref.weak_mask).mean() >= 1 - 1e-4
    # The depth range is taken from the float32 depths on both sides.
    assert got.depth_min == pytest.approx(ref.depth_min, rel=1e-12)
    assert got.depth_max == pytest.approx(ref.depth_max, rel=1e-12)
    np.testing.assert_allclose(got.P, ref.P, rtol=0, atol=0)


def test_pair_ranking_matches_export(tmp_path):
    """The in-memory pair ranking is what `export` writes to pair.txt."""
    from tsar_mvs_tpu_torch.utils.scene_io import read_pair_file
    ref = make_scene(height=48, width=64, num_views=6, seed=1)
    ref.export(tmp_path, pair_top_k=4)
    pair = read_pair_file(tmp_path / "pair.txt")
    got = bench_scene.pair_ranking(ref.R, ref.t, 4)
    assert {v: [j for j, _ in n] for v, n in got.items()} == \
        {v: [j for j, _ in n] for v, n in pair.neighbors.items()}
