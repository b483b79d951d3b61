"""Why PatchMatch from an APD prior loses accuracy on the 1344x2048
scene of chip_smoke.py, reproduced at conftest's 96x128x5 size and held
against the JAX reference.

Under the default 4096 MiB s-volume budget the full-resolution volume of
a 1344x2048 view with 7 sources keeps 18 to 211 planes per source: a
maximum epipolar spacing of about 34 px, against the 2 px design step
and a synthetic texture whose finest octave is about 2 px long at every
render size. `svolume_step_px=34` gives the small scene the same
spacing. From the same noisy prior, two PatchMatch iterations then move
the port and the JAX reference (s-volume sampler) off the prior alike:
acc2 after PatchMatch agrees within 0.03 and falls more than 0.3 below
the prior's. No refinement runs, so no JAX refinement program compiles
for these parameters.
"""

import dataclasses

import torch

from tsar_mvs_tpu.config import AlgorithmParams
from test_torch_pipeline import PARAMS, _acc2, jax_process_view, write_prior

torch.set_num_threads(2)

PLANE_SPACING_2K = 34.0


def test_apd_patchmatch_drop_at_2k_plane_spacing_matches_jax(scene,
                                                             tmp_path):
    from tsar_mvs_tpu_torch import convert
    from tsar_mvs_tpu_torch import pipeline as tpipe
    params = AlgorithmParams(svolume_step_px=PLANE_SPACING_2K, **PARAMS)
    root = scene.export(tmp_path / "jax" / "scene")
    prior = _acc2(write_prior(scene, root), scene)
    _, depth_pm = jax_process_view(
        root, params=dataclasses.replace(params, ncc_impl="svolume"),
        refine=False, pm_iterations=2, out_dir=tmp_path / "jax" / "out")
    acc = {"prior": prior, "jax": _acc2(depth_pm, scene)}
    root = scene.export(tmp_path / "torch" / "scene")
    write_prior(scene, root)
    res = tpipe.process_view(tpipe.load_scene(root), 0,
                             convert.algorithm_params(params),
                             pm_iterations=2,
                             out_dir=tmp_path / "torch" / "out",
                             device="cpu")
    acc["torch"] = _acc2(res.depth_pm, scene)
    assert abs(acc["torch"] - acc["jax"]) <= 0.03, acc
    assert max(acc["torch"], acc["jax"]) < prior - 0.3, acc
