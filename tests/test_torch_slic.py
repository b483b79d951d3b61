"""Port parity for SLIC: the CIELAB feature to float32 tolerance, the
superpixel labels on the scene's quarter-scale image, the superpixel
graph built from them, and the graph file's round trip. SLIC is
deterministic and both sides take the same float32 steps, so the labels
match exactly."""

import jax.numpy as jnp
import numpy as np
import torch

from tsar_mvs_tpu import pipeline as jpipe
from tsar_mvs_tpu.config import AlgorithmParams
from tsar_mvs_tpu.ops import slic as jslic
from tsar_mvs_tpu_torch import convert
from tsar_mvs_tpu_torch import pipeline as tpipe
from tsar_mvs_tpu_torch.ops import slic

torch.set_num_threads(2)


def test_feature_matches_jax(scene):
    gray = scene.images[0]
    np.testing.assert_allclose(
        slic.gray_to_feature(torch.as_tensor(gray)).numpy(),
        np.asarray(jslic.gray_to_feature(jnp.asarray(gray))),
        rtol=1e-5, atol=1e-4)


def test_slic_stage_and_graph_match_jax(scene, tmp_path):
    params = AlgorithmParams()
    gray = scene.images[0]
    j_full, j_res = jpipe.run_slic_stage(gray, params)
    t_full, t_res = tpipe.run_slic_stage(
        gray, convert.algorithm_params(params), device="cpu")
    j_lab = np.asarray(j_res.labels)
    t_lab = t_res.labels.numpy()
    np.testing.assert_array_equal(t_lab, j_lab)
    np.testing.assert_array_equal(t_full, j_full)
    assert t_full.shape == gray.shape
    assert t_res.map_size == tuple(j_res.map_size)

    graph = slic.superpixel_graph_host(j_lab)
    assert graph == jslic.superpixel_graph_host(j_lab)
    tpipe.write_slic_graph(tmp_path / "g.txt", *graph)
    assert tpipe.read_slic_graph(tmp_path / "g.txt") == graph
    assert jpipe.read_slic_graph(tmp_path / "g.txt") == graph
