"""Port parity for view sharding (`tsar_mvs_tpu_torch/parallel/`) and the
batched multi-reference runner, against `tsar_mvs_tpu/parallel/*` and the
JAX batched runner on the JAX package's own 48x64x8 proxy scene
(tests/test_parallel.py; conftest gives JAX 8 CPU devices).

Tolerances, per case:
- build_scene_batch: warp factors to 1e-6 (both cast float64 to float32);
  ids and masks exactly. svolume_plane_counts_batch, scale_batch and
  pad_batch: exactly.
- the batched cost on given planes with one invalid slot:
  tests/test_torch_ncc.py::assert_cost_agreement, the spec the s-volume
  and direct cost tests already use.
- patchmatch_one_ref against run_patchmatch on the same sources and
  generator: >= 98% of pixels within 1e-4 (tests/test_parallel.py::
  test_batched_matches_single).
- rl_cost_fused_traced: atol 1e-5 on textured pixels, and on >= 98% of
  all pixels, where the min_var knife edge (ROADMAP C3) is excluded as
  tests/test_torch_tsar.py::test_confidence_matches does.
- fuse_sharded + apply_used_list on GT depths: emit, count, consumed and
  the deduped emit exactly (so the deduped count at num_consistent=2
  equals JAX's); the point and normal sums within 1e-4 on >= 99.95% of
  the pixels, as tests/test_torch_fusion.py holds fusion_votes: 2 of the
  3072 pixels' point sums differ by up to 0.08, a source coordinate at a
  half-pixel tie that JAX's backprojection rounds to the neighbouring
  pixel.
- process_scene_sharded: mean acc2 within 0.03 of JAX's and fused F1@2cm
  within 0.03, both packages on the direct sampler (JAX's CPU "auto").
- ranks: groups of 1, 2 and 3 gloo ranks give bit-equal depths, normals
  and fused points.
"""

import dataclasses
import json
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_ncc import assert_cost_agreement

from tsar_mvs_tpu import geometry as jgeo
from tsar_mvs_tpu import pipeline as jpipeline
from tsar_mvs_tpu.config import AlgorithmParams, FusionParams
from tsar_mvs_tpu.models import patchmatch as jpm
from tsar_mvs_tpu.ops import checkerboard as jcb
from tsar_mvs_tpu.ops import ncc as jncc
from tsar_mvs_tpu.ops import sampling as jsampling
from tsar_mvs_tpu.ops import svolume as jsv
from tsar_mvs_tpu.parallel import mesh as jmesh
from tsar_mvs_tpu.parallel import scene_sharded as jss
from tsar_mvs_tpu.utils.synthetic import make_scene
from tsar_mvs_tpu_torch import cli, convert
from tsar_mvs_tpu_torch import eval as tev
from tsar_mvs_tpu_torch import geometry as tgeo
from tsar_mvs_tpu_torch import pipeline
from tsar_mvs_tpu_torch.config import AlgorithmParams as TParams
from tsar_mvs_tpu_torch.models import patchmatch as pm
from tsar_mvs_tpu_torch.ops import checkerboard as cb
from tsar_mvs_tpu_torch.ops import ncc
from tsar_mvs_tpu_torch.parallel import distributed
from tsar_mvs_tpu_torch.parallel import mesh as pmesh
from tsar_mvs_tpu_torch.parallel import scene_sharded as ss
from tsar_mvs_tpu_torch.utils import dmb
from tsar_mvs_tpu_torch.utils.synthetic import gt_cloud

torch.set_num_threads(2)
H, W, V = 48, 64, 8
# The end-to-end parameters of tests/test_parallel.py::
# test_process_scene_sharded_end_to_end.
E2E = dict(iterations=1, box_hsize=5, box_vsize=5, wmf_iters=1,
           wmf_final_iters=1, ransac_iters=200, ransac_anneal_rounds=10)
CPU = pmesh.ViewMesh(0, 1, torch.device("cpu"))


@pytest.fixture(scope="module")
def small_scene():
    return make_scene(height=H, width=W, num_views=V, seed=1)


def _sources(r):
    """Three sources per reference; reference 2 has two (1 and 3), so its
    last slot is padding (image id 0, not one of its sources)."""
    return [1, 3] if r == 2 else [j for j in range(V) if j != r][:3]


@pytest.fixture(scope="module")
def batches(small_scene):
    refs = list(range(V))
    src = [_sources(r) for r in refs]
    jb = jpm.build_scene_batch(list(small_scene.P), refs, src, 3)
    tb = pm.build_scene_batch(list(small_scene.P), refs, src, 3,
                              device="cpu")
    return jb, tb


def _acc2(depths, scene):
    gt = scene.depth
    ok = np.isfinite(gt)
    rel = np.abs(depths - gt) / np.where(ok, gt, 1.0)
    return float(np.mean([(rel[r] < 0.02)[ok[r]].mean()
                          for r in range(len(gt))]))


def test_build_scene_batch_matches_jax(batches):
    jb, tb = batches
    assert tb.ref_ids.dtype == tb.src_ids.dtype == torch.int32
    for f in ("ref_ids", "src_ids", "src_valid"):
        np.testing.assert_array_equal(getattr(tb, f).numpy(),
                                      np.asarray(getattr(jb, f)))
    assert not bool(tb.src_valid[2, 2]) and bool(tb.src_valid.sum() == 23)
    for f in ("A", "b"):
        np.testing.assert_allclose(getattr(tb, f).numpy(),
                                   np.asarray(getattr(jb, f)), rtol=0,
                                   atol=1e-6)
    conv = convert.scene_batch_from_jax(jb, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(conv, pm.SceneBatch(
        *(torch.as_tensor(np.asarray(x)) for x in jb))))


@pytest.mark.parametrize("s", [2.0, 4.0])
def test_plane_counts_and_scale_batch_match_jax(batches, s):
    jb, tb = batches
    params = AlgorithmParams(ncc_impl="svolume").with_depth_range(
        2.0, 9.0, 1.2 * W / s)
    for budget in (4096, 1):
        p = dataclasses.replace(params, svolume_budget_mb=budget)
        js = jmesh.scale_batch(jb, s)
        ts = pmesh.scale_batch(tb, s)
        np.testing.assert_array_equal(ts.A.numpy(), np.asarray(js.A))
        np.testing.assert_array_equal(ts.b.numpy(), np.asarray(js.b))
        jn = jpm.SceneBatch(*(np.asarray(x) for x in js))
        got = pm.svolume_plane_counts_batch(ts, H // int(s), W // int(s),
                                            convert.algorithm_params(p))
        assert got == jpm.svolume_plane_counts_batch(jn, H // int(s),
                                                     W // int(s), p)
    direct = convert.algorithm_params(dataclasses.replace(
        params, ncc_impl="direct"))
    assert pm.svolume_plane_counts_batch(tb, H, W, direct) is None


def test_pad_batch_and_local_slices_match_jax(batches):
    jb, tb = batches
    jp = jmesh.pad_batch(jax.tree.map(lambda a: a[:5], jb), 3)
    tp = pmesh.pad_batch(pmesh.batch_rows(tb, slice(0, 5)), 3)
    for a, b in zip(tp, jp):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert [distributed.process_local_slice(8, r, 3) for r in range(3)] == \
        [slice(0, 3), slice(3, 6), slice(6, 8)]
    assert distributed.process_local_slice(4, 2, 3) == slice(4, 4)
    assert distributed.process_local_slice(5) == slice(0, 5)
    with pytest.raises(ValueError, match="valid source"):
        pm.patchmatch_one_ref(torch.Generator().manual_seed(0),
                              torch.zeros((V, H, W)), 0, tp.src_ids[5],
                              tp.src_valid[5], tp.A[5], tp.b[5],
                              convert.camera_set(jgeo.build_camera_set(
                                  [np.eye(3, 4)] * 2), "cpu"),
                              TParams(), 1)


@pytest.fixture(scope="module")
def cost_setup(small_scene, batches):
    """Reference 2 (two sources and a padding slot) with 4 random planes
    per pixel, both packages' stats on the shared cameras."""
    jb, tb = batches
    scene = small_scene
    jc = jgeo.build_camera_set(list(scene.P), depth_min=scene.depth_min,
                               depth_max=scene.depth_max)
    params = AlgorithmParams().with_depth_range(
        scene.depth_min, scene.depth_max, float(jc.f))
    imgs = jnp.asarray(scene.images, jnp.float32)
    jstats = jncc.precompute_ref_stats(imgs[2], jc, params)
    rng = np.random.default_rng(4)
    n = rng.standard_normal((4, H, W, 3))
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    vv = np.asarray(jgeo.view_vectors(jc, H, W))
    n = np.where(np.sum(n * vv, -1, keepdims=True) > 0, -n, n)
    depth = rng.uniform(scene.depth_min * 1.05, scene.depth_max * 0.95,
                        (4, H, W))
    d = -depth * np.sum(n * np.asarray(jstats.rays), -1)
    return dict(jb=jb, tb=tb, jc=jc, tc=convert.camera_set(jc, "cpu"),
                params=params, imgs=imgs, jstats=jstats,
                tstats=convert.ref_stats(jstats, "cpu"),
                n=n.astype(np.float32), d=d.astype(np.float32))


@pytest.mark.parametrize("impl,parity", [("svolume", None), ("svolume", 0),
                                         ("direct", None), ("direct", 1)])
def test_batch_cost_matches_jax(cost_setup, small_scene, impl, parity):
    """batch_sampler and make_batch_cost_fn (the valid slots only)
    against the JAX batched runner's costs with src_valid masking the
    padding slot:
    sv.multiview_cost_svolume on the s-volume (volumes built by each
    package from the batch's factors) and ncc.multiview_cost_gathered on
    the direct sampler. Cost to assert_cost_agreement; best_view (image
    ids) equal where the winner is clear on both sides."""
    s = cost_setup
    jb, tb = s["jb"], s["tb"]
    params = dataclasses.replace(s["params"], ncc_impl=impl)
    tparams = convert.algorithm_params(params)
    src_ids, valid, A, b = jb.src_ids[2], jb.src_valid[2], jb.A[2], jb.b[2]
    n, d = s["n"], s["d"]
    jst, tst = s["jstats"], s["tstats"]
    coords = None
    if parity is not None:
        n = np.array(jcb.parity_compress_vec(jnp.asarray(n), parity))
        d = np.array(jcb.parity_compress(jnp.asarray(d), parity))
        jst = jncc.compress_stats(jst, parity)
        coords = jcb.parity_coords(H, W, parity)
    if impl == "svolume":
        counts = jpm.svolume_plane_counts_batch(
            jpm.SceneBatch(*(np.asarray(x) for x in jb)), H, W, params)
        s_lo, s_hi = jsv.s_range_for_depths(
            params.depth_min, params.depth_max, params.svolume_margin)
        jvol = jsv.build_svolume(s["imgs"][src_ids], A, b, s_lo, s_hi,
                                 counts, warp_plans=None)
        mj = jsv.multiview_cost_svolume(jvol, src_ids, valid,
                                        jnp.asarray(n), jnp.asarray(d), jst,
                                        params, parity=parity)
    else:
        counts = None
        packed = tuple(jsampling.pack_image(s["imgs"][int(i)], jnp.bfloat16)
                       for i in np.asarray(src_ids))
        mj = jax.jit(lambda n_, d_: jncc.multiview_cost_gathered(
            packed, A, b, src_ids, valid, n_, d_, jst, params,
            coords=coords))(jnp.asarray(n), jnp.asarray(d))
    sampler, ids = pm.batch_sampler(
        torch.as_tensor(small_scene.images), tb.src_ids[2], tb.src_valid[2],
        tb.A[2], tb.b[2], tparams, counts)
    assert ids.tolist() == [1, 3]
    cost_fn, pctx = pm.make_batch_cost_fn(tst, s["tc"], H, W, sampler, ids,
                                          tparams)
    assert pctx is not None
    mt = cost_fn(torch.as_tensor(n), torch.as_tensor(d), parity)
    cj, ct = np.asarray(mj.cost), mt.cost.numpy()
    assert ct.shape == cj.shape
    assert_cost_agreement(ct, cj)
    rj = np.asarray(mj.ratio)
    lead = np.where(rj > 0, cj / np.maximum(rj, 1e-12) - cj, 0.0)
    clear = (lead > 1e-2) & (np.maximum(cj, ct) < jncc.MAXCOST - 5e-3)
    assert clear.mean() > 0.3
    same = (mt.best_view.numpy() == np.asarray(mj.best_view))[clear]
    assert same.mean() > 0.995, float(same.mean())
    assert set(np.unique(mt.best_view.numpy())) <= {-1, 1, 3}


@pytest.mark.parametrize("impl", ["svolume", "direct"])
def test_patchmatch_one_ref_matches_run_patchmatch(small_scene, batches,
                                                   impl):
    """The batched unit against the port's static-id engine for the same
    sources and generator seed (the counterpart of tests/test_parallel.py
    ::test_batched_matches_single): >= 98% of pixels within 1e-4."""
    _, tb = batches
    scene = small_scene
    tc = geo_cams(scene)
    params = TParams(iterations=2, ncc_impl=impl).with_depth_range(
        scene.depth_min, scene.depth_max, float(tc.f))
    imgs = torch.as_tensor(scene.images)
    st_b = pm.patchmatch_one_ref(torch.Generator().manual_seed(3), imgs, 0,
                                 tb.src_ids[0], tb.src_valid[0], tb.A[0],
                                 tb.b[0], tc, params, 2)
    st_s = pm.run_patchmatch(torch.Generator().manual_seed(3), imgs,
                             (1, 2, 3), tc, params, iterations=2)
    same = np.isclose(st_b.d.numpy(), st_s.d.numpy(), rtol=1e-4, atol=1e-4)
    assert same.mean() > 0.98, same.mean()
    bv = st_b.best_view.numpy() == st_s.best_view.numpy()
    assert bv.mean() > 0.98, bv.mean()


def geo_cams(scene):
    return convert.camera_set(jgeo.build_camera_set(
        list(scene.P), depth_min=scene.depth_min,
        depth_max=scene.depth_max), "cpu")


def test_rl_cost_fused_traced_matches_jax(cost_setup, small_scene):
    """Reverse cost with per-slot factors on reference 2 (padding slot 2,
    image id 0 there): best_view draws ids 1, 3, -1 and 0, which only the
    padding slot holds, so it must cost 0."""
    s = cost_setup
    jb, tb = s["jb"], s["tb"]
    rng = np.random.default_rng(11)
    bv = rng.choice([-1, 0, 1, 3], (H, W)).astype(np.int32)
    n, d = s["n"][1], s["d"][1]
    src = jb.src_ids[2]
    cj = np.asarray(jncc.rl_cost_fused_traced(
        s["imgs"][2], s["imgs"][src], jnp.asarray(bv), src, jb.src_valid[2],
        jb.A[2], jb.b[2], s["jc"], jnp.asarray(n), jnp.asarray(d),
        s["params"]))
    imgs = torch.as_tensor(small_scene.images)
    tsrc = tb.src_ids[2].to(torch.int64)
    ct = ncc.rl_cost_fused_traced(
        imgs[2], imgs[tsrc], torch.as_tensor(bv), tb.src_ids[2],
        tb.src_valid[2], tb.A[2], tb.b[2], s["tc"], torch.as_tensor(n),
        torch.as_tensor(d), convert.algorithm_params(s["params"])).numpy()
    assert (ct[(bv < 0) | (bv == 0)] == 0).all()
    delta = np.abs(ct - cj)
    textured = ~small_scene.weak_mask[2]
    assert delta[textured].max() <= 1e-5, delta[textured].max()
    assert (delta <= 1e-5).mean() >= 0.98


@pytest.mark.parametrize("num_consistent", [1, 2])
def test_fuse_sharded_matches_jax(small_scene, num_consistent):
    """GT depths through both packages' fuse_sharded (JAX on its 8-device
    mesh, the port at world 1) and apply_used_list."""
    scene = small_scene
    jcw = jgeo.build_camera_set(list(scene.P), rebase=False)
    depths = np.where(np.isfinite(scene.depth), scene.depth,
                      0.0).astype(np.float32)
    normals = scene.normal_world.astype(np.float32)
    fp = FusionParams(used_list=True, num_consistent=num_consistent)
    jout = [np.asarray(x) for x in jmesh.fuse_sharded(
        jmesh.view_mesh(8), jnp.asarray(depths), jnp.asarray(normals), jcw,
        fp)]
    tout = pmesh.fuse_sharded(CPU, torch.as_tensor(depths),
                              torch.as_tensor(normals),
                              convert.camera_set(jcw, "cpu"),
                              convert.fusion_params(fp))
    for k, (t, j) in enumerate(zip(tout, jout)):
        if k < 2:
            close = np.isclose(t, j, rtol=0, atol=1e-4).all(-1)
            assert close.mean() >= 0.9995, close.mean()
        else:
            np.testing.assert_array_equal(t, j.astype(t.dtype))
    jd = jmesh.apply_used_list(jout[3].astype(bool), jout[4].astype(bool))
    td = pmesh.apply_used_list(tout[3], tout[4])
    np.testing.assert_array_equal(td, jd)
    assert td.sum() < tout[3].sum()


def test_fuse_sharded_padded_rows_are_zero(small_scene):
    """A padded view slot (view 0's camera, no depth map of its own) sends
    zeros: its rows and columns of every output are zero, and the other
    rows equal the unpadded run's."""
    scene = small_scene
    depths = torch.as_tensor(np.where(np.isfinite(scene.depth), scene.depth,
                                      0.0).astype(np.float32))
    normals = torch.as_tensor(scene.normal_world.astype(np.float32))
    fp = convert.fusion_params(FusionParams(used_list=True))
    P = list(scene.P)
    plain = pmesh.fuse_sharded(
        CPU, depths, normals,
        tgeo.build_camera_set(P, rebase=False, device="cpu"), fp)
    padded = pmesh.fuse_sharded(
        CPU, depths, normals,
        tgeo.build_camera_set(P + [P[0]], rebase=False, device="cpu"), fp)
    for k in range(4):
        np.testing.assert_array_equal(padded[k][:V], plain[k])
        assert not padded[k][V].any()
    np.testing.assert_array_equal(padded[4][:V, :V], plain[4])
    assert not padded[4][V].any() and not padded[4][:, V].any()
    assert plain[3].sum() > 1000


def test_process_scene_sharded_matches_jax(small_scene, tmp_path):
    """The whole slice in both packages on the direct sampler (JAX's CPU
    "auto"), held to the GT with the same floor: mean acc2 within 0.03 of
    JAX's, fused F1@2cm within 0.03."""
    root = small_scene.export(tmp_path / "scene")
    jparams = AlgorithmParams(ncc_impl="direct", **E2E)
    jd, jn, jcloud = jss.process_scene_sharded(
        jpipeline.load_scene(root), jparams, seed=0, pm_iterations=1,
        write_artifacts=False)
    scene = pipeline.load_scene(root)
    td, tn, tcloud = ss.process_scene_sharded(
        scene, convert.algorithm_params(jparams), seed=0, pm_iterations=1,
        mesh=CPU)
    assert td.shape == (V, H, W) and tn.shape == (V, H, W, 3)
    assert np.isfinite(td).all() and np.isfinite(tn).all()
    for name in scene.names:
        for f in ("TSAR_disp.dmb", "TSAR_normals.dmb"):
            assert (root / "results" / name / f).exists()
    assert (root / "results" / "TSAR_fused.ply").exists()
    np.testing.assert_array_equal(
        dmb.read_dmb(root / "results" / scene.names[3] / "TSAR_disp.dmb"),
        td[3])
    acc_j, acc_t = _acc2(np.asarray(jd), small_scene), _acc2(td,
                                                             small_scene)
    gt = gt_cloud(small_scene)
    f1_j = tev.point_cloud_fscore(jcloud.points, gt, threshold=0.02).f1
    f1_t = tev.point_cloud_fscore(tcloud.points, gt, threshold=0.02).f1
    print(f"acc2 JAX {acc_j} port {acc_t}; F1@2cm JAX {f1_j} port {f1_t}; "
          f"points JAX {len(jcloud.points)} port {len(tcloud.points)}")
    assert abs(acc_t - acc_j) <= 0.03
    assert abs(f1_t - f1_j) <= 0.03
    assert tcloud.points.shape[0] > 100


def rank_run(root: str, out: str) -> None:
    """One rank of a spawned gloo group: the scene on both samplers at one
    thread; rank 0 saves the results."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    scene = pipeline.load_scene(root)
    mesh = pmesh.view_mesh("cpu")
    assert mesh.world == dist.get_world_size() and mesh.device.type == "cpu"
    res = {}
    for impl in ("svolume", "direct"):
        depths, normals, cloud = ss.process_scene_sharded(
            scene, TParams(ncc_impl=impl, **E2E), seed=0, pm_iterations=1,
            mesh=mesh, write_artifacts=False)
        res.update({f"{impl}_depths": depths, f"{impl}_normals": normals,
                    f"{impl}_points": cloud.points})
    if mesh.rank == 0:
        np.savez(Path(out) / "out.npz", **res)


def test_world_size_invariance(small_scene, tmp_path):
    """Spawned gloo groups of 1, 2 and 3 ranks (8 references over 3 ranks
    pads the last rank's slice) give bit-equal depths, normals and fused
    points on both samplers."""
    root = small_scene.export(tmp_path / "scene")
    got = {}
    for world in (1, 2, 3):
        out = Path(tempfile.mkdtemp(dir=tmp_path))
        distributed.run_ranks(rank_run, world, f"file://{out}/pg", "gloo",
                              (str(root), str(out)))
        got[world] = dict(np.load(out / "out.npz"))
    for world in (2, 3):
        for key, ref in got[1].items():
            np.testing.assert_array_equal(got[world][key], ref,
                                          err_msg=f"{world} ranks: {key}")
    assert got[1]["svolume_points"].shape[0] > 100


def test_cli_scene_sharded_on_writes_artifacts(small_scene, tmp_path,
                                               monkeypatch):
    """`scene --sharded on --fuse --device cpu` (a world of one without the
    TSAR_* environment) writes every view's depth and normals and the
    fused cloud; without a card and without --device cpu it exits 1 and
    names the flag; -color_processing is not on the sharded path (exit
    2)."""
    for var in ("TSAR_COORDINATOR", "TSAR_NUM_PROCESSES",
                "TSAR_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    root = make_scene(height=H, width=W, num_views=3, seed=1).export(
        tmp_path / "scene")
    assert distributed.initialize() is False
    assert cli.main(["scene", str(root), "--sharded", "on", "--fuse",
                     "--iterations", "1", "--device", "cpu"]) == 0
    for name in ("00000000", "00000001", "00000002"):
        for f in ("TSAR_disp.dmb", "TSAR_normals.dmb"):
            assert (root / "results" / name / f).exists()
    assert (root / "results" / "TSAR_fused.ply").exists()
    assert cli.main(["scene", str(root), "--sharded", "on",
                     "-color_processing", "--device", "cpu"]) == 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fresh = make_scene(height=H, width=W, num_views=3, seed=1).export(
        tmp_path / "fresh")
    assert cli.main(["scene", str(fresh), "--sharded", "on"]) == 1
    assert not (fresh / "results").exists()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pmesh.view_mesh()


def resume_rank_run(root: str, out: str) -> None:
    """One rank of a spawned gloo group: process_scene("auto", resume);
    records which views it returned and whether every view's depth map
    was on disk when it returned."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    res = pipeline.process_scene(root, TParams(iterations=1), resume=True,
                                 device="cpu")
    names = pipeline.load_scene(root).names
    done = all((Path(root) / "results" / n / "TSAR_disp.dmb").exists()
               for n in names)
    (Path(out) / f"rank{dist.get_rank()}.json").write_text(json.dumps(
        {"returned": [r is not None for r in res], "all_on_disk": done}))


def test_process_scene_resume_in_group_runs_on_rank_0(tmp_path):
    """sharded="auto" with resume in a group of 2 ranks takes the
    sequential loop on rank 0 alone (view 0's earlier depth map is kept);
    rank 1 returns None entries, and only once every view is on disk."""
    root = make_scene(height=H, width=W, num_views=3, seed=2).export(
        tmp_path / "scene")
    pipeline.process_view(pipeline.load_scene(root), 0,
                          TParams(iterations=1),
                          torch.Generator().manual_seed(0), device="cpu")
    first = (root / "results" / "00000000" / "TSAR_disp.dmb").read_bytes()
    distributed.run_ranks(resume_rank_run, 2, f"file://{tmp_path}/pg",
                          "gloo", (str(root), str(tmp_path)))
    got = [json.loads((tmp_path / f"rank{k}.json").read_text())
           for k in range(2)]
    assert got[0] == {"returned": [False, True, True], "all_on_disk": True}
    assert got[1] == {"returned": [False, False, False], "all_on_disk": True}
    assert (root / "results" / "00000000" / "TSAR_disp.dmb").read_bytes() \
        == first


def test_process_scene_auto_without_group_is_sequential(tmp_path):
    """sharded="auto" without a process group runs the sequential loop,
    unchanged: per-view results and PLYs, equal to sharded=False."""
    root = make_scene(height=H, width=W, num_views=3, seed=2).export(
        tmp_path / "scene")
    params = TParams(iterations=1)
    auto = pipeline.process_scene(root, params, device="cpu")
    ply = root / "results" / "00000001" / "TSAR_model.ply"
    assert ply.exists()
    ply.unlink()
    off = pipeline.process_scene(root, params, device="cpu", sharded=False)
    assert ply.exists()
    assert len(auto) == 3 and all(r is not None for r in auto)
    for a, b in zip(auto, off):
        np.testing.assert_array_equal(a.depth, b.depth)
    with pytest.raises(ValueError, match="does not resume"):
        pipeline.process_scene(root, params, device="cpu", sharded=True,
                               resume=True)
