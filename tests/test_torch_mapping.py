"""The port's semantic mapping against the JAX package's: back-projection,
voxel hashing, downsampling, the density filter, occupancy carving, 3-D
object extraction, the object database, the octomap export and the mapper
as a whole; and the live chain (detector -> objects -> database) through
the port's `System`.

Integer outputs (voxel ids, cluster labels, the fixed-size unique, the
`.bt` bytes) are exact. Float sums by scatter (centroids, log-odds) are
compared within f32 rounding: their order is not fixed on CUDA.
"""

import dataclasses
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgslam_tpu import config as jcfg
from sgslam_tpu.geometry import se3 as jse3
from sgslam_tpu.io import synthetic as jsyn
from sgslam_tpu.mapping import occupancy as jocc
from sgslam_tpu.mapping import octomap_io as jbt
from sgslam_tpu.mapping import pointcloud as jpc
from sgslam_tpu.mapping.semantic_mapper import SemanticMapper as JMapper
from sgslam_tpu.semantic import detector3d as jd3
from sgslam_tpu.semantic import objects as jobj
from sgslam_tpu.semantic.dynamic import Boxes as JBoxes
from sgslam_tpu_torch import config as tcfg
from sgslam_tpu_torch import convert
from sgslam_tpu_torch.io import synthetic as tsyn
from sgslam_tpu_torch.mapping import occupancy as tocc
from sgslam_tpu_torch.mapping import octomap_io as tbt
from sgslam_tpu_torch.mapping import pointcloud as tpc
from sgslam_tpu_torch.mapping.semantic_mapper import SemanticMapper as TMapper
from sgslam_tpu_torch.semantic import detector3d as td3
from sgslam_tpu_torch.semantic import objects as tobj


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(c):
    return c.synthetic_config(
        width=320, height=240,
        orb=c.OrbConfig(n_features=600, max_keypoints=640),
        capacity=c.MapCapacity(max_keyframes=64, max_points=8192,
                               local_window=4, local_points=1024))


JCFG, TCFG = _cfg(jcfg), _cfg(tcfg)
TOL_PT = 1e-5        # m, back-projected and averaged points (f32)
TOL_LOGODDS = 1e-5   # sums of the same two constants (measured 0)


def T(x):
    return torch.from_numpy(np.array(x))


def _np_dict(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _boxes(xyxy, cls, valid):
    B = 32
    a = np.zeros((B, 4), np.float32)
    a[:len(xyxy)] = xyxy
    c = np.zeros(B, np.int32)
    c[:len(cls)] = cls
    v = np.zeros(B, bool)
    v[:len(valid)] = valid
    jb = JBoxes(jnp.asarray(a), jnp.asarray(c), jnp.full(B, 0.8),
                jnp.asarray(v))
    return jb, convert.boxes_from_numpy(_np_dict(jb))


@pytest.fixture(scope="module")
def scene():
    """One props + person frame, its pose, and boxes: a person box (masked
    out of the cloud) and the ground-truth boxes of the three props."""
    seq = jsyn.SyntheticSequence(JCFG.camera, n_frames=24, dynamic=True,
                                 props=True)
    i = 6
    gray, depth = (np.array(x) for x in seq.frame(i))
    T_wc = np.array(seq.gt_pose_wc(i))
    T_cw = np.array(jse3.se3_inverse(jnp.asarray(T_wc)))
    props = [np.array(seq.gt_prop_box(i, q)[0]) for q in range(3)]
    obj = _boxes(props, [9, 20, 5], [True, True, True])
    dyn = _boxes([[100, 20, 170, 200]], [15], [True])
    return gray, depth, T_wc, T_cw, obj, dyn


def test_voxel_ids_exact():
    """int32 hash products wrap as in the reference; abs/modulo agree,
    including hashes at or near INT_MIN. The reference as its callers run
    it: jitted with a static cell size, which XLA turns into a product
    with the f32 reciprocal (eager JAX divides, and differs on 1 cell in
    ~10**5)."""
    rng = np.random.default_rng(0)
    pts = np.concatenate([
        rng.uniform(-3, 3, (5000, 3)),
        rng.uniform(-2e3, 2e3, (5000, 3))]).astype(np.float32)
    for vs, table in ((0.03, 1 << 15), (0.02, 1 << 14), (0.09, 1 << 15)):
        ij, kj = (np.asarray(x) for x in jax.jit(
            lambda p: jpc.voxel_ids(p, vs, table))(jnp.asarray(pts)))
        it, kt = (x.numpy() for x in tpc.voxel_ids(T(pts), vs, table))
        np.testing.assert_array_equal(kt, kj)
        np.testing.assert_array_equal(it, ij)
    # a cell whose hash is INT_MIN: abs stays negative; the floor modulo
    # still gives a valid id
    ijk = np.array([[0, 0, 0]], np.int32)
    assert int(tpc._hash(T(ijk), 1 << 15)[0]) == 0
    big = torch.tensor([[-2 ** 31 // 73856093, 0, 0]], dtype=torch.int32)
    hj = np.asarray(jnp.abs((jnp.asarray(big.numpy())[..., 0] * 73856093))
                    % (1 << 15))
    assert int(tpc._hash(big, 1 << 15)[0]) == int(hj[0])


def test_backproject_downsample_filter(scene):
    gray, depth, T_wc, _, _, (jdyn, tdyn) = scene
    cam = JCFG.camera
    pj, ij, vj = (np.asarray(x) for x in jpc.backproject_depth(
        cam, jnp.asarray(depth), jnp.asarray(gray), jnp.asarray(T_wc), jdyn))
    pt, it, vt = tpc.backproject_depth(cam, T(depth), T(gray), T(T_wc), tdyn)
    np.testing.assert_array_equal(vt.numpy(), vj)
    np.testing.assert_allclose(pt.numpy(), pj, atol=TOL_PT, rtol=0)
    np.testing.assert_array_equal(it.numpy(), ij)
    assert 0.5 * vj.size < vj.sum() < vj.size              # the box is out

    dj = [np.asarray(x) for x in jpc.voxel_downsample(
        jnp.asarray(pj), jnp.asarray(ij), jnp.asarray(vj), voxel_size=0.03)]
    dt = [x.numpy() for x in tpc.voxel_downsample(
        T(pj), T(ij), T(vj), voxel_size=0.03)]
    np.testing.assert_array_equal(dt[2], dj[2])
    np.testing.assert_allclose(dt[0][dj[2]], dj[0][dj[2]], atol=TOL_PT,
                               rtol=0)
    np.testing.assert_allclose(dt[1][dj[2]], dj[1][dj[2]], atol=1e-6, rtol=0)

    fj = np.asarray(jpc.density_outlier_filter(
        jnp.asarray(dj[0]), jnp.asarray(dj[2]), voxel_size=0.09,
        min_neighbors=4))
    ft = tpc.density_outlier_filter(T(dj[0]), T(dj[2]), voxel_size=0.09,
                                    min_neighbors=4).numpy()
    np.testing.assert_array_equal(ft, fj)
    assert 0 < ft.sum() < dj[2].sum()


def test_occupancy(scene):
    gray, depth, T_wc, *_ = scene
    rng = np.random.default_rng(1)
    pts = (T_wc[4:7] + rng.uniform(-2, 2, (3000, 3))).astype(np.float32)
    valid = rng.random(3000) < 0.9
    gj = jocc.empty_grid(64, 0.06, origin=(-1.92, -1.92, -1.92))
    gt = tocc.empty_grid(64, 0.06, origin=(-1.92, -1.92, -1.92))
    for _ in range(2):                               # clamps come into play
        gj = jocc.insert_scan(gj, jnp.asarray(T_wc[4:7]), jnp.asarray(pts),
                              jnp.asarray(valid))
        gt = tocc.insert_scan(gt, T(T_wc[4:7]), T(pts), T(valid))
    np.testing.assert_allclose(gt.logodds.numpy(), np.asarray(gj.logodds),
                               atol=TOL_LOGODDS, rtol=0)
    np.testing.assert_array_equal(tocc.project_2d(gt).numpy(),
                                  np.asarray(jocc.project_2d(gj)))
    assert tocc.occupied_mask(gt).sum() > 100


def test_octomap_bytes_exact(scene, tmp_path):
    gray, depth, T_wc, *_ = scene
    rng = np.random.default_rng(2)
    pts = (T_wc[4:7] + rng.uniform(-1.5, 1.5, (2000, 3))).astype(np.float32)
    gj = jocc.insert_scan(jocc.empty_grid(32, 0.06, origin=(-0.96,) * 3),
                          jnp.asarray(T_wc[4:7]), jnp.asarray(pts),
                          jnp.ones(2000, bool))
    gt = tocc.OccupancyGrid(T(gj.logodds), T(gj.origin), T(gj.voxel_size))
    oj = jbt.write_bt(str(tmp_path / "j.bt"), gj)
    ot = tbt.write_bt(str(tmp_path / "t.bt"), gt)
    np.testing.assert_array_equal(ot, oj)
    a, b = (open(tmp_path / f, "rb").read() for f in ("j.bt", "t.bt"))
    assert a == b and len(a) > 100
    occ, free, res = tbt.read_bt(str(tmp_path / "t.bt"))
    assert len(occ) > 0 and len(free) > 0 and abs(res - 0.06) < 1e-6


def test_cluster_labels_and_unique():
    rng = np.random.default_rng(3)
    blobs = [rng.normal(c, 0.01, (300, 3)) for c in
             ([0, 0, 2], [0.3, 0, 2], [0.3, 0.02, 2.05], [-1, 0.5, 3])]
    pts = np.concatenate(blobs + [rng.uniform(-2, 2, (400, 3))]).astype(
        np.float32)
    valid = rng.random(len(pts)) < 0.8
    lj = np.asarray(jd3.cluster_labels(jnp.asarray(pts), jnp.asarray(valid)))
    lt = td3.cluster_labels(T(pts), T(valid)).numpy()
    np.testing.assert_array_equal(lt, lj)
    for labels in (lj, np.full(50, 2 ** 30, np.int32),
                   rng.integers(0, 5, 80).astype(np.int32)):
        uj, cj = (np.asarray(x) for x in jnp.unique(
            jnp.asarray(labels), size=16, fill_value=2 ** 30,
            return_counts=True))
        ut, ct = (x.numpy() for x in td3._unique_smallest(T(labels), 16))
        np.testing.assert_array_equal(ut, uj)
        real = uj < 2 ** 30
        np.testing.assert_array_equal(ct[real], cj[real])


def test_extract_object(scene):
    gray, depth, T_wc, T_cw, (jo, to), (jdyn, tdyn) = scene
    cam = JCFG.camera
    pj, _, vj = jpc.backproject_depth(cam, jnp.asarray(depth),
                                      jnp.asarray(gray), jnp.asarray(T_wc),
                                      jdyn)
    h, w = depth.shape
    uv = np.stack(np.meshgrid(np.arange(w), np.arange(h)), -1).reshape(
        -1, 2).astype(np.float32)
    np.testing.assert_array_equal(tpc.pixel_grid(h, w, "cpu").numpy(), uv)
    n_ok = 0
    for b in range(3):
        cj, sj, okj = (np.asarray(x) for x in jd3.extract_object(
            cam, pj, jnp.asarray(uv), vj, jo.xyxy[b], jnp.asarray(T_cw)))
        ct, st, okt = (x.numpy() for x in td3.extract_object(
            cam, T(pj), T(uv), T(vj), to.xyxy[b], T(T_cw)))
        assert bool(okt) == bool(okj)
        np.testing.assert_allclose(ct, cj, atol=1e-4, rtol=0)
        np.testing.assert_allclose(st, sj, atol=1e-5, rtol=0)
        n_ok += int(okj)
    assert n_ok >= 1


def test_object_database():
    rng = np.random.default_rng(4)
    dj, dt = jobj.ObjectDB.empty(8), tobj.ObjectDB.empty(8)
    for k in range(30):
        c = rng.normal(0, 0.6, 3).astype(np.float32)
        s = rng.uniform(0.1, 1, 3).astype(np.float32)
        p = np.float32(rng.uniform(0.5, 1))
        cls = int(rng.choice([5, 9, 20, 7]))
        dj = jobj.add_object(dj, jnp.asarray(c), jnp.asarray(s),
                             jnp.float32(p), jnp.int32(cls))
        dt = tobj.add_object(dt, T(c), T(s), torch.tensor(p),
                             torch.tensor(cls, dtype=torch.int32))
    for k, v in _np_dict(dj).items():
        got = getattr(dt, k).numpy()
        if v.dtype.kind == "f":
            np.testing.assert_allclose(got, v, atol=1e-6, rtol=1e-6)
        else:
            np.testing.assert_array_equal(got, v)
    assert int(dt.next_id) == 8 and bool(dt.valid.all())   # capacity reached


def test_mapper_keyframes(scene):
    """Three keyframes through both mappers on the same inputs."""
    *_, (jo, to), (jdyn, tdyn) = scene
    seq = jsyn.SyntheticSequence(JCFG.camera, n_frames=24, dynamic=True,
                                 props=True)
    mj, mt = JMapper(JCFG), TMapper(TCFG, device="cpu")
    for i in (2, 6, 10):
        g, d = (np.array(x) for x in seq.frame(i))
        Tcw = np.array(seq.gt_pose_cw(i))
        mj.insert_keyframe(jnp.asarray(g), jnp.asarray(d), jnp.asarray(Tcw),
                           jdyn, jo)
        mt.insert_keyframe(T(g), T(d), T(Tcw), tdyn, to)
    # back-projected points differ by f32 ulps (the pose algebra rounds
    # differently), which moves a few points across voxel boundaries: the
    # clouds differ by a few points in 10**4 (measured 4 of 26709), and
    # the occupancy by the voxels those points reach
    assert abs(mt.n_global - mj.n_global) <= 1e-3 * mj.n_global
    assert mj.n_global > 1000
    lt, lj = mt.grid.logodds.numpy(), np.asarray(mj.grid.logodds)
    assert (np.abs(lt - lj) > TOL_LOGODDS).mean() < 1e-4
    assert (mt.occupancy_2d() != mj.occupancy_2d()).mean() < 1e-3
    vj = np.asarray(mj.objects.valid)
    np.testing.assert_array_equal(mt.objects.valid.numpy(), vj)
    np.testing.assert_array_equal(mt.objects.cls.numpy(),
                                  np.asarray(mj.objects.cls))
    np.testing.assert_allclose(mt.objects.centroid.numpy()[vj],
                               np.asarray(mj.objects.centroid)[vj],
                               atol=1e-4, rtol=0)
    assert vj.sum() >= 1


def test_live_objects_through_system():
    """tests/test_semantic_objects_live.py's run through the port: 24
    frames with people and props, detector and mapper on; at least one
    database object matches a prop by class within 0.5 m, and the
    occupancy map fills."""
    from sgslam_tpu_torch.geometry import se3 as tse3
    from sgslam_tpu_torch.slam.system import System

    seq = tsyn.SyntheticSequence(TCFG.camera, n_frames=24, dynamic=True,
                                 props=True, device="cpu")
    s = System(TCFG, enable_loop=False, enable_mapping=True, device="cpu")
    for i in range(24):
        g, d = seq.frame(i)
        s.track_rgbd(g, d, rgb=g[..., None].expand(-1, -1, 3))
    assert s.state == "OK"
    gt = tse3.se3_apply(tse3.se3_inverse(seq.poses[0])[None],
                        seq.props[:, :3]).numpy()
    gt_cls = seq.props[:, 5].numpy().astype(int)
    db = s.mapper.objects
    valid = db.valid.numpy()
    cents, clss = db.centroid.numpy()[valid], db.cls.numpy()[valid]
    hits = sum(bool(((clss == c) & (np.linalg.norm(cents - p, axis=1)
                                     < 0.5)).any())
               for p, c in zip(gt, gt_cls))
    assert hits >= 1, (clss, cents, gt)
    assert (s.mapper.occupancy_2d() > 0).sum() > 20
