"""The port's dynamic-feature cull against the JAX package's: box tests,
frame-to-frame ORB correspondences, and the F-RANSAC + epipolar cull on
frames of tests/test_system_dynamic.py's sequence, with the JAX package's
features and detector boxes as the common input.

The cull cannot match bit for bit: half of the RANSAC hypotheses fail to
factor in f32 and which ones do depends on rounding (test_torch_epipolar).
With the reference's draws replayed, the port is held to the reference's
own spread under one-ulp moves of the keypoints, measured by
`python tools/parity_spread.py cull --seeds 4` (CPU): on the three frame
pairs below the reference flips 0-64 keep flags of its own and moves its F
inlier count by up to 7; the port flips 55, 52 and 0 and moves it by 6, 0
and 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgslam_tpu import config as jcfg
from sgslam_tpu.io import synthetic as jsyn
from sgslam_tpu.models import detector as jdet
from sgslam_tpu.semantic import dynamic as jdyn
from sgslam_tpu.slam import tracking as jtr
from sgslam_tpu_torch import config as tcfg
from sgslam_tpu_torch import convert
from sgslam_tpu_torch.semantic import dynamic as tdyn


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
CULL_PAIRS = (5, 12, 21)
# the reference's own spread (tools/parity_spread.py cull, see above)
MAX_KEEP_FLIPS = 64
MAX_INLIER_GAP = 7


def T(x):
    return torch.from_numpy(np.array(x))


def _np_dict(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in obj.__dataclass_fields__.values()}


class Replay:
    """The reference's draws of `key`: `randint` over max(n_valid, 8)."""

    def __init__(self, key):
        self.key = key
        self.calls = 0

    def __call__(self, n_valid, iters):
        self.calls += 1
        r = jax.random.randint(self.key, (iters, 8), 0, max(int(n_valid), 8))
        return torch.from_numpy(np.asarray(r).astype(np.int64))


@pytest.fixture(scope="module")
def pairs():
    seq = jsyn.SyntheticSequence(JCFG.camera, n_frames=30, dynamic=True)
    det = jdet.Detector2D(JCFG.detector)
    w, h = JCFG.camera.width, JCFG.camera.height
    out = {}
    for i in CULL_PAIRS:
        gp, dp = seq.frame(i - 1)
        gc, dc = seq.frame(i)
        fp = jtr.extract_frame(JCFG, gp, dp)
        fc = jtr.extract_frame(JCFG, gc, dc)
        prev_map = det.detect(jnp.repeat(gp[..., None], 3, -1), w, h)[2]
        cur_cull = det.detect(jnp.repeat(gc[..., None], 3, -1), w, h)[1]
        out[i] = (fp, fc, prev_map, cur_cull, gp, gc)
    return out


def test_in_any_box():
    rng = np.random.default_rng(0)
    xy = rng.uniform(0, 320, (500, 2)).astype(np.float32)
    xy[:4] = [[10, 10], [50, 60], [50, 10], [10, 60]]   # box corners
    lo = rng.uniform(0, 250, (32, 2)).astype(np.float32)
    xyxy = np.concatenate([lo, lo + rng.uniform(5, 80, (32, 2))], 1)
    xyxy[0] = [10, 10, 50, 60]
    valid = rng.random(32) < 0.5
    valid[0] = True
    mask = rng.random(32) < 0.7
    mask[0] = True
    jb = jdyn.Boxes(jnp.asarray(xyxy.astype(np.float32)),
                    jnp.zeros(32, jnp.int32), jnp.ones(32), jnp.asarray(valid))
    tb = convert.boxes_from_numpy(_np_dict(jb))
    ij = np.asarray(jdyn.in_any_box(jnp.asarray(xy), jb, jnp.asarray(mask)))
    it = tdyn.in_any_box(T(xy), tb, T(mask)).numpy()
    np.testing.assert_array_equal(it, ij)
    assert it[:4].all()
    # a round trip keeps every field
    back = convert.boxes_to_numpy(tb)
    for k, v in _np_dict(jb).items():
        np.testing.assert_array_equal(back[k], v)


def test_match_prev_frame_tables(pairs):
    """Given the same features, the correspondence tables are identical
    (one [keypoints x previous keypoints] Hamming matrix)."""
    for i, (fp, fc, *_rest) in pairs.items():
        jx, js = jdyn.match_prev_frame(
            JCFG.matcher, JCFG.orb.scale_factor, fc, fp.xy_raw, fp.level,
            fp.angle, fp.desc, fp.valid, radius=JCFG.dynamic.match_radius)
        tfc = convert.features_from_numpy(_np_dict(fc))
        tfp = convert.features_from_numpy(_np_dict(fp))
        tx, ts = tdyn.match_prev_frame(
            TCFG.matcher, TCFG.orb.scale_factor, tfc, tfp.xy_raw, tfp.level,
            tfp.angle, tfp.desc, tfp.valid,
            radius=TCFG.dynamic.match_radius)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
        assert ts.sum() > 100, i


@pytest.mark.parametrize("i", CULL_PAIRS)
def test_reject_dynamic_matched_within_reference_spread(pairs, i):
    fp, fc, prev_map, cur_cull, *_ = pairs[i]
    prev_xy, status = jdyn.match_prev_frame(
        JCFG.matcher, JCFG.orb.scale_factor, fc, fp.xy_raw, fp.level,
        fp.angle, fp.desc, fp.valid, radius=JCFG.dynamic.match_radius)
    key = jax.random.PRNGKey(11)
    kj, cj, nj = (np.asarray(x) for x in jdyn.reject_dynamic_matched(
        JCFG.dynamic, fc.xy_raw, fc.valid, prev_xy, status, cur_cull,
        prev_map, key))
    sampler = Replay(key)
    kt, ct, nt = tdyn.reject_dynamic_matched(
        TCFG.dynamic, T(fc.xy_raw), T(fc.valid), T(prev_xy), T(status),
        convert.boxes_from_numpy(_np_dict(cur_cull)),
        convert.boxes_from_numpy(_np_dict(prev_map)), sampler)
    assert sampler.calls == 1
    assert int(ct) == int(cj)                     # correspondences: exact
    flips = int((kt.numpy() != kj).sum())
    assert flips <= MAX_KEEP_FLIPS, flips
    assert abs(int(nt) - int(nj)) <= MAX_INLIER_GAP, (int(nt), int(nj))
    # culled keypoints are a minority, as in the reference
    assert kt.sum() > 0.5 * np.asarray(fc.valid).sum()


def test_init_cull_is_box_only(pairs):
    """Before the map exists the cull keeps exactly the features outside
    the person boxes (no RANSAC, no draws), as the reference does."""
    fp, fc, prev_map, cur_cull, gp, gc = pairs[12]
    jf = jdyn.SemanticFrontend(JCFG, seed=7)
    out_j = jf.cull(gc, fc, cur_cull, map_initialized=False)
    sampler = Replay(jax.random.PRNGKey(0))
    tf = tdyn.SemanticFrontend(TCFG, seed=7, device="cpu", sampler=sampler)
    out_t = tf.cull(T(gc), convert.features_from_numpy(_np_dict(fc)),
                    convert.boxes_from_numpy(_np_dict(cur_cull)),
                    map_initialized=False)
    np.testing.assert_array_equal(out_t.valid.numpy(),
                                  np.asarray(out_j.valid))
    assert sampler.calls == 0
    assert int(out_t.valid.sum()) < int(np.asarray(fc.valid).sum())


def test_frontend_cull_and_push(pairs):
    """The frontend's full cull on a pushed previous frame: with its own
    seeded generator it is deterministic and a keep-mask over the valid
    features; with the reference frontend's first draws replayed (its key
    split once), within the reference's spread of its result."""
    fp, fc, prev_map, cur_cull, gp, gc = pairs[21]
    tfp = convert.features_from_numpy(_np_dict(fp))
    tfc = convert.features_from_numpy(_np_dict(fc))
    tcull = convert.boxes_from_numpy(_np_dict(cur_cull))
    masks = []
    for _ in range(2):
        tf = tdyn.SemanticFrontend(TCFG, seed=7, device="cpu")
        tf.push(T(gp), tfp, convert.boxes_from_numpy(_np_dict(prev_map)))
        masks.append(tf.cull(T(gc), tfc, tcull, True).valid.numpy())
    np.testing.assert_array_equal(masks[0], masks[1])
    assert not (masks[0] & ~np.asarray(fc.valid)).any()
    jf = jdyn.SemanticFrontend(JCFG, seed=7)
    jf.push(gp, fp, prev_map)
    kj = np.asarray(jf.cull(gc, fc, cur_cull, True).valid)
    sub = jax.random.split(jax.random.PRNGKey(7))[1]
    tf = tdyn.SemanticFrontend(TCFG, device="cpu", sampler=Replay(sub))
    tf.push(T(gp), tfp, convert.boxes_from_numpy(_np_dict(prev_map)))
    kt = tf.cull(T(gc), tfc, tcull, True).valid.numpy()
    assert int((kt != kj).sum()) <= MAX_KEEP_FLIPS


def test_lk_variant(pairs):
    """`reject_dynamic` (LK flow correspondences) with the draws
    replayed."""
    fp, fc, prev_map, cur_cull, gp, gc = pairs[12]
    key = jax.random.PRNGKey(5)
    kj, cj, nj = (np.asarray(x) for x in jdyn.reject_dynamic(
        JCFG.dynamic, gc, gp, fc.xy_raw, fc.valid, cur_cull, prev_map, key))
    kt, ct, nt = tdyn.reject_dynamic(
        TCFG.dynamic, T(gc), T(gp), T(fc.xy_raw), T(fc.valid),
        convert.boxes_from_numpy(_np_dict(cur_cull)),
        convert.boxes_from_numpy(_np_dict(prev_map)), Replay(key))
    print(f"LK cull: correspondences {int(cj)}/{int(ct)}, F inliers "
          f"{int(nj)}/{int(nt)}, keep flips {int((kt.numpy() != kj).sum())}")
    assert abs(int(ct) - int(cj)) <= 2
    assert int((kt.numpy() != kj).sum()) <= MAX_KEEP_FLIPS
    assert abs(int(nt) - int(nj)) <= MAX_INLIER_GAP
