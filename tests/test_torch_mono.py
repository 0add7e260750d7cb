"""The port's monocular mode (`slam/mono.py`) against the JAX package's:
the reference's median, the initialization matcher, the initial map, and
`MonoTracker` over tests/test_mono_stereo.py's 30-frame run at 320x240.

A monocular run is chaotic: the initial map's scale is a median of
triangulated depths, and every later point comes from triangulation with
nearly parallel rays. The yardstick is the reference's own spread with its
images moved by one ulp, `python tools/parity_spread.py mono` (CPU, seeds
0-5): it initializes at frame 3 in every run and ends with 15 keyframes
and a Sim(3)-aligned ATE of 0.0585-0.0770 m against 0.0557 m unmoved (up
to 0.0213 m from it), 551-630 valid points against 640. The port, on its
own features with the reference's initialization draws replayed: frame 3,
15 keyframes, 0.0555 m, 630 points; on the reference's features: 0.0570 m.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgslam_tpu import config as jcfg
from sgslam_tpu.eval import ate as jate
from sgslam_tpu.geometry import se3 as jse3
from sgslam_tpu.io import synthetic as jsyn
from sgslam_tpu.slam import mono as jmono
from sgslam_tpu.slam import tracking as jtr
from sgslam_tpu_torch import config as tcfg
from sgslam_tpu_torch import convert
from sgslam_tpu_torch.slam import mono as tmono


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(c):
    # tests/test_mono_stereo.py::test_mono_pipeline_e2e's configuration
    return c.synthetic_config(
        width=320, height=240,
        orb=c.OrbConfig(n_features=600, max_keypoints=640),
        tracker=c.TrackerConfig(max_frames_between_kf=2,
                                depth_threshold_factor=70.0),
        capacity=c.MapCapacity(max_keyframes=64, max_points=8192,
                               local_window=4, local_points=1024))


JCFG, TCFG = _cfg(jcfg), _cfg(tcfg)
N = 30
# the reference's own spread (module docstring): the initialization frame
# never moves; how far a moved run's ATE ends from the unmoved one's,
# rounded up; tests/test_mono_stereo.py's map-growth gate
INIT_FRAME = 3
ATE_SPREAD = 0.022
MIN_POINTS = 150


class ReplayInit:
    """The reference MonoTracker's initialization draws: PRNGKey(17)
    split once per attempt, then `initialize_mono`'s split and randint."""

    def __init__(self):
        self.key = jax.random.PRNGKey(17)

    def __call__(self, n_valid):
        self.key, sub = jax.random.split(self.key)
        kf, kh = jax.random.split(sub)
        n = int(n_valid)
        return tuple(torch.from_numpy(np.asarray(
            jax.random.randint(k, (200, m), 0, n)).astype(np.int64))
            for k, m in ((kf, 8), (kh, 4)))


def _np_fields(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def frames():
    seq = jsyn.SyntheticSequence(JCFG.camera, n_frames=N)
    return ([np.asarray(seq.frame(i)[0]) for i in range(N)],
            np.asarray(seq.poses))


def run(tracker, grays, feats=None):
    """Drive a MonoTracker (either package); returns (init frame, poses)."""
    init = None
    for i, g in enumerate(grays):
        if feats is None:
            tracker.process_mono(g)
        else:
            tracker.process_mono(g, feats=feats[i])
        if init is None and tracker.state == "OK":
            init = i
    return init, tracker.poses_cw()


def sim3_ate(poses_cw, gt_wc, init):
    wc = np.stack([np.asarray(jse3.se3_inverse(jnp.asarray(p)))
                   for p in poses_cw[init:]])
    return jate.ate_rmse(wc, gt_wc[init:], with_scale=True)[0]


def port_tracker():
    return tmono.MonoTracker(TCFG, draws=ReplayInit(), device="cpu")


@pytest.fixture(scope="module")
def reference():
    grays, gt = frames()
    tr = jmono.MonoTracker(JCFG)
    init, poses = run(tr, grays)
    return grays, gt, tr, init, poses


@pytest.mark.parametrize("x", [
    [1.0, np.nan, 3.0, 2.0, 10.0],      # even count: mean of the middle two
    [4.0, 1.0, np.nan, 2.0],            # odd count
    [np.nan, np.nan],                   # none: NaN
    [5.0], [2.0, 2.0, 7.0, 1.0]])
def test_nanmedian_is_the_references(x):
    a = np.asarray(x, np.float32)
    want = float(jnp.nanmedian(jnp.asarray(a)))
    got = float(tmono.nanmedian(torch.from_numpy(a)))
    assert (np.isnan(want) and np.isnan(got)) or got == want
    if x[0] == 1.0:     # torch's own nanmedian takes the lower middle
        assert float(torch.nanmedian(torch.from_numpy(a))) != want


def test_init_match_and_bootstrap_map(reference):
    """On the reference's features of frames 0 and 3 and its accepted
    initialization: identical match tables, and an initial map with
    identical integer fields and f32-close geometry."""
    grays = reference[0]
    jf = [jtr.extract_frame_mono(JCFG, jnp.asarray(grays[i]))
          for i in (0, INIT_FRAME)]
    tf = [convert.features_from_numpy(_np_fields(f)) for f in jf]
    jidx, jok = jmono._match_for_init(JCFG, jf[0], jf[1])
    tidx, tok = tmono._match_for_init(TCFG, tf[0], tf[1])
    ok = np.asarray(jok)
    np.testing.assert_array_equal(tok.numpy(), ok)
    np.testing.assert_array_equal(tidx.numpy()[ok], np.asarray(jidx)[ok])

    key = jax.random.split(jax.random.PRNGKey(17))[1]
    from sgslam_tpu.optim.initializer import initialize_mono

    init = initialize_mono(JCFG.camera, jf[0].xy[jidx], jf[1].xy, jok, key)
    assert bool(init["ok"])
    good = init["good"] & jok
    jm, jT = jmono.bootstrap_mono_map(JCFG, jf[0], jf[1], 0, INIT_FRAME,
                                      init["T21"], init["points"], good,
                                      jidx)
    t = {k: torch.from_numpy(np.array(init[k])) for k in ("T21", "points")}
    tm, tT = tmono.bootstrap_mono_map(TCFG, tf[0], tf[1], 0, INIT_FRAME,
                                      t["T21"], t["points"],
                                      torch.from_numpy(np.array(good)),
                                      tidx)
    np.testing.assert_allclose(tT.numpy(), np.asarray(jT), rtol=0,
                               atol=1e-6)
    jn, tn = _np_fields(jm), convert.map_to_numpy(tm)
    for k in ("pt_valid", "kf_valid", "kf_obs_point", "kf_frame_id",
              "pt_first_kf", "next_kf", "next_pt", "pt_desc"):
        np.testing.assert_array_equal(tn[k], jn[k], err_msg=k)
    for k in ("pt_pos", "pt_normal", "pt_min_dist", "pt_max_dist",
              "kf_pose"):
        np.testing.assert_allclose(tn[k], jn[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_mono_tracker_matches_reference(reference):
    """The port's own features, the reference's initialization draws: the
    same initialization frame, the reference test's gates, and a
    Sim(3)-aligned ATE within the reference's own spread."""
    grays, gt, jt, jinit, jposes = reference
    assert jinit == INIT_FRAME
    tr = port_tracker()
    init, poses = run(tr, grays)
    assert init == jinit
    assert tr.state == "OK" and tr.n_kf >= 2
    assert int(tr.map.pt_valid.sum()) > MIN_POINTS
    jate_ = sim3_ate(jposes, gt, jinit)
    ate_ = sim3_ate(poses, gt, init)
    assert abs(ate_ - jate_) <= ATE_SPREAD, (ate_, jate_)
    assert abs(tr.n_kf - jt.n_kf) <= 2
