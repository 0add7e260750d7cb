"""The port's dynamic-scene renderer (people, props, the walk and circuit
trajectories) against the JAX package's.

Depth is ray-plane geometry in f32. Gray inherits the static texture's
`_cell_hash` gap (one ulp of `sin` times 43758, ~2e-3); the person and
prop textures threshold `sin` of arguments up to ~100, so a pixel whose
argument lies within rounding of a zero crossing may flip (measured: no
such pixel in these frames).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgslam_tpu import config as jcfg
from sgslam_tpu.geometry import se3 as jse3
from sgslam_tpu.io import synthetic as jsyn
from sgslam_tpu_torch.io import synthetic as tsyn


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL_DEPTH = 1e-4        # m (measured at most 7.2e-7)
TOL_GRAY = 2.5e-3       # one ulp of sin times 43758 (measured at most 2.0e-3)
MAX_FLIP_SHARE = 1e-4   # pixels beyond TOL_GRAY (measured 0)
TOL_POSE = 1e-6         # trajectory entries, f32 (measured 4.8e-7)
TOL_BOX = 1e-3          # px (ground-truth boxes; projections of f32 poses)

CAM = jcfg.synthetic_config(320, 240).camera
N = 30


def _frames_close(jax_frame, port_frame):
    gj, dj = (np.asarray(x) for x in jax_frame)
    gt, dt = (x.numpy() for x in port_frame)
    assert gt.shape == gj.shape and gt.dtype == dt.dtype == np.float32
    np.testing.assert_allclose(dt, dj, atol=TOL_DEPTH, rtol=0)
    diff = np.abs(gt - gj)
    assert (diff > TOL_GRAY).mean() <= MAX_FLIP_SHARE, (
        (diff > TOL_GRAY).sum(), diff.max())
    return gj, dj


def test_trajectories():
    pairs = [
        (jsyn.make_walk_trajectory(N, yaw_amp=0.35),
         tsyn.make_walk_trajectory(N, yaw_amp=0.35)),
        (jsyn.make_circuit_trajectory(N, loops=1.2),
         tsyn.make_circuit_trajectory(N, loops=1.2)),
        (jsyn.walker_tracks(N, 3, depth0=1.6, half_h=0.62),
         tsyn.walker_tracks(N, 3, depth0=1.6, half_h=0.62)),
        (jsyn.object_track(N), tsyn.object_track(N)),
    ]
    for j, t in pairs:
        assert t.shape == j.shape and t.dtype == torch.float32
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=TOL_POSE,
                                   rtol=0)


@pytest.mark.parametrize("width,height", [(320, 240), (640, 480)])
def test_single_person_frame(width, height):
    cam = jcfg.synthetic_config(width, height).camera
    poses = np.array(jsyn.make_trajectory(N))
    obj = np.array(jsyn.object_track(N))
    for i in (3, 17):
        _, dj = _frames_close(
            jsyn.render_frame(cam, jnp.asarray(poses[i]), jnp.asarray(obj[i]),
                              obj_half=0.55),
            tsyn.render_frame(cam, torch.from_numpy(poses[i]),
                              torch.from_numpy(obj[i]), obj_half=0.55))
        static = np.asarray(jsyn.render_frame(cam, jnp.asarray(poses[i]))[1])
        assert (np.abs(dj - static) > 1e-4).mean() > 0.02   # person in view


def test_people_and_props_scene():
    poses = np.array(jsyn.make_walk_trajectory(N, yaw_amp=0.35))
    people = np.array(jsyn.walker_tracks(N, 3, depth0=1.6, half_h=0.62))
    props = jsyn.DEFAULT_PROPS
    for i in (0, 11, 24):
        _frames_close(
            jsyn.render_frame_scene(CAM, jnp.asarray(poses[i]),
                                    jnp.asarray(people[i]),
                                    jnp.asarray(props)),
            tsyn.render_frame_scene(CAM, torch.from_numpy(poses[i]),
                                    torch.from_numpy(people[i]),
                                    torch.from_numpy(props)))
        _frames_close(
            jsyn.render_frame_people(CAM, jnp.asarray(poses[i]),
                                     jnp.asarray(people[i])),
            tsyn.render_frame_people(CAM, torch.from_numpy(poses[i]),
                                     torch.from_numpy(people[i])))
        cj = jsyn.person_coverage(CAM, jnp.asarray(poses[i]),
                                  jnp.asarray(people[i]))
        ct = tsyn.person_coverage(CAM, torch.from_numpy(poses[i]),
                                  torch.from_numpy(people[i]))
        assert abs(ct - cj) <= 1.0 / (CAM.width * CAM.height) + 1e-9


def test_prop_textures_every_class():
    """Each of the ten prop classes, on a grid of in-prop coordinates."""
    px, py = np.meshgrid(np.linspace(-1, 1, 97, dtype=np.float32),
                         np.linspace(-1, 1, 89, dtype=np.float32))
    for c in jsyn.PROP_CLASSES + (3,):          # 3: not a prop, the default
        j = np.asarray(jsyn.prop_texture(jnp.asarray(px), jnp.asarray(py),
                                         jnp.int32(c), jnp.float32(5.0)))
        t = tsyn.prop_texture(torch.from_numpy(px), torch.from_numpy(py),
                              torch.tensor(c, dtype=torch.int32),
                              torch.tensor(5.0)).numpy()
        assert (np.abs(t - j) > 1e-5).mean() <= 1e-3, c


def test_gt_boxes():
    poses = np.array(jsyn.make_walk_trajectory(N, yaw_amp=0.35))
    people = np.array(jsyn.walker_tracks(N, 3, depth0=1.6, half_h=0.62))
    for i in (2, 15):
        T_cw = np.array(jse3.se3_inverse(jnp.asarray(poses[i])))
        for p in range(3):
            bj, vj = jsyn.person_gt_box(CAM, jnp.asarray(T_cw),
                                        jnp.asarray(people[i, p]))
            bt, vt = tsyn.person_gt_box(CAM, torch.from_numpy(T_cw),
                                        torch.from_numpy(people[i, p]))
            assert bool(vt) == bool(vj)
            np.testing.assert_allclose(bt.numpy(), np.asarray(bj),
                                       atol=TOL_BOX, rtol=0)
        for q in range(3):
            bj, vj = jsyn.prop_gt_box(CAM, jnp.asarray(T_cw),
                                      jnp.asarray(jsyn.DEFAULT_PROPS[q]))
            bt, vt = tsyn.prop_gt_box(CAM, torch.from_numpy(T_cw),
                                      torch.from_numpy(jsyn.DEFAULT_PROPS[q]))
            assert bool(vt) == bool(vj)
            np.testing.assert_allclose(bt.numpy(), np.asarray(bj),
                                       atol=TOL_BOX, rtol=0)


def test_sequences():
    """SyntheticSequence's dynamic, props and people arguments."""
    cases = [dict(dynamic=True), dict(dynamic=True, props=True),
             dict(props=True),
             dict(poses=jsyn.make_walk_trajectory(N, yaw_amp=0.35),
                  people=jsyn.walker_tracks(N, 3, depth0=1.6, half_h=0.62))]
    for kw in cases:
        jseq = jsyn.SyntheticSequence(CAM, n_frames=N, **kw)
        tkw = {k: (np.asarray(v) if k in ("poses", "people") else v)
               for k, v in kw.items()}
        tseq = tsyn.SyntheticSequence(CAM, n_frames=N, device="cpu", **tkw)
        np.testing.assert_allclose(tseq.poses.numpy(), np.asarray(jseq.poses),
                                   atol=TOL_POSE, rtol=0)
        for i in (4, 19):
            _frames_close(jseq.frame(i), tseq.frame(i))
        if kw.get("props"):
            bj, vj = jseq.gt_prop_box(7, 1)
            bt, vt = tseq.gt_prop_box(7, 1)
            assert bool(vt) == bool(vj)
            np.testing.assert_allclose(bt.numpy(), np.asarray(bj),
                                       atol=TOL_BOX, rtol=0)


def test_closed_room_circuit():
    poses = np.array(jsyn.make_circuit_trajectory(N, loops=1.0))
    for i in (0, 9, 22):
        _frames_close(
            jsyn.render_frame(CAM, jnp.asarray(poses[i]),
                              planes=jsyn.ROOM_CLOSED),
            tsyn.render_frame(CAM, torch.from_numpy(poses[i]),
                              planes=tsyn.ROOM_CLOSED))
