"""`sgslam_tpu_torch/entry.py` against `__graft_entry__.entry` on the CPU:
one ORB extraction and one `track_step` on a one-keyframe map at the small
configuration (320x240, 600 features, 640 keypoints).

- Each package on its own inputs (its own rendered frames, extraction and
  map): the pose within tests/test_torch_tracking.py's 0.025 m / 5e-3, the
  inlier and close-point counts within its max(5, 3%), and the matched
  map points as sets within the same (measured: pose 2.2e-7 apart, counts
  equal, the same 256 points).
- The port's `fn` on the reference's own map and frames: per keypoint the
  matched point ids equal but for at most max(3, 1%) of the 640 slots
  (measured 1: the predicted-level gap of `local_map._log_f32`, ROADMAP
  section 3, and tied keypoints of the pyramid's levels 1-7), the pose
  within 1e-5 and the inliers within the tolerance above.
- `entry()` keeps the reference's small configuration, and its outputs
  sit on the device it was given.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from sgslam_tpu_torch import convert, entry

TOL_T, TOL_Q = 0.025, 5e-3            # tests/test_torch_tracking.py
INLIER_TOL_ABS, INLIER_TOL_REL = 5, 0.03
SLOT_TOL_ABS, SLOT_TOL_REL = 3, 0.01
TOL_SAME_INPUTS = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reference():
    fn, args = graft.entry()
    return args, [np.asarray(x) for x in jax.jit(fn)(*args)]


def _tol(n):
    return max(INLIER_TOL_ABS, INLIER_TOL_REL * n)


def test_small_config_is_the_reference_s():
    cfg, ref = entry.small_config(), graft._small_cfg()
    assert (cfg.camera.width, cfg.camera.height) == (320, 240)
    assert (cfg.orb.n_features, cfg.orb.max_keypoints) == (
        ref.orb.n_features, ref.orb.max_keypoints)
    assert dataclasses.asdict(cfg.capacity) == dataclasses.asdict(
        ref.capacity)


def test_entry_matches_the_reference(reference):
    _, ref = reference
    fn, args = entry.entry("cpu")
    out = fn(*args)
    assert all(x.device.type == "cpu" for x in out)
    Tcw, matched = out[0].numpy(), out[1].numpy()
    np.testing.assert_allclose(Tcw[4:], ref[0][4:], atol=TOL_T, rtol=0)
    np.testing.assert_allclose(Tcw[:4], ref[0][:4], atol=TOL_Q, rtol=0)
    for k in (2, 3, 4):
        assert abs(int(out[k]) - int(ref[k])) <= _tol(int(ref[k])), k
    got, want = set(matched[matched >= 0]), set(ref[1][ref[1] >= 0])
    assert len(got ^ want) <= _tol(len(want)), (len(got), len(want))


def test_fn_on_the_reference_inputs(reference):
    (m_ref, gray, depth, T), ref = reference
    fn, _ = entry.entry("cpu")
    m = convert.map_from_numpy({f.name: np.asarray(getattr(m_ref, f.name))
                                for f in dataclasses.fields(m_ref)})
    out = fn(m, *(torch.from_numpy(np.array(x)) for x in (gray, depth, T)))
    differ = int((out[1].numpy() != ref[1]).sum())
    assert differ <= max(SLOT_TOL_ABS, SLOT_TOL_REL * len(ref[1])), differ
    np.testing.assert_allclose(out[0].numpy(), ref[0], atol=TOL_SAME_INPUTS)
    assert abs(int(out[2]) - int(ref[2])) <= _tol(int(ref[2]))
