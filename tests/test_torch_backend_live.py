"""Long-run capacity pressure on the port alone: the back-end pass (point
culling, triangulation, fusion, local BA, keyframe culling) plus slot
compaction must keep a 24-keyframe map healthy over 120 frames that insert
far more keyframes than there are slots. The configuration and the gates
are those of tests/test_maintenance_live.py, which holds the JAX package
to them.
"""

import numpy as np
import pytest
import torch

from sgslam_tpu_torch import config
from sgslam_tpu_torch.eval import ate
from sgslam_tpu_torch.geometry import se3
from sgslam_tpu_torch.io import synthetic
from sgslam_tpu_torch.slam import tracking

# tiny capacities so culling + compaction must fire
CFG = config.synthetic_config(
    width=320, height=240,
    orb=config.OrbConfig(n_features=600, max_keypoints=640),
    tracker=config.TrackerConfig(max_frames_between_kf=2,
                                 depth_threshold_factor=70.0),
    capacity=config.MapCapacity(max_keyframes=24, max_points=8192,
                                local_window=4, local_points=1024),
)
N_FRAMES = 120


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def long_run():
    seq = synthetic.SyntheticSequence(CFG.camera, n_frames=N_FRAMES,
                                      device="cpu")
    tr = tracking.Tracker(CFG, device="cpu")
    remaps = []
    tr.on_compaction = lambda kf_map, old_valid: remaps.append(
        (kf_map, old_valid))
    for i in range(N_FRAMES):
        tr.process(*seq.frame(i))
    est_wc = se3.se3_inverse(torch.as_tensor(tr.poses_cw())).numpy()
    gt_wc = seq.poses.cpu().numpy()
    return tr, est_wc, gt_wc, remaps


def test_capacity_pressure_survives(long_run):
    tr, _, _, remaps = long_run
    assert tr.state == "OK"
    # far more keyframes inserted than slots -> compaction had to fire
    assert tr.n_kf > CFG.capacity.max_keyframes
    assert tr.compactions >= 1 and len(remaps) == tr.compactions
    kf_map, old_valid = remaps[-1]
    assert (kf_map[old_valid] == np.arange(old_valid.sum())).all()
    m = tr.map
    # live map stays within capacity with free headroom
    assert int(m.next_kf) < m.max_kf
    assert 2 <= int(m.kf_valid.sum()) <= m.max_kf
    assert int(m.pt_valid.sum()) <= int(m.next_pt)
    assert all(r < int(m.next_kf) for r in tr.traj_ref_kf)


def test_capacity_pressure_ate_stable(long_run):
    _, est_wc, gt_wc, _ = long_run
    rmse = ate.ate_rmse(est_wc, gt_wc)[0]
    print(f"port capacity-pressure run: ATE {rmse:.4f} m")
    assert rmse < 0.08, f"long-run ATE {rmse:.4f} m"
    # second half no worse than 3x the first half
    h = N_FRAMES // 2
    r1 = ate.ate_rmse(est_wc[:h], gt_wc[:h])[0]
    r2 = ate.ate_rmse(est_wc[h:], gt_wc[h:])[0]
    assert r2 < 3.0 * max(r1, 0.01), (r1, r2)


def test_maintenance_culls_and_triangulates(long_run):
    tr, _, _, _ = long_run
    m = tr.map
    # without point culling and fusion the live set would explode
    assert int(m.pt_valid.sum()) < 6 * CFG.orb.n_features
    # keyframe culling fired at least once over the run
    assert int(m.kf_valid.sum()) < min(tr.n_kf, m.max_kf)
