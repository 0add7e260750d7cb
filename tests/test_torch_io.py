"""The port's own I/O and evaluation copies against the JAX package's:
map checkpoints cross between the packages in both directions, TUM and
KITTI trajectory text is identical, and `rpe` / `associate_by_time` give
the same numbers."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgslam_tpu.eval import ate as jate
from sgslam_tpu.geometry import se3 as jse3
from sgslam_tpu.io import checkpoint as jck
from sgslam_tpu.io import trajectory as jtraj
from sgslam_tpu_torch import convert
from sgslam_tpu_torch.eval import ate as tate
from sgslam_tpu_torch.io import checkpoint as tck
from sgslam_tpu_torch.io import trajectory as ttraj

EVAL_MAP = "sgslam_tpu/assets/eval_map.npz"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_np(m):
    return {f.name: np.asarray(getattr(m, f.name))
            for f in dataclasses.fields(m)}


def _assert_same(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.fixture(scope="module")
def eval_map():
    return jck.load_map(EVAL_MAP)[0]


def test_checkpoint_jax_to_port(eval_map, tmp_path):
    path = str(tmp_path / "from_jax.npz")
    extra = {"frame_ids": np.arange(5, dtype=np.int32), "note": np.array(3.5)}
    jck.save_map(path, eval_map, extra=extra)
    mt, ex = tck.load_map(path, device="cpu")
    assert mt.kf_feat_desc.dtype == torch.int32
    _assert_same(convert.map_to_numpy(mt), _jax_np(eval_map))
    _assert_same(ex, extra)


def test_checkpoint_port_to_jax(eval_map, tmp_path):
    mt = convert.map_from_numpy(_jax_np(eval_map))
    path = str(tmp_path / "from_port.npz")
    tck.save_map(path, mt, extra={"k": np.arange(3)})
    mj, ex = jck.load_map(path)
    assert mj.kf_feat_desc.dtype == jnp.uint32
    _assert_same(_jax_np(mj), _jax_np(eval_map))
    np.testing.assert_array_equal(ex["k"], np.arange(3))
    # and back into the port
    mt2, _ = tck.load_map(path, device="cpu")
    _assert_same(convert.map_to_numpy(mt2), convert.map_to_numpy(mt))


def _trajectory(n, seed):
    rng = np.random.default_rng(seed)
    xi = np.cumsum(rng.normal(scale=0.05, size=(n, 6)), axis=0)
    return np.array(jax.vmap(jse3.se3_exp)(jnp.asarray(xi.astype(np.float32))))


def test_trajectory_text_identical(tmp_path):
    poses_cw = _trajectory(200, 0)
    ts = 1305031102.175304 + 0.0333 * np.arange(200)
    for fmt in ("tum", "kitti"):
        pj, pt = tmp_path / f"jax.{fmt}", tmp_path / f"port.{fmt}"
        if fmt == "tum":
            jtraj.save_tum(str(pj), ts, poses_cw)
            ttraj.save_tum(str(pt), ts, poses_cw)
        else:
            jtraj.save_kitti(str(pj), poses_cw)
            ttraj.save_kitti(str(pt), poses_cw)
        text = pt.read_text()
        assert text == pj.read_text(), fmt
        assert len(text.splitlines()) == 200
    tj, wj = jtraj.load_tum(str(tmp_path / "jax.tum"))
    tt, wt = ttraj.load_tum(str(tmp_path / "jax.tum"))
    np.testing.assert_array_equal(tt, tj)
    np.testing.assert_array_equal(wt, wj)


def test_rpe_and_association():
    est = _trajectory(60, 1)
    gt = _trajectory(60, 2)
    for delta in (1, 5):
        rj = jate.rpe(est, gt, delta=delta)
        rt = tate.rpe(est, gt, delta=delta)
        # the same f32 operations in the same order: equal
        assert rt == rj
    rng = np.random.default_rng(3)
    ts_a = np.sort(rng.uniform(0, 10, 300))
    ts_b = np.sort(np.concatenate([ts_a[::2] + rng.normal(scale=0.01,
                                                          size=150),
                                   rng.uniform(0, 10, 80)]))
    ia_j, ib_j = jate.associate_by_time(ts_a, ts_b)
    ia_t, ib_t = tate.associate_by_time(ts_a, ts_b)
    np.testing.assert_array_equal(ia_t, ia_j)
    np.testing.assert_array_equal(ib_t, ib_j)
    assert 100 < len(ia_t) < 300


def test_xla_trace_writes_a_trace(tmp_path):
    """`utils.timing.xla_trace`, the counterpart of the reference's XLA
    profiler context: a torch.profiler trace of the block lands in the
    directory, with the block's operations in it."""
    import glob
    import json

    from sgslam_tpu_torch.utils import timing

    with timing.xla_trace(str(tmp_path / "trace")) as prof:
        torch.cumsum(torch.arange(100.0), 0)
    assert prof is not None
    files = glob.glob(str(tmp_path / "trace" / "*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::cumsum" in names
