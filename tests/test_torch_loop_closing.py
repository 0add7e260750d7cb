"""The port's loop closing and relocalization against the JAX package's.

One module fixture runs tests/test_loop_e2e.py's drifted circuit (86
frames at 320x240, a progressive world drift injected after frame 70)
through both packages' `System` with loop closing on (the default); the
port gets the reference's Sim3 / PnP RANSAC draws replayed. The component
tests then start both packages from the reference's final map and keyframe
database (carried across by `convert.py`), so their integer outputs must be
identical: candidate ids and covisibility rows of `_kf_update`, the match
tables of `_match_keyframes`.

The whole-run yardstick is the reference's own spread under one-ulp image
moves (`python tools/parity_spread.py loop`, CPU): ROADMAP section 3.
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
from sgslam_tpu.mapstate import maintenance as jmt
from sgslam_tpu.slam import loop_closing as jlc
from sgslam_tpu.slam import tracking as jtr
from sgslam_tpu.slam.system import System as JSystem
from sgslam_tpu_torch import config as tcfg
from sgslam_tpu_torch import convert
from sgslam_tpu_torch.geometry import se3 as tse3
from sgslam_tpu_torch.slam import loop_closing as tlc
from sgslam_tpu_torch.slam.system import System as TSystem


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
        tracker=c.TrackerConfig(max_frames_between_kf=4,
                                depth_threshold_factor=70.0),
        capacity=c.MapCapacity(max_keyframes=64, max_points=8192,
                               local_window=4, local_points=1024))


JCFG, TCFG = _cfg(jcfg), _cfg(tcfg)
N, N_PHASE1 = 86, 70
DRIFT_XI = np.array([0.44, 0.0, 0.20, 0.0, 0.12, 0.0], np.float32)
# the reference's own spread (python tools/parity_spread.py loop, CPU):
# unmoved it closes (22, 1) and ends at keyframe ATE 0.0333 m; with its
# images moved by one ulp, two of three seeds close (22, 2) and end at
# 0.0686 and 0.0442 m, the third closes no loop (0.1632 m). The port closes
# (22, 1) and ends at 0.0528 m. Tolerance: the closing seeds' largest gap.
TOL_KF_ATE = 0.036


def replay_draws(seed, n_valid, iters, k):
    """The reference's RANSAC draws: randint(PRNGKey(seed), (iters, k), 0,
    max(n_valid, k))."""
    r = jax.random.randint(jax.random.PRNGKey(int(seed)), (iters, k), 0,
                           max(int(n_valid), k))
    return torch.from_numpy(np.asarray(r).astype(np.int64))


def _drift(K, n_kf):
    frac = np.clip(np.arange(K, dtype=np.float32) / max(n_kf - 1, 1), 0, 1)
    return frac[:, None] * DRIFT_XI[None, :]


def _inject_jax(tr):
    m = tr.map
    D = jax.vmap(jse3.se3_exp)(jnp.asarray(_drift(m.max_kf,
                                                  int(m.next_kf))))
    new = jax.vmap(lambda T, d: jse3.se3_compose(T, jse3.se3_inverse(d)))(
        m.kf_pose, D)
    tr.map = jlc._apply_correction(m, m.kf_pose, new)
    d = jse3.se3_inverse(D[int(m.next_kf) - 1])
    tr.Tcw = jse3.se3_compose(jnp.asarray(tr.Tcw), d)
    tr.last_Tcw = jse3.se3_compose(jnp.asarray(tr.last_Tcw), d)


def _inject_port(tr):
    m = tr.map
    D = tse3.se3_exp(torch.from_numpy(_drift(m.max_kf, int(m.next_kf))))
    new = tse3.se3_compose(m.kf_pose, tse3.se3_inverse(D))
    tr.map = tlc._apply_correction(m, m.kf_pose, new)
    d = tse3.se3_inverse(D[int(m.next_kf) - 1])
    tr.Tcw = tse3.se3_compose(tr.Tcw, d)
    tr.last_Tcw = tse3.se3_compose(tr.last_Tcw, d)


def _kf_ate(kf_pose, kf_valid, kf_frame_id, gt_wc):
    v = np.asarray(kf_valid)
    est = np.stack([np.asarray(jse3.se3_inverse(jnp.asarray(p)))
                    for p in np.asarray(kf_pose)[v]])
    return jate.ate_rmse(est, gt_wc[np.asarray(kf_frame_id)[v]])[0]


def _map_ate(m, gt):
    return _kf_ate(_np(m.kf_pose), _np(m.kf_valid), _np(m.kf_frame_id), gt)


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def circuit_frames():
    poses = jsyn.make_circuit_trajectory(N, loops=1.075)
    seq = jsyn.SyntheticSequence(JCFG.camera, n_frames=N,
                                 planes=jsyn.ROOM_CLOSED, poses=poses)
    return ([tuple(np.array(x) for x in seq.frame(i)) for i in range(N)],
            np.asarray(poses))


def run_drifted(s, frames, gt):
    """test_loop_e2e.py's run through either package's `System`: 70 frames,
    the drift injection, the revisit. Returns the System, the loops closed
    before the drift, and the keyframe ATE after the injection and at the
    end."""
    port = isinstance(s, TSystem)
    inject, to = ((_inject_port, torch.from_numpy) if port
                  else (_inject_jax, jnp.asarray))
    for i in range(N_PHASE1):
        s.track_rgbd(to(frames[i][0]), to(frames[i][1]))
    clean = list(s.loop.loops_closed)
    inject(s.tracker)
    drifted = _map_ate(s.tracker.map, gt)
    for i in range(N_PHASE1, N):
        s.track_rgbd(to(frames[i][0]), to(frames[i][1]))
    return dict(s=s, clean=clean, drifted=drifted,
                final=_map_ate(s.tracker.map, gt))


def _spy_corrections(loop):
    """Record the inputs and outputs of the reference's `_correct`."""
    calls, orig = [], loop._correct

    def spy(m, kf_cur, kf_loop, S, cov):
        edges = list(loop.loop_edges)
        out = orig(m, kf_cur, kf_loop, S, cov)
        calls.append(dict(map=dataclasses.asdict(m), cur=kf_cur, loop=kf_loop,
                          S=np.asarray(S), cov=np.asarray(cov), edges=edges,
                          out=out[0], sim=np.asarray(out[1])))
        return out

    loop._correct = spy
    return calls


def _shadow_detection(lj):
    """Run the port's loop detection beside the reference's, on the
    reference's own maps: at each keyframe the port's closer gets the map
    the reference's closer got (its correction stubbed out: the reference
    goes on with its own). Both sides record, per inspected keyframe,
    (keyframe, candidate ids, scores, covisibility rows, streaks after,
    loop accepted)."""
    lt = tlc.LoopCloser(TCFG, device="cpu", draws=replay_draws)
    ref, port = [], []
    j_on_kf, j_inspect, t_inspect = lj.on_keyframe, lj._inspect, lt._inspect

    def on_kf(m, kf_id):
        pm = convert.map_from_numpy({f.name: np.asarray(getattr(m, f.name))
                                     for f in dataclasses.fields(m)})
        out = j_on_kf(m, kf_id)
        lt.on_keyframe(pm, int(kf_id))
        return out

    def inspect_j(m, kf_id, ci, cs, cov):
        out = j_inspect(m, kf_id, ci, cs, cov)
        ref.append((int(kf_id), np.asarray(ci), np.asarray(cs),
                    np.asarray(cov), dict(lj._consistency), out is not None))
        return out

    def inspect_t(m, kf_id, fetch):
        ci, cs, cov = [x.clone().numpy() for x in fetch[0]]
        out = t_inspect(m, kf_id, fetch)
        port.append((int(kf_id), ci, cs, cov, dict(lt._consistency),
                     out is not None))
        return out

    def no_correction(m, kf_cur, kf_loop, S, cov):
        return m, torch.cat([m.kf_pose, torch.ones_like(m.kf_pose[:, :1])], 1)

    lj.on_keyframe, lj._inspect = on_kf, inspect_j
    lt._inspect, lt._correct = inspect_t, no_correction
    return ref, port


@pytest.fixture(scope="module")
def e2e():
    frames, gt = circuit_frames()
    sj = JSystem(JCFG, enable_semantic=False, enable_mapping=False)
    calls = _spy_corrections(sj.loop)
    shadow = _shadow_detection(sj.loop)
    out = {"jax": run_drifted(sj, frames, gt), "calls": calls,
           "shadow": shadow,
           "port": run_drifted(TSystem(TCFG, enable_semantic=False,
                                       enable_mapping=False, device="cpu",
                                       draws=replay_draws), frames, gt)}
    print({k: {kk: out[k][kk] for kk in ("clean", "drifted", "final")}
           | {"loops": out[k]["s"].loop.loops_closed}
           for k in ("jax", "port")})
    return out, frames


def test_system_closes_the_same_loop(e2e):
    """Both close the loop on the same keyframe pair, none before the
    drift, and both end OK."""
    out, _ = e2e
    j, t = out["jax"], out["port"]
    assert j["clean"] == t["clean"] == []
    assert len(j["s"].loop.loops_closed) >= 1
    assert t["s"].loop.loops_closed[0] == j["s"].loop.loops_closed[0]
    assert t["s"].state == j["s"].state == "OK"
    assert t["s"].metrics.counters["loops_closed"] >= 1


def test_system_cuts_keyframe_ate_as_the_reference(e2e):
    """test_loop_e2e.py's gate (ATE at least halved) on both, and the port's
    final keyframe ATE within the reference's own spread of its."""
    out, _ = e2e
    for name in ("jax", "port"):
        r = out[name]
        assert r["drifted"] > 0.04 and r["final"] < r["drifted"] / 2.0, r
    assert abs(out["port"]["final"] - out["jax"]["final"]) < TOL_KF_ATE
    m = out["port"]["s"].tracker.map
    assert bool(torch.isfinite(m.kf_pose).all())
    assert bool(torch.isfinite(m.pt_pos).all())


def test_detection_shadows_the_reference(e2e):
    """Over the whole run, the port's detection on the reference's maps:
    at every inspected keyframe the same candidate ids and covisibility
    rows, scores within 1e-6, the same streaks, and the loop accepted at the
    same keyframe."""
    out, _ = e2e
    ref, port = out["shadow"]
    assert len(ref) >= 10 and [r[0] for r in port] == [r[0] for r in ref]
    for r, t in zip(ref, port):
        np.testing.assert_array_equal(t[1], r[1], err_msg=f"keyframe {r[0]}")
        np.testing.assert_array_equal(t[3], r[3], err_msg=f"keyframe {r[0]}")
        np.testing.assert_allclose(t[2], r[2], atol=1e-6)
        assert (t[4], t[5]) == (r[4], r[5]), (r[0], t[4:], r[4:])
    assert any(r[5] for r in ref), "the reference closed no loop"


# the reference's correction on its own inputs with the map's points moved
# by one ulp (9 seeds; parity_spread loop): keyframe poses move by 3.1,
# 4.8, 5.4, 5.7, 5.9, 6.9, 9.8, 14.3 and 108 mm after the pinned global BA
# (its bf16 point-block sums), by nothing before it. The port: 9.1 mm
# after, 8.3e-7 before. Tolerance after the global BA: the 8th seed's.
TOL_CORRECTED_POSE = 0.015


def test_correct_matches_on_the_same_inputs(e2e):
    """The reference's loop correction replayed by the port on the
    reference's own inputs: essential graph + fusion within 1e-5 and the
    map's integers identical; after the pinned global BA the keyframe poses
    within the reference's own spread (TOL_CORRECTED_POSE)."""
    out, _ = e2e
    assert out["calls"], "the reference closed no loop"
    c = out["calls"][0]
    arrays = {k: np.array(v) for k, v in c["map"].items()}
    no_gba = dataclasses.replace(
        JCFG, loop=dataclasses.replace(JCFG.loop, run_global_ba=False))
    lj = jlc.LoopCloser(no_gba)
    lj.loop_edges = c["edges"]
    want_g, sim_g = lj._correct(
        jtr.ms.MapState(**{k: jnp.asarray(v) for k, v in arrays.items()}),
        c["cur"], c["loop"], jnp.asarray(c["S"]), jnp.asarray(c["cov"]))
    for cfg, want, tol in (
            (dataclasses.replace(TCFG, loop=dataclasses.replace(
                TCFG.loop, run_global_ba=False)), want_g, 1e-5),
            (TCFG, c["out"], TOL_CORRECTED_POSE)):
        lt = tlc.LoopCloser(cfg, device="cpu")
        lt.loop_edges = c["edges"]
        got, sim = lt._correct(convert.map_from_numpy(arrays), c["cur"],
                               c["loop"], torch.from_numpy(c["S"]),
                               torch.from_numpy(c["cov"]))
        np.testing.assert_allclose(got.kf_pose.numpy(),
                                   np.asarray(want.kf_pose), atol=tol)
        for name in ("kf_valid", "pt_valid", "kf_obs_point", "next_pt"):
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(want, name)))
    np.testing.assert_allclose(sim.numpy(), c["sim"], atol=1e-5)
    assert lt.last_gba_iters == JCFG.loop.global_ba_iters


@pytest.fixture(scope="module")
def shared(e2e):
    """Both packages' loop-closing state, started from the reference's
    final map and database."""
    out, frames = e2e
    sj = out["jax"]["s"]
    arrays = {k: np.asarray(v)
              for k, v in dataclasses.asdict(sj.tracker.map).items()}
    mt = convert.map_from_numpy(arrays)
    lt = tlc.LoopCloser(TCFG, device="cpu", draws=replay_draws)
    convert.loop_state_from_numpy(lt, convert.loop_state_to_numpy(sj.loop))
    return sj, mt, lt, frames


def test_kf_update_identical(shared):
    """Candidate ids, scores and covisibility rows of the database update
    at three keyframes, the revisit's among them."""
    sj, mt, lt, _ = shared
    m = sj.tracker.map
    cur = sj.loop.loops_closed[0][0]
    for kf in (cur, cur - 3, int(m.next_kf) - 1):
        if not bool(m.kf_valid[kf]):
            continue
        bj, dj = jnp.array(sj.loop.bow_db), jnp.array(sj.loop.db_valid)
        _, _, ij, sj_, cj = jlc._kf_update(sj.loop.vocab, m, bj, dj,
                                           jnp.asarray(kf, jnp.int32))
        bt, dt = lt.bow_db.clone(), lt.db_valid.clone()
        it, st_, ct = tlc._kf_update(lt.vocab, mt, bt, dt, kf)
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
        np.testing.assert_allclose(st_.numpy(), np.asarray(sj_), atol=1e-6)
        np.testing.assert_allclose(bt.numpy(), np.asarray(sj.loop.bow_db),
                                   atol=1e-6)


def test_match_keyframes_identical_and_widen_close(shared):
    """The loop pair's mutual match table is identical (K1 on both sides
    of the same descriptors); the SearchBySim3 widening from the same Sim3
    counts within 2."""
    sj, mt, lt, _ = shared
    m = sj.tracker.map
    cur, hit = sj.loop.loops_closed[0]
    pa_j, pb_j, uva_j, uvb_j, ok_j = jlc._match_keyframes(
        JCFG, m, jnp.asarray(cur), jnp.asarray(hit))
    pa_t, pb_t, uva_t, uvb_t, ok_t = tlc._match_keyframes(TCFG, mt, cur, hit)
    ok = np.asarray(ok_j)
    np.testing.assert_array_equal(ok_t.numpy(), ok)
    assert ok.sum() >= JCFG.loop.min_bow_matches
    np.testing.assert_array_equal(uvb_t.numpy()[ok], np.asarray(uvb_j)[ok])
    np.testing.assert_allclose(pb_t.numpy()[ok], np.asarray(pb_j)[ok],
                               atol=1e-6)
    S_ab = jnp.asarray(sj.loop.loop_edges[0][2])
    Sj, nj = jlc._widen_sim3(JCFG, m, jnp.asarray(cur), jnp.asarray(hit),
                             S_ab)
    St, nt = tlc._widen_sim3(TCFG, mt, cur, hit, torch.from_numpy(
        np.asarray(S_ab)))
    assert abs(int(nt) - int(nj)) <= 2, (int(nt), int(nj))
    assert int(nj) >= JCFG.loop.min_total_matches


def test_relocalize_after_kidnap(shared):
    """Features of an early viewpoint (frame 6) against the final map: both
    relocalize, with poses within 5 mm and inliers within max(3, 2%)."""
    sj, mt, lt, frames = shared
    g, d = frames[6]
    fj = jtr.extract_frame(JCFG, jnp.asarray(g), jnp.asarray(d))
    ft = convert.features_from_numpy(
        {k: np.asarray(v) for k, v in dataclasses.asdict(fj).items()})
    Tj, nj = sj.loop.relocalize(sj.tracker.map, fj)
    Tt, nt = lt.relocalize(mt, ft)
    assert Tj is not None and Tt is not None
    assert abs(nt - nj) <= max(3, 0.02 * nj), (nt, nj)
    np.testing.assert_allclose(Tt[4:].numpy(), np.asarray(Tj)[4:], atol=5e-3)
    # an empty database gives no pose (test_relocalization.py)
    empty = tlc.LoopCloser(TCFG, device="cpu")
    T0, _ = empty.relocalize(mt, ft)
    assert T0 is None


def test_remap_keyframes_after_compaction(shared):
    """Both closers follow the same compaction: BoW rows, validity, the GBA
    pin, loop edges and closures land on the same slots."""
    sj, mt, lt, _ = shared
    m = sj.tracker.map
    kf_valid = np.asarray(m.kf_valid).copy()
    kf_valid[[3, 7]] = False            # two culled keyframes
    m2 = dataclasses.replace(m, kf_valid=jnp.asarray(kf_valid))
    _, kf_map, _ = jmt.compact_map(m2)
    kf_map = np.asarray(kf_map)
    lj = jlc.LoopCloser(JCFG)
    lj.bow_db, lj.db_valid = jnp.array(sj.loop.bow_db), jnp.array(
        sj.loop.db_valid)
    lj.loop_edges = list(sj.loop.loop_edges)
    lj.loops_closed = list(sj.loop.loops_closed)
    lj._consistency = {5: 1, 9: 2}
    fixed = np.zeros(64, bool)
    fixed[[2, 9]] = True
    lj._gba_fixed = jnp.asarray(fixed)
    convert.loop_state_from_numpy(lt, convert.loop_state_to_numpy(lj))
    lt._gba_fixed = torch.from_numpy(fixed)
    lj.remap_keyframes(kf_map, kf_valid)
    lt.remap_keyframes(kf_map, kf_valid)
    np.testing.assert_array_equal(lt.bow_db.numpy(), np.asarray(lj.bow_db))
    np.testing.assert_array_equal(lt.db_valid.numpy(),
                                  np.asarray(lj.db_valid))
    np.testing.assert_array_equal(lt._gba_fixed.numpy(),
                                  np.asarray(lj._gba_fixed))
    assert lt._consistency == lj._consistency
    assert lt.loops_closed == lj.loops_closed
    assert [e[:2] for e in lt.loop_edges] == [e[:2] for e in lj.loop_edges]
