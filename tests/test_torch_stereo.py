"""The port's stereo matcher (`ops/stereo.py`), its stereo renderer
(`SyntheticSequence.frame_stereo`) and stereo extraction against the JAX
package's.

`stereo_match` gets both packages' inputs identical: the reference's
rendered pair and the reference's keypoints. Its SAD is a mean of 25
bilinear taps and its subpixel step a parabola through three SADs, so f32
rounding (XLA fuses the taps' multiply-adds, torch does not) can flip a
keypoint across the `best_sad < 0.08` and border gates or move a flat
minimum to another disparity. The yardstick is the reference's own spread under one-ulp moves of
its two images, `python tools/parity_spread.py stereo` (CPU, 320x240,
frames 3, 9, 18 and 21 of the walk, seeds 0-3): no `ok` flag flips; where
both runs accept, one keypoint in about 490 moves to another disparity in
5 of 12 runs (u_right by 1.5-4 px: a flat SAD minimum), the others by at
most 1.5e-5 px in u_right and 8.3e-6 m in depth. The port against the
unmoved reference on the same frames: no flips, no jump, at most 3.1e-5 px
and 1.9e-6 m.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgslam_tpu import config as jcfg
from sgslam_tpu.io import synthetic as jsyn
from sgslam_tpu.ops import orb as jorb
from sgslam_tpu.ops import stereo as jstereo
from sgslam_tpu.slam import tracking as jtr
from sgslam_tpu_torch import config as tcfg
from sgslam_tpu_torch.io import synthetic as tsyn
from sgslam_tpu_torch.ops import orb as torb
from sgslam_tpu_torch.ops import stereo as tstereo
from sgslam_tpu_torch.slam import tracking as ttr


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(c):
    return c.synthetic_config(
        width=320, height=240,
        orb=c.OrbConfig(n_features=600, max_keypoints=640))


JCFG, TCFG = _cfg(jcfg), _cfg(tcfg)
N_FRAMES, FRAME = 24, 9

# the reference's own one-ulp spread (module docstring): no flag flips,
# one keypoint at another disparity, the rest within f32 rounding
MAX_OK_FLIPS = 0
MAX_JUMPS = 1
TOL_U_RIGHT = 5e-5      # px (one f32 ulp at u ~ 300 is 3.1e-5)
TOL_DEPTH = 1e-5        # m
# renderer: tests/test_torch_synthetic.py's tolerances
TOL_GRAY, MAX_FLIP_SHARE, TOL_RENDER_DEPTH = 2.5e-3, 1e-4, 1e-4


def stereo_pair(i=FRAME):
    """The reference's rendered pair at frame i of the 24-frame room walk
    and its ORB keypoints: (gray_l, gray_r, xy [N,2], level [N], valid)."""
    seq = jsyn.SyntheticSequence(JCFG.camera, n_frames=N_FRAMES)
    gl, gr, _ = (np.asarray(x) for x in seq.frame_stereo(i))
    f = jorb.extract(jnp.asarray(gl), JCFG.orb, JCFG.camera)
    return (gl, gr, np.asarray(f.xy_raw), np.asarray(f.level),
            np.asarray(f.valid))


def jax_match(gl, gr, xy, level, valid):
    return [np.asarray(x) for x in jstereo.stereo_match(
        JCFG.camera, jnp.asarray(gl), jnp.asarray(gr), jnp.asarray(xy),
        jnp.asarray(level), jnp.asarray(valid))]


def port_match(gl, gr, xy, level, valid):
    return [x.numpy() for x in tstereo.stereo_match(
        TCFG.camera, *(torch.from_numpy(np.array(a))
                       for a in (gl, gr, xy, level, valid)))]


@pytest.fixture(scope="module")
def pair():
    return stereo_pair()


def test_stereo_match_matches_reference(pair):
    (ju, jd, jok), (tu, td, tok) = jax_match(*pair), port_match(*pair)
    assert jok.sum() > 100, jok.sum()
    assert int((jok != tok).sum()) <= MAX_OK_FLIPS
    both = jok & tok
    du, dd = np.abs(tu - ju)[both], np.abs(td - jd)[both]
    jumps = (du > TOL_U_RIGHT) | (dd > TOL_DEPTH)
    assert jumps.sum() <= MAX_JUMPS, (du.max(), dd.max())
    assert du[~jumps].max() <= TOL_U_RIGHT and dd[~jumps].max() <= TOL_DEPTH
    # the mono convention where no match is accepted
    assert (tu[~tok] == -1.0).all() and (td[~tok] == 0.0).all()


def test_stereo_match_gates():
    """Keypoints whose whole search window lies out of bounds (all SADs
    inf, argmin 0) or that are invalid are rejected, as in the reference."""
    gl, gr, xy, level, valid = stereo_pair()
    xy = xy[:8].copy()
    xy[:4, 0] = 1.0                       # no candidate x > 2 in bounds
    valid = valid[:8].copy()
    valid[4] = False
    j, t = jax_match(gl, gr, xy, level[:8], valid), port_match(
        gl, gr, xy, level[:8], valid)
    for a, b in zip(j, t):
        np.testing.assert_allclose(b, a, atol=TOL_U_RIGHT, rtol=0)
    assert not t[2][:5].any()


def test_stereo_depth_accuracy():
    """tests/test_mono_stereo.py::test_stereo_match_depth on the port: a
    30 cm baseline pair must recover metric depth (the port's renderer and
    its own keypoints)."""
    cam = dataclasses.replace(TCFG.camera, bf=80.0)
    orb = tcfg.OrbConfig(n_features=500, max_keypoints=512)
    baseline = cam.bf / cam.fx
    g_l, d_l = tsyn.render_frame(cam, torch.tensor([1.0, 0, 0, 0, 0, 0, 0]))
    g_r, _ = tsyn.render_frame(
        cam, torch.tensor([1.0, 0, 0, 0, baseline, 0, 0]))
    feats = torb.extract(g_l, orb, cam)
    u_right, depth, ok = tstereo.stereo_match(cam, g_l, g_r, feats.xy_raw,
                                              feats.level, feats.valid)
    ok = ok.numpy()
    assert ok.sum() > 150, ok.sum()
    xy = np.clip(feats.xy_raw.numpy().astype(int), 0, [319, 239])
    gt = d_l.numpy()[xy[:, 1], xy[:, 0]]
    rel = np.abs(depth.numpy()[ok] - gt[ok]) / np.maximum(gt[ok], 1e-6)
    assert np.median(rel) < 0.03, np.median(rel)
    assert (u_right.numpy()[ok] < feats.xy_raw.numpy()[ok, 0]).all()


@pytest.mark.parametrize("i", [0, FRAME])
def test_frame_stereo_matches_reference(i):
    """The right camera sits bf/fx along the left camera's +x; both images
    and the left depth within the renderer's tolerances."""
    jseq = jsyn.SyntheticSequence(JCFG.camera, n_frames=N_FRAMES)
    tseq = tsyn.SyntheticSequence(TCFG.camera, n_frames=N_FRAMES,
                                  device="cpu")
    jl, jr, jd = (np.asarray(x) for x in jseq.frame_stereo(i))
    tl, tr, td = (x.numpy() for x in tseq.frame_stereo(i))
    np.testing.assert_allclose(td, jd, atol=TOL_RENDER_DEPTH, rtol=0)
    for a, b in ((tl, jl), (tr, jr)):
        diff = np.abs(a - b)
        assert (diff > TOL_GRAY).mean() <= MAX_FLIP_SHARE, (
            (diff > TOL_GRAY).sum(), diff.max())
    # the pair is a pair: the right image differs from the left
    assert np.abs(tr - tl).mean() > 1e-3


def test_extract_frame_stereo(pair):
    """Extraction on the left image + the SAD search: the stereo fields
    equal `attach_stereo` on the same features, and the features carry
    depth where the match is accepted (mono convention elsewhere)."""
    gl, gr = (torch.from_numpy(np.array(x)) for x in pair[:2])
    feats = ttr.extract_frame_stereo(TCFG, gl, gr, device="cpu")
    base = torb.extract(gl, TCFG.orb, TCFG.camera)
    again = tstereo.attach_stereo(TCFG.camera, base, gl, gr)
    assert torch.equal(feats.u_right, again.u_right)
    assert torch.equal(feats.depth, again.depth)
    ok = feats.u_right >= 0
    assert int(ok.sum()) > 100
    assert bool((feats.depth[ok] > 0).all())
    assert bool((feats.depth[~ok] == 0).all())
    mono = ttr.extract_frame_mono(TCFG, gl, device="cpu")
    assert bool((mono.u_right < 0).all()) and bool((mono.depth <= 0).all())
    # the reference's stereo features on the same pair: as many accepted
    # matches within the pyramid gap (tests/test_torch_orb.py)
    jf = jtr.extract_frame_stereo(JCFG, jnp.asarray(pair[0]),
                                  jnp.asarray(pair[1]))
    n_ref = int((np.asarray(jf.u_right) >= 0).sum())
    assert abs(int(ok.sum()) - n_ref) <= max(3, 0.03 * n_ref), (
        int(ok.sum()), n_ref)
