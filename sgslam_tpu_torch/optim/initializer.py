"""Monocular two-view initialization: batched homography + fundamental
RANSAC, model selection, motion recovery, triangulation.

Port of `sgslam_tpu/optim/initializer.py` (the contract of the reference's
Initializer): both model families are batched hypothesize-and-verify (200
8-point F and 200 4-point H hypotheses, one batched SVD each, one masked
score matrix each), the model is selected by RH = SH / (SH + SF) > 0.40,
and the winning model's motion candidates are voted on by cheirality and
reprojection in one batch.

Three rules keep it the reference's:
  * the sample ranks index the valid-first order of the matches, which
    `jnp.argsort(~valid)` gives stably: the port sorts with `stable=True`;
  * `jax.random.randint` draws are replaced by `samples` (tests replay the
    reference's) or drawn from a `torch.Generator` without a host read;
  * the motion candidates take the SVD's vectors as they come. The F
    branch tries +-t, so a sign flip of U's last column changes nothing;
    the H branch keeps the reference's one-sided (R1, tu), (R2, tu) and its
    t_H = (Hn - R_H) e3, which depends on the sign of the DLT null vector,
    so a batched SVD that returns other signs than the reference's LAPACK
    changes the candidate set (ROADMAP section 3 measures how often).
"""

from __future__ import annotations

import torch

from ..geometry import linalg, se3
from ..geometry.camera import Camera, intrinsic_matrix
from ..geometry.epipolar import draw_ranks

# reference score thresholds (Initializer.cc:478, 543)
TH_F = 3.841
TH_H = 5.991
TH_SCORE = 5.991


def _normalize_pts(p):
    """Hartley normalization (Initializer.cc:758-804): p [N,2] ->
    (pn [N,2], T [3,3])."""
    mu = torch.mean(p, dim=0)
    d = torch.mean(torch.abs(p - mu), dim=0)
    s = 1.0 / torch.clamp(d, min=1e-8)
    z, o = torch.zeros_like(s[0]), torch.ones_like(s[0])
    T = torch.stack([torch.stack([s[0], z, -mu[0] * s[0]]),
                     torch.stack([z, s[1], -mu[1] * s[1]]),
                     torch.stack([z, z, o])])
    return (p - mu) * s, T


def _null_vector(A):
    """Right singular vector of the smallest singular value of [..., 8, 9]
    rows, as a [..., 3, 3] matrix."""
    Vt = linalg.svd(A, full_matrices=True)[2]
    return Vt[..., -1, :].reshape(A.shape[:-2] + (3, 3))


def _dlt_fundamental(p1, p2):
    """8-point algorithm on [..., 8, 2] pairs -> F [..., 3, 3] (rank 2
    enforced)."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    A = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                     torch.ones_like(x1)], dim=-1)
    F = _null_vector(A)
    U, S, Vt = linalg.svd(F)
    s = torch.stack([S[..., 0], S[..., 1], torch.zeros_like(S[..., 0])], -1)
    return (U * s[..., None, :]) @ Vt


def _dlt_homography(p1, p2):
    """4-point DLT on [..., 4, 2] pairs -> H [..., 3, 3]: two rows per
    point, interleaved as the reference concatenates them."""
    x, y = p1[..., 0], p1[..., 1]
    u, v = p2[..., 0], p2[..., 1]
    z, o = torch.zeros_like(x), torch.ones_like(x)
    ra = torch.stack([z, z, z, -x, -y, -o, v * x, v * y, v], -1)
    rb = torch.stack([x, y, o, z, z, z, -u * x, -u * y, -u], -1)
    A = torch.stack([ra, rb], -2).reshape(x.shape[:-1] + (8, 9))
    return _null_vector(A)


def _homogeneous(p):
    return torch.cat([p, torch.ones_like(p[..., :1])], -1)


def _sym_transfer_err_H(H, p1, p2):
    """Symmetric transfer errors for H [..., 3, 3] over [N, 2] matches
    (Initializer.cc:459-533) -> (e12, e21) [..., N]. A singular H gives
    non-finite errors, as the reference's `inv` does, not an exception."""
    def transfer(M, a):
        b = _homogeneous(a) @ M.transpose(-1, -2)
        return (b[..., :2] / torch.clamp(torch.abs(b[..., 2:3]), min=1e-9)
                * torch.sign(b[..., 2:3] + 1e-30))

    e12 = torch.sum((transfer(H, p1) - p2) ** 2, -1)
    e21 = torch.sum((transfer(linalg.inv(H), p2) - p1) ** 2, -1)
    return e12, e21


def _epi_err_F(F, p1, p2):
    """Squared epipolar distances both directions (Initializer.cc:535-580)
    for F [..., 3, 3] over [N, 2] matches -> (d1, d2) [..., N]."""
    p1h, p2h = _homogeneous(p1), _homogeneous(p2)
    l2 = p1h @ F.transpose(-1, -2)      # line in image 2
    l1 = p2h @ F                        # line in image 1
    d2 = (torch.sum(p2h * l2, -1) ** 2
          / torch.clamp(l2[..., 0] ** 2 + l2[..., 1] ** 2, min=1e-12))
    d1 = (torch.sum(p1h * l1, -1) ** 2
          / torch.clamp(l1[..., 0] ** 2 + l1[..., 1] ** 2, min=1e-12))
    return d1, d2


def _score(e1, e2, th_model, valid):
    """ORB-SLAM2 truncated score (higher = better) + inlier mask, summed
    over the last axis."""
    in1 = (e1 < th_model) & valid
    in2 = (e2 < th_model) & valid
    s = (torch.where(in1, TH_SCORE - e1, 0.0)
         + torch.where(in2, TH_SCORE - e2, 0.0))
    return torch.sum(s, -1), in1 & in2


def _triangulate_midpoint(cam: Camera, T21, p1, p2):
    """Batched midpoint triangulation in camera-1 coordinates: T21 [..., 7],
    p1/p2 [N, 2] -> (points [..., N, 3], cos parallax [..., N])."""
    def ray(uv):
        return torch.stack([(uv[:, 0] - cam.cx) / cam.fx,
                            (uv[:, 1] - cam.cy) / cam.fy,
                            torch.ones_like(uv[:, 0])], -1)

    r1 = ray(p1)
    T12 = se3.se3_inverse(T21)[..., None, :]
    r2 = se3.quat_rotate(T12[..., :4], ray(p2))
    o2 = T12[..., 4:7]
    w = torch.sum(r1 * r2, -1)
    d11 = torch.sum(r1 * r1, -1)
    d22 = torch.sum(r2 * r2, -1)
    dd = -o2
    den = torch.clamp(d11 * d22 - w * w, min=1e-12)
    s1 = (w * torch.sum(r2 * dd, -1) - d22 * torch.sum(r1 * dd, -1)) / den
    s2 = (d11 * torch.sum(r2 * dd, -1) - w * torch.sum(r1 * dd, -1)) / den
    pw = 0.5 * (s1[..., None] * r1 + (o2 + s2[..., None] * r2))
    cosp = w / torch.sqrt(torch.clamp(d11 * d22, min=1e-12))
    return pw, cosp


def _check_rt(cam: Camera, R, t, p1, p2, inlier):
    """Cheirality + reprojection support of (R, t) candidates [..., 3, 3],
    [..., 3] (Initializer.cc:806-900 CheckRT) -> (count [...], T21 [..., 7],
    points [..., N, 3], good [..., N])."""
    q = se3.quat_normalize(se3.mat_to_quat(R))
    T21 = se3.se3_make(q, t)
    pw, cosp = _triangulate_midpoint(cam, T21, p1, p2)
    pc2 = se3.se3_apply(T21[..., None, :], pw)

    def reproj_err(pc, p):
        z = torch.clamp(pc[..., 2], min=1e-9)
        u = cam.fx * pc[..., 0] / z + cam.cx
        v = cam.fy * pc[..., 1] / z + cam.cy
        return (u - p[:, 0]) ** 2 + (v - p[:, 1]) ** 2

    good = (inlier & (pw[..., 2] > 0.0) & (pc2[..., 2] > 0.0)
            & (reproj_err(pw, p1) < 4.0) & (reproj_err(pc2, p2) < 4.0)
            & (cosp < 0.99998))
    return torch.sum(good.to(torch.int32), -1), T21, pw, good


def _pick(x, i):
    """x[i] for a one-element index tensor, without a host read."""
    return x.index_select(0, i)[0]


def _vote(counts, Ts, pws, goods, n_inlier):
    """ReconstructF's acceptance (Initializer.cc:700-755) over the four
    candidates of one model: a clear winner with enough support."""
    b = torch.argmax(counts).reshape(1)
    n_best = _pick(counts, b)
    second = torch.sort(counts).values[-2]
    ok = ((n_best.to(torch.float32)
           > 0.9 * n_inlier.to(torch.float32) * 0.5)
          & (n_best > 30) & (second < 0.75 * n_best))
    return ok, _pick(Ts, b), _pick(pws, b), _pick(goods, b)


def initialize_mono(cam: Camera, p1, p2, valid, generator=None, *,
                    iters: int = 200, samples=None):
    """Two-view monocular initialization.

    p1/p2: [N,2] matched pixel coords in frames 1/2; valid: [N] bool.
    `samples` = (F ranks [iters, 8], H ranks [iters, 4]) into the
    valid-first order of the matches (the reference's `randint` draws over
    max(n_valid, 8)); without them they are drawn from `generator`.
    Returns dict with:
      ok        scalar bool — initialization accepted
      used_H    scalar bool — homography model won the RH ratio test
      T21       [7] frame-1 -> frame-2 pose (unit-norm translation)
      points    [N,3] triangulated points in frame-1 coords
      good      [N] bool — triangulated-inlier mask
      rh        scalar — the SH/(SH+SF) model-selection ratio
    """
    dev = p1.device
    order = torch.argsort((~valid).to(torch.uint8), stable=True)
    if samples is None:
        if generator is None:
            raise ValueError("initialize_mono needs a generator or samples")
        n_valid = torch.clamp(torch.sum(valid.to(torch.int32)), min=8)
        samples = (draw_ranks(n_valid, iters, 8, generator),
                   draw_ranks(n_valid, iters, 4, generator))
    sf, sh = (order[s.to(device=dev, dtype=torch.int64)] for s in samples)

    p1n, T1 = _normalize_pts(p1)
    p2n, T2 = _normalize_pts(p2)

    # ---- batched F hypotheses (8-point) ----
    Fs = T2.T @ _dlt_fundamental(p1n[sf], p2n[sf]) @ T1
    scores_F = _score(*_epi_err_F(Fs, p1, p2), TH_F, valid)[0]
    best_F = _pick(Fs, torch.argmax(scores_F).reshape(1))
    SF, inl_F = _score(*_epi_err_F(best_F, p1, p2), TH_F, valid)

    # ---- batched H hypotheses (4-point) ----
    Hs = linalg.inv(T2) @ _dlt_homography(p1n[sh], p2n[sh]) @ T1
    scores_H = _score(*_sym_transfer_err_H(Hs, p1, p2), TH_H, valid)[0]
    best_H = _pick(Hs, torch.argmax(scores_H).reshape(1))
    SH, inl_H = _score(*_sym_transfer_err_H(best_H, p1, p2), TH_H, valid)

    # model selection (Initializer.cc:88-95)
    RH = SH / torch.clamp(SH + SF, min=1e-9)
    use_H = RH > 0.40

    # ---- motion recovery ----
    K = intrinsic_matrix(cam, device=dev)
    Kinv = linalg.inv(K)

    # from F: essential decomposition, 4 candidates (ReconstructF)
    U, _, Vt = linalg.svd(K.T @ best_F @ K)
    U = U * torch.sign(torch.linalg.det(U))
    Vt = Vt * torch.sign(torch.linalg.det(Vt))
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     device=dev)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    tu = U[:, 2]
    tu = tu / torch.clamp(torch.linalg.vector_norm(tu), min=1e-9)

    # from H: the reference's low-parallax reading H ~ R + t n^T / d, the
    # rotation by orthogonalizing the scale-normalized H, and the
    # essential-matrix pair with one sign of tu
    Hn = Kinv @ best_H @ K
    Hn = Hn / torch.clamp(linalg.svd(Hn)[1][1], min=1e-9)
    Ur, _, Vtr = linalg.svd(Hn)
    R_H = Ur @ Vtr
    R_H = R_H * torch.sign(torch.linalg.det(R_H))
    t_H = (Hn - R_H) @ torch.tensor([0.0, 0.0, 1.0], device=dev)
    t_H_n = t_H / torch.clamp(torch.linalg.vector_norm(t_H), min=1e-9)

    inlier = torch.where(use_H, inl_H, inl_F)
    n_inlier = torch.sum(inlier.to(torch.int32))
    # F candidates, then H candidates: one batch of eight
    R = torch.stack([R1, R1, R2, R2, R_H, R_H, R1, R2])
    t = torch.stack([tu, -tu, tu, -tu, t_H_n, -t_H_n, tu, tu])
    counts, Ts, pws, goods = _check_rt(cam, R, t, p1, p2, inlier)
    okF, TF, pwF, goodF = _vote(counts[:4], Ts[:4], pws[:4], goods[:4],
                                n_inlier)
    okH, TH, pwH, goodH = _vote(counts[4:], Ts[4:], pws[4:], goods[4:],
                                n_inlier)
    return dict(ok=torch.where(use_H, okH, okF), used_H=use_H,
                T21=torch.where(use_H, TH, TF),
                points=torch.where(use_H, pwH, pwF),
                good=torch.where(use_H, goodH, goodF), rh=RH)
