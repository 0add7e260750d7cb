"""The dynamic-feature cull: `sgslam_tpu_torch/geometry/epipolar.py` and
`semantic/dynamic.py` (frame-to-frame matching, F-RANSAC, the epipolar
test, the survivor floor).

Frozen copy of the files named above as of commit 1275b16, with
their imports pointed at this folder. It imports nothing of the
program.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from . import se3, search
from .camera import intrinsic_matrix


def fundamental_from_poses(cam: Camera, T1w, T2w):
    """F12 such that x2^T F12 x1 = 0 for pixel coords, from Tcw poses."""
    T12 = se3.se3_compose(T1w, se3.se3_inverse(T2w))  # cam2 -> cam1
    R = se3.quat_to_mat(T12[:4])
    E = se3.hat(T12[4:7]) @ R
    Kinv = torch.linalg.inv(intrinsic_matrix(cam, device=T1w.device))
    return Kinv.T @ E @ Kinv


def epipolar_distance(F, p1, p2):
    """Distance of p2 [N,2] from the epipolar line of p1 [N,2] under F
    [..., 3, 3] (a batch of F gives [..., N]):
    |a u2 + b v2 + c| / sqrt(a^2 + b^2)."""
    x1 = torch.cat([p1, torch.ones_like(p1[..., :1])], -1)
    line = x1 @ F.transpose(-1, -2)                   # [..., N, 3] (a,b,c)
    num = torch.abs(torch.sum(line[..., :2] * p2, -1) + line[..., 2])
    den = torch.sqrt(torch.sum(line[..., :2] ** 2, -1))
    return num / torch.clamp(den, min=1e-9)


def _normalize(pts):
    """Hartley normalization of [..., K, 2] -> (points, T [..., 3, 3])."""
    mu = pts.mean(-2)                                  # [..., 2]
    d = torch.mean(torch.linalg.vector_norm(pts - mu[..., None, :], dim=-1),
                   -1)
    s = math.sqrt(2.0) / torch.clamp(d, min=1e-9)
    zero, one = torch.zeros_like(s), torch.ones_like(s)
    T = torch.stack([
        torch.stack([s, zero, -s * mu[..., 0]], -1),
        torch.stack([zero, s, -s * mu[..., 1]], -1),
        torch.stack([zero, zero, one], -1)], -2)
    ph = torch.cat([pts, torch.ones_like(pts[..., :1])], -1) @ \
        T.transpose(-1, -2)
    return ph[..., :2], T


def _smallest_eigvec3(B):
    """Unit eigenvector of the smallest eigenvalue of symmetric [..., 3, 3]
    matrices: trigonometric eigenvalue formula + row-cross nullspace."""
    eye = torch.eye(3, dtype=B.dtype, device=B.device)
    q = torch.diagonal(B, dim1=-2, dim2=-1).sum(-1) / 3.0
    Bq = B - q[..., None, None] * eye
    p2 = torch.sum(Bq * Bq, (-2, -1)) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=1e-30))
    r = torch.clamp(torch.linalg.det(Bq / p[..., None, None]) / 2.0,
                    -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    lam_min = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)

    C = B - lam_min[..., None, None] * eye
    cands = torch.stack([torch.linalg.cross(C[..., 0, :], C[..., 1, :]),
                         torch.linalg.cross(C[..., 0, :], C[..., 2, :]),
                         torch.linalg.cross(C[..., 1, :], C[..., 2, :])], -2)
    norms = torch.linalg.vector_norm(cands, dim=-1)   # [..., 3]
    best = torch.argmax(norms, -1)
    v = torch.gather(cands, -2, best[..., None, None].expand(
        *best.shape, 1, 3)).squeeze(-2)
    ez = torch.tensor([0.0, 0.0, 1.0], dtype=B.dtype, device=B.device)
    v = torch.where((torch.amax(norms, -1) > 1e-20)[..., None], v, ez)
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1,
                                                    keepdim=True), min=1e-20)


def eight_point(p1, p2):
    """Normalized 8-point fundamental estimates from [..., 8, 2] point
    pairs -> [..., 3, 3]: inverse iteration on A^T A (one Cholesky, two
    deterministic starts, three iterations, the smaller Rayleigh quotient,
    one polish), then the rank-2 projection F - (F v3) v3^T."""
    n1, T1 = _normalize(p1)
    n2, T2 = _normalize(p2)
    x1, y1 = n1[..., 0], n1[..., 1]
    x2, y2 = n2[..., 0], n2[..., 1]
    A = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                     torch.ones_like(x1)], -1)          # [..., 8, 9]
    M = A.transpose(-1, -2) @ A                        # [..., 9, 9]
    eps = 1e-9 * torch.diagonal(M, dim1=-2, dim2=-1).sum(-1) + 1e-12
    eye9 = torch.eye(9, dtype=M.dtype, device=M.device)
    L, info = torch.linalg.cholesky_ex(M + eps[..., None, None] * eye9)
    L = torch.where((info != 0)[..., None, None], math.nan, L)
    X = torch.stack([torch.full((9,), 1.0 / 3.0),
                     torch.tensor([1, -1, 1, -1, 1, -1, 1, -1, 1.0]) / 3.0],
                    1).to(M)                           # [9, 2]
    X = X.expand(*M.shape[:-2], 9, 2)
    for _ in range(3):                                 # inverse iteration
        X = torch.cholesky_solve(X, L)
        X = X / torch.clamp(torch.linalg.vector_norm(X, dim=-2, keepdim=True),
                            min=1e-30)
    ray = torch.einsum("...ik,...ij,...jk->...k", X, M, X)   # [..., 2]
    pick = torch.argmin(ray, -1)
    x = torch.gather(X, -1, pick[..., None, None].expand(
        *pick.shape, 9, 1))                            # [..., 9, 1]
    x = torch.cholesky_solve(x, L)[..., 0]
    x = x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                        min=1e-30)
    F = x.reshape(*x.shape[:-1], 3, 3)
    v3 = _smallest_eigvec3(F.transpose(-1, -2) @ F)
    F = F - (F @ v3[..., None]) * v3[..., None, :]
    return T2.transpose(-1, -2) @ F @ T1


def draw_ranks(n_valid, iters: int, k: int, generator: torch.Generator):
    """[iters, k] int64 sample ranks uniform in [0, max(n_valid, k)), with
    n_valid a device tensor (no host read): the shape of the reference's
    `randint(key, (iters, k), 0, max(n_valid, k))`."""
    u = torch.rand((iters, k), generator=generator, device=n_valid.device)
    hi = torch.clamp(n_valid, min=k)
    return torch.minimum((u * hi.to(torch.float32)).to(torch.int64), hi - 1)


def seeded_ranks(seed: int, n_valid, iters: int, k: int):
    """`draw_ranks` from a fresh generator on n_valid's device seeded with
    `seed` (the reference's key seed): the default Sim3 / PnP RANSAC draws
    and the chunk's per-frame F-RANSAC draws."""
    gen = torch.Generator(device=n_valid.device)
    gen.manual_seed(int(seed))
    return draw_ranks(n_valid, iters, k, gen)


def draw_samples(n_valid, iters: int, generator: torch.Generator):
    """[iters, 8] ranks for the 8-point RANSAC (`draw_ranks`)."""
    return draw_ranks(n_valid, iters, 8, generator)


def ransac_fundamental(p1, p2, valid, generator=None, *, iters: int = 256,
                       thresh: float = 1.0, samples=None):
    """Batched RANSAC: `iters` 8-point hypotheses evaluated at once.

    p1, p2: [N,2] correspondences; valid: [N] bool. `samples` [iters, 8]
    are ranks into the valid-first order of the correspondences (the
    reference's `randint` draws); without them they are drawn from
    `generator`. Returns (F [3,3], inlier_mask [N], n_inliers).
    """
    order = torch.argsort((~valid).to(torch.uint8), stable=True)
    if samples is None:
        if generator is None:
            raise ValueError("ransac_fundamental needs a generator or samples")
        samples = draw_samples(valid.sum(), iters, generator)
    idx = order[samples.to(device=order.device, dtype=torch.int64)]
    Fs = eight_point(p1[idx], p2[idx])                 # [iters, 3, 3]
    d = epipolar_distance(Fs, p1, p2)                  # [iters, N]
    inl = (d < thresh) & valid[None, :]
    counts = torch.sum(inl.to(torch.int32), 1)
    best = torch.argmax(counts).reshape(1)    # [1]: no host read
    return (Fs.index_select(0, best)[0], inl.index_select(0, best)[0],
            counts.index_select(0, best)[0])


@dataclasses.dataclass
class Boxes:
    """Fixed-capacity 2-D detection boxes (Detector2D output contract)."""

    xyxy: torch.Tensor    # [B,4] float32 (x1,y1,x2,y2)
    cls: torch.Tensor     # [B] int32 VOC class id
    score: torch.Tensor   # [B] float32
    valid: torch.Tensor   # [B] bool

    @staticmethod
    def empty(capacity: int = 32, device="cpu") -> "Boxes":
        return Boxes(xyxy=torch.zeros((capacity, 4), device=device),
                     cls=torch.zeros(capacity, dtype=torch.int32,
                                     device=device),
                     score=torch.zeros(capacity, device=device),
                     valid=torch.zeros(capacity, dtype=torch.bool,
                                       device=device))

    def to(self, device) -> "Boxes":
        return Boxes(**{f.name: getattr(self, f.name).to(device)
                        for f in dataclasses.fields(self)})


def in_any_box(xy, boxes: Boxes, box_mask):
    """xy [N,2] inside any (masked) box -> [N] bool
    (Frame::isInDynamicRegion)."""
    x, y = xy[..., 0:1], xy[..., 1:2]                     # [N,1]
    b = boxes.xyxy[None]                                  # [1,B,4]
    inside = ((x >= b[..., 0]) & (x <= b[..., 2])
              & (y >= b[..., 1]) & (y <= b[..., 3]))
    return torch.any(inside & (boxes.valid & box_mask)[None, :], dim=-1)


def _epipolar_cull(cfg: DynamicConfig, kp_xy, kp_valid, prev_xy, status,
                   person_boxes: Boxes, prev_dynamic_boxes: Boxes, sampler,
                   cull_unmatched: bool):
    """Steps 2-5 on correspondences (prev_xy, status)."""
    in_prev_dyn = in_any_box(prev_xy, prev_dynamic_boxes,
                             torch.ones_like(prev_dynamic_boxes.valid))
    for_f = status & ~in_prev_dyn

    F, _, n_inl = ransac_fundamental(
        kp_xy, prev_xy, for_f, iters=cfg.ransac_iters,
        thresh=cfg.ransac_thresh,
        samples=sampler(for_f.sum(), cfg.ransac_iters))

    dist = epipolar_distance(F, kp_xy, prev_xy)
    in_person = in_any_box(kp_xy, person_boxes,
                           torch.ones_like(person_boxes.valid))
    thresh = torch.where(in_person, cfg.epi_dist_in_box, cfg.epi_dist_outside)
    is_dynamic = status & (dist > thresh)
    if cull_unmatched:
        # stronger than the reference: a keypoint inside a confident person
        # box with no frame-to-frame correspondence is culled too
        is_dynamic = is_dynamic | (~status & in_person)

    keep = kp_valid & ~is_dynamic
    keep = _survivor_floor(cfg, kp_valid, keep)
    return keep, torch.sum(status.to(torch.int32)), n_inl


def _survivor_floor(cfg: DynamicConfig, valid, keep):
    """Keep everything if fewer than `min_survivor_ratio` survive."""
    n_total = torch.sum(valid.to(torch.int32))
    n_keep = torch.sum(keep.to(torch.int32))
    too_aggressive = n_keep < cfg.min_survivor_ratio * n_total.to(
        torch.float32)
    return torch.where(too_aggressive, valid, keep)


def match_prev_frame(matcher_cfg, scale_factor: float, feats_cur,
                     prev_xy, prev_level, prev_angle, prev_desc, prev_valid,
                     radius: float = 24.0):
    """Frame-to-frame correspondences by windowed ORB matching (one
    [keypoints x previous keypoints] Hamming matrix, K1 on the GPU), with
    rotation-consistency filtering. Returns (prev_xy_of_cur [N,2],
    status [N] bool)."""
    N = feats_cur.xy_raw.shape[0]
    idx, ok, dist = search.search_by_projection(
        feats_cur.xy_raw,
        torch.full((N,), radius, device=feats_cur.xy_raw.device),
        feats_cur.level, feats_cur.desc, feats_cur.valid,
        prev_xy, prev_level, prev_desc, prev_valid,
        level_window=1, max_dist=matcher_cfg.th_low,
        scale_factor=scale_factor)
    ok = search.resolve_duplicate_targets(idx, ok, dist, prev_xy.shape[0])
    if matcher_cfg.check_orientation:
        dtheta = feats_cur.angle - prev_angle[idx]
        ok = search.rotation_consistency(dtheta, ok, matcher_cfg.histo_length)
    return prev_xy[idx], ok


def reject_dynamic_matched(cfg: DynamicConfig, kp_xy, kp_valid, prev_xy,
                           status, person_boxes: Boxes,
                           prev_dynamic_boxes: Boxes, sampler):
    """Dynamic rejection on precomputed frame-to-frame correspondences
    (steps 2-5). Returns (keep_mask [N], n_corr, n_inliers_F)."""
    return _epipolar_cull(cfg, kp_xy, kp_valid, prev_xy, status,
                          person_boxes, prev_dynamic_boxes, sampler,
                          cull_unmatched=cfg.cull_unmatched_in_box)


def apply_keep_mask(feats, keep):
    """Culling = masking (replaces the reference's descriptor-row erase)."""
    return dataclasses.replace(feats, valid=feats.valid & keep)
