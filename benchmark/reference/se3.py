"""SE(3) / Sim(3) operations: `sgslam_tpu_torch/geometry/se3.py`.

Frozen copy of the files named above as of commit 1275b16, with
their imports pointed at this folder. It imports nothing of the
program.
"""

from __future__ import annotations

import torch

from . import linalg


_EPS = 1e-8


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


# ---------------------------------------------------------------------------
# Quaternions (w, x, y, z)
# ---------------------------------------------------------------------------

def quat_identity(dtype=torch.float32, device=None):
    return torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=device)


def quat_normalize(q):
    n = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return q / torch.clamp(n, min=_EPS)


def quat_mul(a, b):
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_conj(q):
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_rotate(q, v):
    """Rotate vectors v [..., 3] by unit quaternions q [..., 4]."""
    w = q[..., :1]
    u = q[..., 1:]
    t = 2.0 * _cross(u, v)
    return v + w * t + _cross(u, t)


def quat_to_mat(q):
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def mat_to_quat(m):
    """Rotation matrix [..., 3, 3] -> unit quaternion, branchless Shepperd."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=_EPS))

    # Four candidate decompositions; pick the numerically largest pivot.
    s0 = safe_sqrt(1.0 + tr)             # pivot w
    q0 = torch.stack([0.5 * s0, (m21 - m12) / (2 * s0), (m02 - m20) / (2 * s0),
                      (m10 - m01) / (2 * s0)], dim=-1)
    s1 = safe_sqrt(1.0 + m00 - m11 - m22)  # pivot x
    q1 = torch.stack([(m21 - m12) / (2 * s1), 0.5 * s1, (m01 + m10) / (2 * s1),
                      (m02 + m20) / (2 * s1)], dim=-1)
    s2 = safe_sqrt(1.0 - m00 + m11 - m22)  # pivot y
    q2 = torch.stack([(m02 - m20) / (2 * s2), (m01 + m10) / (2 * s2), 0.5 * s2,
                      (m12 + m21) / (2 * s2)], dim=-1)
    s3 = safe_sqrt(1.0 - m00 - m11 + m22)  # pivot z
    q3 = torch.stack([(m10 - m01) / (2 * s3), (m02 + m20) / (2 * s3),
                      (m12 + m21) / (2 * s3), 0.5 * s3], dim=-1)

    pivots = torch.stack([tr, m00 - m11 - m22, m11 - m00 - m22, m22 - m00 - m11],
                         dim=-1)
    idx = torch.argmax(pivots, dim=-1)
    cand = torch.stack([q0, q1, q2, q3], dim=-2)  # [..., 4, 4]
    q = torch.take_along_dim(cand, idx[..., None, None].expand(
        idx.shape + (1, 4)), dim=-2)[..., 0, :]
    # Canonicalize sign (w >= 0) and normalize.
    q = q * torch.where(q[..., :1] < 0, -1.0, 1.0)
    return quat_normalize(q)


# ---------------------------------------------------------------------------
# SO(3)
# ---------------------------------------------------------------------------

def hat(w):
    """[..., 3] -> skew-symmetric [..., 3, 3]."""
    wx, wy, wz = w.unbind(-1)
    z = torch.zeros_like(wx)
    m = torch.stack([z, -wz, wy, wz, z, -wx, -wy, wx, z], dim=-1)
    return m.reshape(w.shape[:-1] + (3, 3))


def so3_exp_quat(w):
    """Rotation vector [..., 3] -> unit quaternion."""
    theta2 = torch.sum(w * w, dim=-1, keepdim=True)
    theta = torch.sqrt(torch.clamp(theta2, min=0.0))
    half = 0.5 * theta
    small = theta < 1e-4
    # sin(t/2)/t with Taylor fallback: 1/2 - t^2/48
    k = torch.where(small, 0.5 - theta2 / 48.0,
                    torch.sin(half) / torch.clamp(theta, min=_EPS))
    cw = torch.where(small, 1.0 - theta2 / 8.0, torch.cos(half))
    return quat_normalize(torch.cat([cw, k * w], dim=-1))


def so3_log(q):
    """Unit quaternion -> rotation vector [..., 3]."""
    q = q * torch.where(q[..., :1] < 0, -1.0, 1.0)  # shortest arc
    w = torch.clamp(q[..., :1], -1.0, 1.0)
    v = q[..., 1:]
    vn = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    theta = 2.0 * torch.atan2(vn, w)
    small = vn < 1e-6
    k = torch.where(small, 2.0 / torch.clamp(w, min=_EPS),
                    theta / torch.clamp(vn, min=_EPS))
    return k * v


def _rot_coeffs(theta2):
    """A = sin t / t, B = (1-cos t)/t^2, C = (t - sin t)/t^3, Taylor-guarded
    below t = 0.01 (the reference's f32-aware threshold)."""
    theta = torch.sqrt(torch.clamp(theta2, min=0.0))
    small = theta < 1e-2
    a = torch.where(small, 1.0 - theta2 / 6.0,
                    torch.sin(theta) / torch.clamp(theta, min=_EPS))
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / torch.clamp(theta2, min=_EPS))
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta))
                    / torch.clamp(theta2 * theta, min=_EPS))
    return a, b, c


# ---------------------------------------------------------------------------
# SE(3):  T = (q, t),  x -> R x + t
# ---------------------------------------------------------------------------

def se3_identity(dtype=torch.float32, device=None):
    return torch.tensor([1, 0, 0, 0, 0, 0, 0], dtype=dtype, device=device)


def se3_quat(T):
    return T[..., :4]


def se3_trans(T):
    return T[..., 4:7]


def se3_make(q, t):
    return torch.cat([q, t], dim=-1)


def se3_apply(T, x):
    return quat_rotate(T[..., :4], x) + T[..., 4:7]


def se3_compose(A, B):
    """(A*B) x = A(B(x))."""
    q = quat_mul(A[..., :4], B[..., :4])
    t = quat_rotate(A[..., :4], B[..., 4:7]) + A[..., 4:7]
    return se3_make(quat_normalize(q), t)


def se3_inverse(T):
    qi = quat_conj(T[..., :4])
    ti = -quat_rotate(qi, T[..., 4:7])
    return se3_make(qi, ti)


def se3_exp(xi):
    """Twist [..., 6] = (v, w) -> SE3 [..., 7]. t = V(w) v."""
    v, w = xi[..., :3], xi[..., 3:6]
    theta2 = torch.sum(w * w, dim=-1, keepdim=True)
    _, b, c = _rot_coeffs(theta2)
    wx = hat(w)
    wxv = torch.einsum("...ij,...j->...i", wx, v)
    wxwxv = torch.einsum("...ij,...j->...i", wx, wxv)
    t = v + b * wxv + c * wxwxv
    return se3_make(so3_exp_quat(w), t)


def se3_log(T):
    """SE3 -> twist (v, w) with exp(log(T)) == T.

    V^{-1} = I - 1/2 W + coef * W^2 with coef = (1 - a/(2b)) / theta^2, and
    the series 1/12 + theta^2/720 below theta^2 = 2.5e-3 where the general
    form cancels in f32 (the reference's threshold).
    """
    w = so3_log(T[..., :4])
    t = T[..., 4:7]
    theta2 = torch.sum(w * w, dim=-1, keepdim=True)
    a, b, _ = _rot_coeffs(theta2)
    small = theta2 < 2.5e-3
    coef = torch.where(small, 1.0 / 12.0 + theta2 / 720.0,
                       (1.0 - a / torch.clamp(2.0 * b, min=_EPS))
                       / torch.clamp(theta2, min=_EPS))
    wx = hat(w)
    wxt = torch.einsum("...ij,...j->...i", wx, t)
    wxwxt = torch.einsum("...ij,...j->...i", wx, wxt)
    v = t - 0.5 * wxt + coef * wxwxt
    return torch.cat([v, w], dim=-1)


def se3_to_matrix(T):
    m = torch.zeros(T.shape[:-1] + (4, 4), dtype=T.dtype, device=T.device)
    m[..., :3, :3] = quat_to_mat(T[..., :4])
    m[..., :3, 3] = T[..., 4:7]
    m[..., 3, 3] = 1.0
    return m


def se3_from_matrix(m):
    return se3_make(mat_to_quat(m[..., :3, :3]), m[..., :3, 3])


# ---------------------------------------------------------------------------
# Sim(3):  S = (q, t, s),  x -> s R x + t   (loop closing, essential graph)
# ---------------------------------------------------------------------------

def sim3_identity(dtype=torch.float32, device=None):
    return torch.tensor([1, 0, 0, 0, 0, 0, 0, 1], dtype=dtype, device=device)


def sim3_make(q, t, s):
    return torch.cat([q, t, s[..., None] if s.dim() < q.dim() else s], dim=-1)


def sim3_scale(S):
    return S[..., 7]


def sim3_apply(S, x):
    return S[..., 7:8] * quat_rotate(S[..., :4], x) + S[..., 4:7]


def sim3_compose(A, B):
    q = quat_normalize(quat_mul(A[..., :4], B[..., :4]))
    t = A[..., 7:8] * quat_rotate(A[..., :4], B[..., 4:7]) + A[..., 4:7]
    s = A[..., 7:8] * B[..., 7:8]
    return torch.cat([q, t, s], dim=-1)


def sim3_inverse(S):
    qi = quat_conj(S[..., :4])
    si = 1.0 / torch.clamp(S[..., 7:8], min=_EPS)
    ti = -si * quat_rotate(qi, S[..., 4:7])
    return torch.cat([qi, ti, si], dim=-1)


def sim3_from_se3(T, s=None):
    s = (torch.ones(T.shape[:-1] + (1,), dtype=T.dtype, device=T.device)
         if s is None else s)
    return torch.cat([T[..., :4], T[..., 4:7], s], dim=-1)


def sim3_to_se3(S):
    """Drop the scale (the translation is not divided; the caller decides)."""
    return S[..., :7]


def sim3_exp(xi):
    """sim3 twist [..., 7] = (v, w, sigma) -> Sim3 [..., 8]; t = W v with W
    from Strasdat's appendix, guarded for small theta and small sigma."""
    v, w, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6:7]
    s = torch.exp(sigma)
    theta2 = torch.sum(w * w, dim=-1, keepdim=True)
    theta = torch.sqrt(torch.clamp(theta2, min=0.0))
    wx = hat(w)
    wx2 = torch.einsum("...ij,...jk->...ik", wx, wx)

    eps = 1e-5
    sig_small = torch.abs(sigma) < eps
    th_small = theta < eps
    sig_safe = torch.where(sig_small, torch.ones_like(sigma), sigma)
    th_safe = torch.where(th_small, torch.ones_like(theta), theta)

    A = torch.where(sig_small, 1.0 + sigma / 2.0 + sigma * sigma / 6.0,
                    (s - 1.0) / sig_safe)
    a_ = s * torch.sin(theta)
    b_ = s * torch.cos(theta)
    den = torch.clamp(sigma * sigma + theta2, min=_EPS)
    B_gen = (a_ * sigma + (1.0 - b_) * th_safe) / (th_safe * den)
    C_gen = (A - ((b_ - 1.0) * sigma + a_ * th_safe) / den) \
        / torch.clamp(theta2, min=_EPS)
    _, b0, c0 = _rot_coeffs(theta2)
    B_th0 = torch.where(sig_small, b0,
                        ((sig_safe - 1.0) * s + 1.0) / (sig_safe * sig_safe))
    C_th0 = torch.where(
        sig_small, c0,
        (s * (0.5 * sig_safe * sig_safe - sig_safe + 1.0) - 1.0)
        / (sig_safe * sig_safe * sig_safe))
    B = torch.where(th_small, B_th0, torch.where(sig_small, b0, B_gen))
    C = torch.where(th_small, C_th0, torch.where(sig_small, c0, C_gen))

    eye = torch.eye(3, dtype=xi.dtype, device=xi.device).expand(wx.shape)
    W = A[..., None] * eye + B[..., None] * wx + C[..., None] * wx2
    t = torch.einsum("...ij,...j->...i", W, v)
    return torch.cat([so3_exp_quat(w), t, s], dim=-1)


def sim3_log(S):
    """Sim3 -> twist (v, w, sigma), the inverse of `sim3_exp`."""
    w = so3_log(S[..., :4])
    s = S[..., 7:8]
    sigma = torch.log(torch.clamp(s, min=_EPS))
    eye = torch.eye(3, dtype=S.dtype, device=S.device)
    cols = []
    for i in range(3):
        e = eye[i].expand(w.shape)
        cols.append(sim3_exp(torch.cat([e, w, sigma], dim=-1))[..., 4:7])
    W = torch.stack(cols, dim=-1)          # [..., 3, 3], W e_i as columns
    v = linalg.solve(W, S[..., 4:7, None])[..., 0]
    return torch.cat([v, w, sigma], dim=-1)
