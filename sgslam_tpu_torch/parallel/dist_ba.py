"""Distributed bundle adjustment over a ('kf' x 'pt') process grid.

Port of `sgslam_tpu/parallel/dist_ba.py` on `torch.distributed`. The
reference runs one `shard_map` program over a JAX device mesh; here every
rank of a process group runs `step` on its own slab and the mesh axes are
process groups:

  'pt' — point blocks. Each rank owns a slab of map points and the
         observations of those points, computes its point-block Schur
         reduction (H_pp^-1 marginalization), and the reduced camera system
         is summed over the 'pt' group (`all_reduce`, the reference's
         `psum`, `dist_ba.py:153-156`).
  'kf' — camera-block rows. Each rank forms only its rows of the reduced
         [C,6,C,6] camera system; the rows are gathered over the 'kf' group
         (list `all_gather`, the reference's tiled `all_gather`, `:159-161`)
         before the dense solve, which every rank repeats.

Rank r sits at (kf, pt) = divmod(r, n_pt), the reference's row-major
device grid. Poses [C,7], opt_mask and lam are the same on every rank; the
points and observations are the rank's 'pt' slab (`make_shardings`).

The reference's decomposition is kept, its clamped row slice included:
`jax.lax.dynamic_slice_in_dim` clamps its start, so when C is not a
multiple of the 'kf' size the last rank's rows are shifted, not padded, and
the gathered system repeats one row block and lacks another
(`map_partition.distributed_global_ba` pads C for that reason). The
scatter-adds are segment sums in a fixed order (`ops.segment`), so a step
repeats on the card; the solves go through `geometry.linalg`, which returns
inf/NaN for a singular system where torch would raise, so that the LM test
rejects such a step as the reference's does (`NaN < x` is False).

Bytes each collective is handed per LM iteration, at C cameras, n_kf x n_pt
ranks and rows = ceil(C / n_kf) (`collective_bytes`): the all-reduces over
'pt' of the S rows (rows * 36 C * 4), their right-hand side (rows * 24), the
camera blocks H_cc (144 C) and the two costs (8); the all-gathers over 'kf'
of the S rows and their right-hand side (n_kf times the first two; none
at n_kf = 1, where the gather is the identity). The S rows dominate:
144 C^2 / n_kf bytes, 2.8 MB at C = 140 on one rank.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..geometry import linalg, se3
from ..geometry.camera import Camera
from ..ops.segment import segment_sum

CHI2_STEREO = 7.815
CHI2_MONO = 5.991


@dataclasses.dataclass
class Mesh:
    """This rank's place in the ('kf' x 'pt') grid and the groups of its
    row ('pt') and column ('kf')."""

    n_kf: int
    n_pt: int
    kf_index: int
    pt_index: int
    kf_group: object
    pt_group: object
    device: torch.device

    @property
    def shape(self):
        return {"kf": self.n_kf, "pt": self.n_pt}


def make_mesh(n_kf_shards: int, n_pt_shards: int, device=None,
              backend: str | None = None) -> Mesh:
    """The ('kf', 'pt') grid over the initialized default process group,
    whose world size must be n_kf_shards * n_pt_shards. Every rank calls it
    (it creates every row and column group, in one order). `device` defaults
    to the rank's card under NCCL and the CPU under gloo; `backend` gives
    the groups another backend than the default group's (gloo for a CPU
    grid beside an NCCL one)."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != n_kf_shards * n_pt_shards:
        raise ValueError(f"a {n_kf_shards} x {n_pt_shards} grid needs "
                         f"{n_kf_shards * n_pt_shards} ranks, not {world}")
    kf_index, pt_index = divmod(rank, n_pt_shards)
    pt_group = kf_group = None
    for i in range(n_kf_shards):
        g = dist.new_group([i * n_pt_shards + j for j in range(n_pt_shards)],
                           backend=backend)
        if i == kf_index:
            pt_group = g
    for j in range(n_pt_shards):
        g = dist.new_group([i * n_pt_shards + j for i in range(n_kf_shards)],
                           backend=backend)
        if j == pt_index:
            kf_group = g
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if (backend or dist.get_backend()) == "nccl"
                  else torch.device("cpu"))
    return Mesh(n_kf_shards, n_pt_shards, kf_index, pt_index, kf_group,
                pt_group, torch.device(device))


def make_shardings(mesh: Mesh):
    """How a global array becomes what this rank holds, on its device:
    'replicated' keeps all of it, 'pt' keeps the rank's slab of the leading
    axis (which must divide by the 'pt' size)."""

    def replicated(x):
        return torch.as_tensor(x).to(mesh.device)

    def pt(x):
        x = torch.as_tensor(x)
        per = x.shape[0] // mesh.n_pt
        if per * mesh.n_pt != x.shape[0]:
            raise ValueError(f"{x.shape[0]} rows do not divide into "
                             f"{mesh.n_pt} slabs")
        return x[mesh.pt_index * per:(mesh.pt_index + 1) * per].to(
            mesh.device)

    return {"replicated": replicated, "pt": pt}


def collective_bytes(C: int, n_kf: int, n_pt: int) -> dict:
    """Bytes handed to each collective of one LM iteration (float32)."""
    rows = -(-C // n_kf)
    gather = n_kf * (rows * 36 * C * 4 + rows * 6 * 4) if n_kf > 1 else 0
    return {"all_reduce_pt": rows * 36 * C * 4 + rows * 6 * 4 + C * 36 * 4
            + 2 * 4, "all_gather_kf": gather}


def _residual_jac(cam: Camera, poses, points, obs_cam, obs_pt, obs_uvr):
    """Same math as optim.local_ba._residual_jac, on the rank's slab:
    r [O,3], Jc [O,3,6], Jp [O,3,3]."""
    T = poses[obs_cam]
    pw = points[obs_pt]
    pc = se3.se3_apply(T, pw)
    x, y = pc[..., 0], pc[..., 1]
    z = torch.clamp(pc[..., 2], min=1e-6)
    invz = 1.0 / z
    u = cam.fx * x * invz + cam.cx
    v = cam.fy * y * invz + cam.cy
    ur = u - cam.bf * invz
    stereo = obs_uvr[..., 2] >= 0
    r = torch.stack([u - obs_uvr[..., 0], v - obs_uvr[..., 1],
                     torch.where(stereo, ur - obs_uvr[..., 2], 0.0)], -1)
    zeros = torch.zeros_like(x)
    ones = torch.ones_like(x)
    du = torch.stack([cam.fx * invz, zeros, -cam.fx * x * invz * invz], -1)
    dv = torch.stack([zeros, cam.fy * invz, -cam.fy * y * invz * invz], -1)
    dur = du + torch.stack([zeros, zeros, cam.bf * invz * invz], -1)
    Jproj = torch.stack([du, dv, torch.where(stereo[..., None], dur, 0.0)],
                        -2)
    dpc = torch.stack([
        torch.stack([ones, zeros, zeros, zeros, pc[..., 2], -pc[..., 1]], -1),
        torch.stack([zeros, ones, zeros, -pc[..., 2], zeros, pc[..., 0]], -1),
        torch.stack([zeros, zeros, ones, pc[..., 1], -pc[..., 0], zeros], -1),
    ], -2)
    Jc = torch.einsum("oij,ojk->oik", Jproj, dpc)
    R = se3.quat_to_mat(T[..., :4])
    Jp = torch.einsum("oij,ojk->oik", Jproj, R)
    return r, Jc, Jp


def _gather_rows(x, mesh: Mesh):
    """The reference's tiled `all_gather` over 'kf': every rank's rows, in
    'kf' order, concatenated along axis 0."""
    if mesh.n_kf == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(mesh.n_kf)]
    dist.all_gather(parts, x.contiguous(), group=mesh.kf_group)
    return torch.cat(parts)


def make_distributed_ba_step(cam: Camera, mesh: Mesh, n_opt_cams: int,
                             damping: float = 1e-4):
    """The SPMD GN step, run by every rank on its slab.

    Per rank ('pt' slab): points [Pl,3], obs_cam [O] i32, obs_pt [O] i32
    (slab-local point index), obs_uvr [O,3], obs_w [O] (inv_sigma2 x
    validity; 0 disables). The same on every rank: poses [C,7], opt_mask
    [C], lam []. Returns (new_poses [C,7], new_points [Pl,3], lam).
    """
    C = n_opt_cams
    kf_size = mesh.n_kf
    rows_per = -(-C // kf_size)
    # dynamic_slice_in_dim clamps its start into [0, C - rows_per]
    row0 = max(0, min(mesh.kf_index * rows_per, C - rows_per))

    def _cost(poses, points, obs_cam, obs_pt, obs_uvr, obs_w):
        """Huber-robust total chi2, summed over the 'pt' group."""
        r, _, _ = _residual_jac(cam, poses, points, obs_cam, obs_pt, obs_uvr)
        chi2 = torch.sum(r * r, -1) * obs_w
        delta2 = torch.where(obs_uvr[..., 2] >= 0, CHI2_STEREO, CHI2_MONO)
        rho = torch.where(chi2 <= delta2, chi2,
                          2.0 * torch.sqrt(delta2 * torch.clamp(chi2,
                                                                min=1e-12))
                          - delta2)
        total = torch.sum(rho).reshape(1)
        dist.all_reduce(total, group=mesh.pt_group)
        return total[0]

    def step(poses, opt_mask, points, obs_cam, obs_pt, obs_uvr, obs_w, lam):
        dev = points.device
        obs_cam = obs_cam.to(torch.int64)
        obs_pt = obs_pt.to(torch.int64)
        r, Jc, Jp = _residual_jac(cam, poses, points, obs_cam, obs_pt,
                                  obs_uvr)
        chi2 = torch.sum(r * r, -1) * obs_w
        delta2 = torch.where(obs_uvr[..., 2] >= 0, CHI2_STEREO, CHI2_MONO)
        huber = torch.where(chi2 <= delta2, 1.0,
                            torch.sqrt(delta2 / torch.clamp(chi2, min=1e-12)))
        w = obs_w * huber
        Jc = torch.where(opt_mask[obs_cam][:, None, None], Jc, 0.0)

        # the reference's .at[].add scatters, as fixed-order segment sums;
        # disabled observations (obs_w == 0) add zeros there and are dropped
        Pl = points.shape[0]
        live = obs_w > 0
        pt_idx = torch.where(live, obs_pt, -1)
        cam_idx = torch.where(live, obs_cam, -1)
        Hpp = segment_sum(torch.einsum("ori,orj,o->oij", Jp, Jp, w)
                          .reshape(-1, 9), pt_idx, Pl).reshape(Pl, 3, 3)
        bp = segment_sum(torch.einsum("ori,or,o->oi", Jp, r, w), pt_idx, Pl)
        A = segment_sum(torch.einsum("ori,orj,o->oij", Jc, Jp, w)
                        .reshape(-1, 18),
                        torch.where(live, obs_pt * C + obs_cam, -1),
                        Pl * C).reshape(Pl, C, 6, 3)
        Hcc_local = segment_sum(torch.einsum("ori,orj,o->oij", Jc, Jc, w)
                                .reshape(-1, 36), cam_idx, C)
        bc_local = segment_sum(torch.einsum("ori,or,o->oi", Jc, r, w),
                               cam_idx, C)

        # LM with relative (diagonal-proportional) damping
        dpp = torch.diagonal(Hpp, dim1=-2, dim2=-1)
        Hpp_inv = linalg.inv(Hpp + lam * torch.diag_embed(dpp)
                             + 1e-6 * torch.eye(3, device=dev))
        M = torch.einsum("pcis,pst->pcit", A, Hpp_inv)

        # 'kf': this rank's camera-block rows of S
        M_rows = M[:, row0:row0 + rows_per]
        S_rows = -torch.einsum("pcit,pdjt->cidj", M_rows,
                               A).contiguous()               # [rows,6,C,6]
        rhs_rows = (bc_local[row0:row0 + rows_per]
                    - torch.einsum("pcit,pt->ci", M_rows, bp)).contiguous()

        # 'pt': sum the partial Schur contributions over the point slabs
        for x in (S_rows, rhs_rows, Hcc_local):
            dist.all_reduce(x, group=mesh.pt_group)
        Hcc = Hcc_local.reshape(C, 6, 6)

        # assemble the whole S on every rank
        S_all = _gather_rows(S_rows, mesh)[:C]                # [C,6,C,6]
        rhs_all = _gather_rows(rhs_rows, mesh)[:C]
        # S_all.at[arange(C), :, arange(C), :].add(Hcc): the two index
        # arrays, split by a slice, put their axis first -> S[c, :, c, :]
        ar = torch.arange(C, device=dev)
        S_all[ar, :, ar, :] = S_all[ar, :, ar, :] + Hcc

        Sd = S_all.reshape(C * 6, C * 6)
        Sd = Sd + torch.diag(lam * torch.diagonal(Sd) + damping)
        dc = linalg.solve(Sd, -rhs_all.reshape(-1)).reshape(C, 6)
        dc = torch.where(opt_mask[:, None], dc, 0.0)

        dp = -torch.einsum("pst,pt->ps", Hpp_inv,
                           bp + torch.einsum("pcis,ci->ps", A, dc))

        new_poses = se3.se3_compose(se3.se3_exp(dc), poses)
        new_poses = torch.where(opt_mask[:, None], new_poses, poses)
        new_points = points + dp

        # accept only improving steps; adapt the damping (the decision
        # compares the same summed costs on every rank of a row)
        c_old = _cost(poses, points, obs_cam, obs_pt, obs_uvr, obs_w)
        c_new = _cost(new_poses, new_points, obs_cam, obs_pt, obs_uvr, obs_w)
        improved = c_new < c_old
        poses = torch.where(improved, new_poses, poses)
        points = torch.where(improved, new_points, points)
        lam = torch.where(improved, torch.clamp(lam * 0.5, min=1e-5),
                          torch.clamp(lam * 4.0, max=1e2))
        return poses, points, lam

    return step


def distributed_ba(cam: Camera, mesh: Mesh, poses, opt_mask, points,
                   obs_cam, obs_pt, obs_uvr, obs_w, iters: int = 10):
    """Run `iters` SPMD GN steps from lam = 1e-3. Arrays are what this rank
    holds (see make_shardings). Returns (poses, this rank's points)."""
    step = make_distributed_ba_step(cam, mesh, poses.shape[0])
    lam = torch.tensor(1e-3, dtype=torch.float32, device=mesh.device)
    for _ in range(iters):
        poses, points, lam = step(poses, opt_mask, points, obs_cam, obs_pt,
                                  obs_uvr, obs_w, lam)
    return poses, points
