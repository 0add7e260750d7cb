"""What the spawned gloo ranks of tests/test_torch_dist_ba.py and
tests/test_torch_map_partition.py run. Every rank imports this module, so
it imports neither JAX nor the JAX package; inputs and outputs travel as
.npz files."""

import os

import numpy as np
import torch

from sgslam_tpu_torch import config, convert
from sgslam_tpu_torch.parallel import dist_ba, dryrun, map_partition


def ba_step(rank, world, dev, cases_path, out_dir):
    """One `make_distributed_ba_step` per case on a 2 x (world / 2) grid;
    each rank saves the poses and its point slab."""
    z = dict(np.load(cases_path))
    mesh = dist_ba.make_mesh(2, world // 2, device=dev)
    sh = dist_ba.make_shardings(mesh)
    cam = config.tum3_config().camera
    out = {}
    for case in sorted({k.split("/")[0] for k in z}):
        g = {k.split("/")[1]: v for k, v in z.items() if k.startswith(case)}
        C = g["poses"].shape[0]
        step = dist_ba.make_distributed_ba_step(cam, mesh, C)
        poses, points, lam = step(
            sh["replicated"](g["poses"]), sh["replicated"](g["opt_mask"]),
            sh["pt"](g["points"]), sh["pt"](g["obs_cam"]),
            sh["pt"](g["obs_pt"]), sh["pt"](g["obs_uvr"]),
            sh["pt"](g["obs_w"]),
            torch.tensor(1e-3, dtype=torch.float32, device=dev))
        out[f"{case}/poses"] = poses.numpy()
        out[f"{case}/points"] = points.numpy()
        out[f"{case}/lam"] = lam.numpy()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)


def global_ba(rank, world, dev, map_path, n_kf, iters, out_dir):
    """`distributed_global_ba` on the small configuration's map (saved by
    `convert.map_to_numpy`) on an n_kf x (world / n_kf) grid; every rank
    saves the whole result."""
    m = convert.map_from_numpy(dict(np.load(map_path)), dev)
    mesh = dist_ba.make_mesh(n_kf, world // n_kf, device=dev)
    out = map_partition.distributed_global_ba(dryrun.small_config(), m, mesh,
                                              iters=iters)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
             kf_pose=out.kf_pose.numpy(), pt_pos=out.pt_pos.numpy())
