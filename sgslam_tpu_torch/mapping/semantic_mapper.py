"""Per-keyframe semantic mapping stage.

Port of `sgslam_tpu/mapping/semantic_mapper.py` (the PointCloudMapping
contract): per keyframe, dense back-projection with dynamic-box masking,
voxel + outlier filtering, 3-D objects per 2-D object box into the object
database, occupancy carving, and a rolling global cloud on the host.
Host reads per keyframe: the valid object boxes, one flag per box, and the
filtered cloud for the global buffer.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..config import SlamConfig
from ..geometry import se3
from ..semantic import detector3d
from ..semantic.dynamic import Boxes
from ..semantic.objects import ObjectDB, add_object
from . import occupancy, pointcloud


class SemanticMapper:
    def __init__(self, cfg: SlamConfig, grid_dim: int | None = None,
                 global_capacity: int = 1 << 18, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        mc = cfg.mapping
        # occupancy grid centred on the map origin
        grid_dim = grid_dim if grid_dim is not None else mc.grid_dim // 2
        voxel = 2.0 * mc.voxel_size            # octomap.launch resolution
        half = grid_dim * voxel / 2.0
        self.grid = occupancy.empty_grid(grid_dim, voxel,
                                         origin=(-half, -half, -half),
                                         device=self.device)
        self.objects = ObjectDB.empty(256, self.device)
        self.global_pts = np.zeros((global_capacity, 3), np.float32)
        self.global_int = np.zeros(global_capacity, np.float32)
        self.n_global = 0
        self.last_local = None  # (pts, intensity, valid) of newest KF

    def insert_keyframe(self, gray, depth, Tcw, dynamic_boxes: Boxes = None,
                        object_boxes: Boxes = None):
        """Process one keyframe's RGB-D data (tensors on the mapper's
        device; Tcw [7] world->camera)."""
        cfg = self.cfg
        dev = self.device
        gray = torch.as_tensor(gray, device=dev)
        depth = torch.as_tensor(depth, device=dev)
        Tcw = torch.as_tensor(Tcw, dtype=torch.float32, device=dev)
        if dynamic_boxes is None:
            dynamic_boxes = Boxes.empty(cfg.detector.max_boxes, dev)
        T_wc = se3.se3_inverse(Tcw)

        pts, inten, valid = pointcloud.backproject_depth(
            cfg.camera, depth, gray, T_wc, dynamic_boxes,
            depth_min=cfg.mapping.depth_min, depth_max=cfg.mapping.depth_max)

        # local cloud: voxel downsample + density outlier filter
        vp, vi, vok = pointcloud.voxel_downsample(
            pts, inten, valid, voxel_size=cfg.mapping.voxel_size)
        vok = pointcloud.density_outlier_filter(
            vp, vok, voxel_size=3 * cfg.mapping.voxel_size,
            min_neighbors=cfg.mapping.sor_neighbors // 4)
        self.last_local = (vp, vi, vok)

        # occupancy carving from the (already dynamic-masked) local cloud
        self.grid = occupancy.insert_scan(self.grid, T_wc[4:7], vp, vok)

        # 3-D semantic objects from 2-D boxes (Detector3D::Detect per box)
        if object_boxes is not None:
            h, w = depth.shape
            uv = pointcloud.pixel_grid(h, w, dev)
            for b in np.nonzero(object_boxes.valid.cpu().numpy())[0]:
                centroid, size, ok = detector3d.extract_object(
                    cfg.camera, pts, uv, valid, object_boxes.xyxy[b], Tcw,
                    depth_min=cfg.mapping.depth_min,
                    depth_max=cfg.mapping.depth_max)
                if bool(ok):
                    self.objects = add_object(
                        self.objects, centroid, size,
                        object_boxes.score[b], object_boxes.cls[b])

        # global cloud accumulation (host-side ring buffer)
        vok_np = vok.cpu().numpy()
        p_np = vp.cpu().numpy()[vok_np]
        i_np = vi.cpu().numpy()[vok_np]
        n = len(p_np)
        cap = len(self.global_pts)
        if self.n_global + n > cap:
            self.n_global = 0  # wrap (visualization buffer semantics)
        self.global_pts[self.n_global:self.n_global + n] = p_np
        self.global_int[self.n_global:self.n_global + n] = i_np
        self.n_global += n

    # -- exports (the reference's ROS publications / PCD dump) --
    def global_cloud(self):
        return (self.global_pts[:self.n_global],
                self.global_int[:self.n_global])

    def save_pcd(self, path: str):
        """ASCII PCD of the global cloud."""
        pts, inten = self.global_cloud()
        with open(path, "w") as f:
            f.write("# .PCD v0.7 - Point Cloud Data file format\n"
                    "VERSION 0.7\nFIELDS x y z intensity\n"
                    "SIZE 4 4 4 4\nTYPE F F F F\nCOUNT 1 1 1 1\n"
                    f"WIDTH {len(pts)}\nHEIGHT 1\n"
                    "VIEWPOINT 0 0 0 1 0 0 0\n"
                    f"POINTS {len(pts)}\nDATA ascii\n")
            for p, c in zip(pts, inten):
                f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f} {c:.4f}\n")

    def occupancy_2d(self):
        return occupancy.project_2d(self.grid).cpu().numpy()

    def save_octomap(self, path: str):
        """Octomap `.bt` export of the occupancy grid. Returns the world
        translation of the file's frame (the container stores none)."""
        from . import octomap_io

        return octomap_io.write_bt(path, self.grid)
