"""The reference's configuration, read from a configuration file of
`benchmark/configs/`: one attribute group per group of the file, and the
camera as `camera.Camera`."""

from __future__ import annotations

from types import SimpleNamespace

from .camera import Camera


class Config(SimpleNamespace):
    @property
    def close_depth_threshold(self) -> float:
        """Depth below which a point counts as close (ThDepth)."""
        return (self.camera.bf / self.camera.fx
                * self.tracker.depth_threshold_factor)


def from_file(doc: dict) -> Config:
    groups = {k: SimpleNamespace(**v) for k, v in doc.items()
              if isinstance(v, dict) and k in GROUPS}
    return Config(camera=Camera(**doc["camera"]), **groups)


GROUPS = ("orb", "tracker", "matcher", "dynamic", "detector", "mapping",
          "capacity", "loop", "mesh")
