"""The runners a configuration file names under `runner.kind`: a module
name, `runners/<runner.kind>.py`, which is not always the family that the
module's `Runner.kind` declares. Each module has `Runner(doc, frames,
device, capture)` (the configuration file, the traffic's frames) with
`setup()`, `hook(stages, backend)`, `window(seconds, stages)` -> the
window's counts (`half` is the frames and seconds at the window's
midpoint, which shows the host's pace drift within a run), `trajectory()`
and `close()`, and two class attributes:

    views  what the runner hands the program of each frame, by the names
           of `traffic.Frames`' arrays: ("gray", "depth") for RGB-D,
           ("gray", "gray_r") for a rectified stereo pair. The harness
           renders the right view (`Frames.gray_r`) only for a runner
           that declares it; otherwise `gray_r` is None.
    kind   the family of the window's counts, which the metric readers
           (`ctx.kind`) and `spans.values` test: "chunked" (chunk after
           chunk, frames/s) or "live" (frame after frame, each frame's
           time). A runner that subclasses another keeps its family.

`program_config(doc)` builds the program's configuration from a
configuration file."""


def program_config(doc: dict):
    """The program's `SlamConfig` of a configuration file: every group of
    the file into the program's dataclass of that group."""
    from sgslam_tpu_torch import config as C
    from sgslam_tpu_torch.geometry.camera import Camera

    groups = {"orb": C.OrbConfig, "tracker": C.TrackerConfig,
              "matcher": C.MatcherConfig, "dynamic": C.DynamicConfig,
              "detector": C.DetectorConfig, "mapping": C.MappingConfig,
              "capacity": C.MapCapacity, "loop": C.LoopConfig,
              "mesh": C.MeshConfig}
    return C.SlamConfig(camera=Camera(**doc["camera"]),
                        depth_map_factor=doc["depth_map_factor"],
                        fps=doc["fps"],
                        **{k: cls(**doc[k]) for k, cls in groups.items()})
