"""The entry kinds a configuration file names under `runner.kind`. Each
module has `Runner(doc, frames, device, capture)` (the configuration
file, the traffic's frames) with `setup()`, `hook(stages, backend)`,
`window(seconds, stages)` -> the window's counts (`half` is the frames
and seconds at the window's midpoint, which shows the host's pace drift
within a run), `trajectory()` and `close()`. `program_config(doc)` builds
the program's configuration from a configuration file."""


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
