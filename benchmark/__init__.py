"""The benchmark of sgslam_tpu_torch on one H100: `python3 -m benchmark.run`
(see run.py, and core.py for how a run finds its files by name)."""
