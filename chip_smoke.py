#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`sgslam_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Phases, each of which fails the run if it fails:
  1. build every CUDA source of the port (`csrc/hamming.cu`, K1,
     `csrc/hamming_search.cu`, the fused search K1s,
     `csrc/segment_sum.cu`, the deterministic segment sum,
     `csrc/pose_opt.cu`, motion-only BA in one launch, and
     `csrc/fast_detect.cu`, FAST detection of a whole pyramid in one
     launch), one nvcc each, started together;
  2. hold K1 against its plain PyTorch version on the card at every shape
     that the phases' configurations give it: tracking and duplicate
     fusion (local points x keypoints) and triangulation (keypoints x
     keypoints) (exact equality); hold K1s, twice, against its plain
     version (K1 and the torch chain) to the bit at every
     call site's shape, window and mutual flag (`k1s_cases`), on inputs
     with planted edge cases (`ops/search_cases.py`), and check that a
     search allocates nothing near [Q, N];
  3. time K1, its plain version and one library call computing the same
     function (CUDA events around CUDA-graph replays, so that host time
     is not counted), against K1's bound (its output's bytes: the
     tensor-core route is faster than its work); time K1s, the chain it
     replaces and its bound (what the input needs) at the tracking, cull
     and triangulation shapes; hold the pose kernel against the plain
     body of `pose_optimization` on the card at track_step's two calls
     (stereo, mono and mixed rows; poses within 1e-5, inlier masks equal
     but for rows at the gate) and time both by CUDA-graph replay; hold
     the FAST kernel against the plain detection to the bit on both
     cameras' pyramids (640x480, 752x480) and two planted images at cells
     of 8, 16 and 32, with no host wait, count its launches on
     `tracking.extract_frame` (one a frame), and time it by CUDA-graph
     replay beside its bound (the levels' bytes) and the plain version;
  4. drive the main path at full width: 60 frames of the synthetic room at
     640x480 through `Tracker` with its defaults (1000 features, 1024
     keypoints, 4096 local points, the keyframe back-end after every
     keyframe), check the result against ground truth and that a back-end
     pass ran after every keyframe from the second on, and time extraction,
     tracking and each stage of the back-end pass;
  5. the back-end pass at full width on a real map: `eval_map.npz` (2176
     keypoints, 288 keyframe slots, 32768 points, window 16+8, 4096 local
     points) through `process_new_keyframe` on the card and through the
     port on the CPU; integer outputs equal, poses and points within the
     parity tests' tolerances; the card's three passes must be identical
     to the bit (the float scatter-adds are segment sums in a fixed order);
  6. capacity pressure at a smaller depth: 120 frames at 320x240 into 24
     keyframe slots, so that map compaction must fire;
  7. the semantic system at full width, the slice's main path:
     `sgslam_tpu_torch.run_eval`'s `dynamic_640_3walkers_fastrot` sequence
     and configuration (150 frames at 640x480, three walkers, fast
     rotation, rendered on the card by run_eval's `_render`)
     through `System(cfg, enable_loop=False).track_rgbd` with the shipped
     SSDLite detector, the dynamic-feature cull (one K1s launch per frame
     for the frame-to-frame matches), tracking with the back-end and the
     semantic mapper; checks state, ATE, person detections, K1s launches
     and the occupancy map, and times each stage with CUDA events;
  8. semantic objects at a smaller depth: tests/test_semantic_objects_live
     .py's run (24 frames at 320x240, people and props): an object of the
     database matches a prop by class within 0.5 m;
  9. card against the CPU: the detector on five phase-7 frames (TF32 off),
     the frame-to-frame match tables, and `reject_dynamic_matched` with the
     same RANSAC samples on both devices;
 10. bench.py's path at full width through the port's bench,
     `sgslam_tpu_torch.bench.run`: `ChunkedSemanticTracker(cfg,
     Detector2D, chunk=4, fetch_every=6, loop=LoopCloser(cfg))` on
     bench.py's schedule (6 bootstrap frames of the 640x480 walking-person
     scene, 12 warm chunks + flush untimed, 24 timed chunks + flush);
     checks state, inliers (bench.py's assert), ATE and K1s launches,
     prints the bench's JSON line (on a `[bench-path]` line), frames/s as
     bench.py computes it and the per-chunk stage times and per-keyframe
     loop-closing times (CUDA events);
 11. loop closing at full width: (a) run_eval's
     `static_640_circuit_2laps_stress` sequence (240 frames at 640x480,
     2.15 laps of the closed room), as rendered and with its images moved
     by one ulp (three seeds), through run_eval's System path
     (`make_system`, `drive_system`) and its chunked path
     (`ChunkedTracker(chunk=4, fetch_every=6, loop=LoopCloser)` from
     `make_chunked`, driven by `drive_chunked`): ATE < 0.05
     m as rendered (run_eval's gate), < 0.25 m moved, and on each path at
     least one run must close a loop and end under 0.05 m; one global-BA
     pass's time and peak memory at the default capacity; (b) the loop
     fixtures of tests/test_loop_e2e.py and tests/test_chunked_full_system
     .py at 640x480 (a drift injected before the revisit), through `System`
     and `ChunkedTracker`: each must close a loop and the System path must
     halve its keyframe ATE (`debug_stress.kf_ate`), with the essential
     graph, the fusion and each
     global-BA slice timed; the chunked run runs twice and must give the
     same keyframe poses and map points to the bit;
 12. relocalization at 320x240: tests/test_chunked_full_system.py's
     kidnap run through `ChunkedTracker`, as rendered and with its images
     moved by one ulp (four seeds): every run must relocalize, track again
     and land within 0.5 m of the map's own poses, and that test's pose
     gate (< 0.06 m) must hold on at least one run;
 13. stereo at full width: run_eval's `stereo_640_walk` (120 frames at
     640x480, pairs rendered on the card by `frame_stereo`) through
     run_eval's System path (`track_stereo`) and its chunked path
     (`ChunkedStereoTracker(chunk=4, fetch_every=6, loop=LoopCloser)`),
     both under run_eval's 0.04 m stereo gate, each
     stage timed and `stereo_match` alone; `ChunkedSemanticStereoTracker`
     at tests/test_chunked_parity.py's 320x240 (26 dynamic frames, 0.12 m
     gate); the stereo + mapper guard raises;
 14. monocular at full width: `System.monocular(cfg, ...)
     .track_monocular` over 30 frames of the room at 640x480 (default
     widths and capacity) under tests/test_mono_stereo.py's gates
     (initialized before frame 15, state OK, > 150 points, Sim(3)-aligned
     ATE < 0.06 m x max(span, 1)); `initialize_mono` timed alone and run
     again on the CPU on the same matches and draws;
 15. the dataset CLI on the card: `run_tum.main(["--synthetic", "60", ...])`
     per frame and `--chunked` (default flags, the `tum3` preset): the
     summary keys of `sgslam_tpu/run_tum.py`, ATE under run_eval's 0.03 m
     static gate, K1s launched on the card;
 16. scale-out at world size 1 on NCCL (a file rendezvous under build/):
     the port's dryrun of the multi-chip contract on `eval_map.npz` (points
     moved by 0.01 m, 8 LM iterations of the distributed global BA), whose
     cost must fall; ms per iteration, peak memory and the bytes handed to
     collectives; one distributed step on the card against the same step on
     the CPU (a gloo grid beside the NCCL one);
 17. detector training: 30 AdamW steps at batch 16 on the card
     (`train_detector.Trainer`), a finite loss that falls, ms per step; one
     step card against CPU on the same batch (TF32 off), the gradient gap
     read on two more seeds and batches, and with the localization term
     dropped on the card's side, which the limit must catch;
 18. the accuracy suite's entry point: `run_eval.main(["--only",
     "static_640_tum1_distortion", ...])` at full length (120 frames at
     640x480 on the TUM1-distorted camera, System and chunked paths):
     both ATEs under the row's 0.03 m gate, `parity_ok`, and K1s and the
     segment sum launched on each path;
 19. the measurement harnesses at reduced depth, each through its `main`
     on the card (`profile_chunk`, `bench_sweep`, `bench_kernels`,
     `bench_dist_ba` and `bench_dist_ba_realmap` at world size 1 on NCCL)
     and `entry()` once; their outputs well formed (keys, finite positive
     times, the card's name and power limit, the realmap cost falling) and
     K1s and the segment sum launched where they run (`phase_harnesses`
     lists the cuts);
  then the segment sum against its plain version (to the bit) at every
  call site and shape that phases 4-19 gave it (the first call of each is
  recorded), the lengths of its segments per phase and site, and its time
  (with the device time of each step of one call: sort, sum) at
  phase 10's most launched shape, at the shape with the longest segments
  and at the largest output (the global BA's); then print the whole-run
  values that a change of the kernels must leave alone (phases 7, 11a, 13
  and 18), the `kernels` line, the card's name and power limit, and last
  `{"ok": true, "device": ...}`.
K1s's and the segment sum's launch counts (and K1's) are set to 0 just
before each path of phases 4-8, 10-16, 18 and 19 (each run of 11 and 12,
each path of 13 and 18, both calls of 15, each harness of 19 that runs in
this process) and read just after; each path that runs the BA, the pose
graph or the mapper must have launched the segment sum. The `kernels`
line carries phase 10's counts (the timed window of bench.py's schedule),
where K1 must not launch: every search goes through K1s, and the FAST
kernel must launch at least once a frame. Phase 7's
`System` runs with loop closing on (its default), so its frame times
include the loop closer's keyframe database work.

It needs a CUDA device and the repository beside it; without either it
exits non-zero and prints no result. It imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

N_FRAMES = 60
ATE_GATE_M = 0.05
MIN_INLIERS = 30
# K1 shapes beyond the path's: an odd one and a self-distance check
K1_EXTRA_SHAPES = [(200, 333), (128, 128)]
# K1s cases beyond the path's, as (q, n, level window or None, mutual): a
# ragged column count, and the CPU tests' size with a window and mutual
K1S_EXTRA_CASES = [(1024, 1000, 1, False), (1024, 1000, None, True),
                   (300, 257, 7, True)]
# K1s's timed cases: tracking's search, the cull's, triangulation's
TOL_POSE_KERNEL = 1e-5          # the pose kernel against the plain body
CHI2_BAND_KERNEL = 1e-3         # rows this close to the gate may flip
K1S_TIMED = [(4096, 1024, 1, False), (1024, 1024, 1, False),
             (1024, 1024, None, True)]

EVAL_MAP = os.path.join("sgslam_tpu", "assets", "eval_map.npz")
# card vs CPU on the eval map's 16+8 window: the tolerances of
# tests/test_torch_local_ba.py (the BA rounds its point-block sums to bf16,
# so f32 summation order shows at the millimetre level)
TOL_WIN_POSE_T = 3e-3
TOL_WIN_POSE_Q = 5e-4
TOL_WIN_POINT_MEDIAN = 0.01
TOL_WIN_POINT_P95 = 0.1

LIVE_FRAMES = 120
LIVE_ATE_GATE_M = 0.08

SEM_FRAMES = 150
# the chunked runners' chunk and drain interval in phases 11-13: those of
# bench.py's schedule (`sgslam_tpu_torch.bench.CHUNK`, `FETCH_EVERY`)
BENCH_CHUNK, BENCH_FETCH = 4, 6
STRESS_FRAMES = 240              # run_eval.py's 2-lap stress circuit
STRESS_ATE_GATE_M = 0.05         # run_eval.py's stress gate
# phase 11a's other inputs: the stress circuit moved by one ulp; a moved
# run must stay within STRESS_SANE_M (one that lost the map lies metres off)
STRESS_MOVED_SEEDS = (0, 1, 2)
STRESS_SANE_M = 0.25
KIDNAP_FRAMES, KIDNAP_MAP, KIDNAP_TO = 88, 44, 6
# tests/test_chunked_full_system.py's post-relocalization pose gate, held
# on the rendered kidnap and four one-ulp moves of it; every run must land
# within a quarter of the kidnap's 1.9 m jump
RELOC_GATE_M = 0.06
RELOC_SANE_M = 0.5
RELOC_MOVED_SEEDS = (0, 1, 2, 3)
# the drift injections of tests/test_loop_e2e.py and
# tests/test_chunked_full_system.py (se3 twists at the newest keyframe)
FORCED_DRIFT_SYSTEM = (0.44, 0.0, 0.20, 0.0, 0.12, 0.0)
FORCED_DRIFT_CHUNKED = (0.66, 0.0, 0.30, 0.0, 0.18, 0.0)
STEREO_FRAMES = 120            # run_eval.py's stereo_640_walk
STEREO_GATE_M = 0.04           # run_eval.py's STEREO_GATE
# tests/test_chunked_parity.py::test_chunked_semantic_stereo
SEM_STEREO_FRAMES, SEM_STEREO_GATE_M = 26, 0.12
# tests/test_mono_stereo.py::test_mono_pipeline_e2e's run and gates
MONO_FRAMES, MONO_INIT_BEFORE, MONO_MIN_POINTS = 30, 15, 150
MONO_ATE_FACTOR = 0.06         # x max(span, 1 m), Sim(3)-aligned
CLI_FRAMES = 60
CLI_ATE_GATE_M = 0.03          # run_eval.py's STATIC_GATE
SEM_ATE_GATE_M = 0.05          # the EVAL dynamic gate (tools/run_eval.py)
MIN_PERSON_SHARE = 0.6
MIN_OCCUPIED_CELLS = 20
OBJ_FRAMES = 24
OBJ_MATCH_M = 0.5
# card vs CPU (phase 9): the detector with TF32 off, normalized boxes and
# scores; the cull within the reference's own one-ulp spread
# (tools/parity_spread.py cull: up to 64 keep flags, 7 F inliers)
TOL_DET_BOX = 1e-4
TOL_DET_SCORE = 1e-4
MAX_KEEP_FLIPS = 64
MAX_INLIER_GAP = 7
# phase 16: the dryrun's LM budget; one distributed step card vs CPU at the
# damping where the eval map's first step is accepted (three rejections of
# the default 1e-3, each x4): poses within 1e-4, points within 1e-3 m at the
# median (f32 reduced systems summed in other orders, then a 840 x 840
# solve)
SCALE_OUT_ITERS = 8
SCALE_OUT_STEP_LAM = 1e-3 * 4 ** 3
TOL_STEP_POSE = 1e-4
TOL_STEP_POINT_MEDIAN = 1e-3
# phase 17: detector training; card vs CPU on one batch (TF32 off): the
# loss within 1e-4 relative; gradients within 2e-2 of each tensor's largest
# entry (cuDNN's backward sums 16 x 150 x 150 products per stem entry in an
# order of its choosing, against oneDNN's on the CPU). Readings on the H100
# at seeds and batches (0, 0), (1, 3), (2, 6): 6.9e-3, 1.5e-3, 4.7e-4; with
# the localization term dropped on the card's side: 1.91. The limit sits
# between the two. AdamW given the same gradients within 2.5e-7
TRAIN_STEPS, TRAIN_BATCH = 30, 16
# phase 18: one sequence of the accuracy suite through `run_eval.main`
EVAL_SEQUENCE = "static_640_tum1_distortion"
EVAL_OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "eval_chip_smoke.json")
TRAIN_GRAD_READINGS = [(1, 3), (2, 6)]     # (seed, batch) beside (0, 0)
TOL_TRAIN_LOSS = 1e-4
TOL_TRAIN_GRAD = 2e-2
TOL_TRAIN_UPDATE = 2.5e-7
# phase 19: the measurement harnesses at reduced depth (cuts listed in
# `phase_harnesses`); the realmap bench keeps its default 4 LM iterations:
# the eval map's first three steps are rejected at the default damping, so
# fewer leave the cost where it was
HARNESS_PROFILE_REPS = 2
HARNESS_SWEEP_FRAMES = 30        # 6 bootstrap frames + 6 chunks of 4
HARNESS_KERNEL_REPS, HARNESS_KERNEL_K = 2, 2
HARNESS_REALMAP_ITERS = 4
HARNESS_OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build")


# whole-run values that a change of the kernels must leave to every
# printed digit (phases 7, 11a, 13 and 18), printed before the kernels line
WHOLE_RUN = {}


def _fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    return 1


def _segment_step(op: str) -> str:
    """Which step of the segment sum a device operation belongs to."""
    if "sum_rows" in op or "segments" in op:
        return "sum"
    if any(w in op for w in ("histogram", "sort_pass", "Radix", "Memset")):
        return "sort"
    return "other"


def phase_build():
    """Build every CUDA source at once (nvcc runs outside the GIL) and load
    K1, K1s, the segment sum, the pose kernel and the FAST kernel."""
    from sgslam_tpu_torch.ops import fast_cuda as fc
    from sgslam_tpu_torch.ops import hamming_cuda as hc
    from sgslam_tpu_torch.ops import hamming_search as hs
    from sgslam_tpu_torch.ops import pose_opt_cuda as po
    from sgslam_tpu_torch.ops import segment

    t0 = time.perf_counter()
    kernels = [hc.hamming_kernel, hs.hamming_search_kernel,
               segment.segment_kernel, po.pose_opt_kernel,
               fc.fast_detect_kernel]
    with ThreadPoolExecutor(len(kernels)) as pool:
        list(pool.map(lambda k: k.build(verbose=True), kernels))
    for k in kernels:
        k.load()
    print(f"[build] {', '.join(k.source.name for k in kernels)} built and "
          f"loaded in {time.perf_counter() - t0:.2f} s")


def _descs(rng, dev, n):
    import torch

    words = rng.integers(0, 2 ** 32, size=(n, 8), dtype=np.uint64)
    return torch.from_numpy(words.astype(np.uint32).view(np.int32)).to(dev)


def k1_shapes(cfgs):
    """K1's shapes on the paths of `cfgs`: local points x keypoints
    (tracking, duplicate fusion) and keypoints x keypoints
    (triangulation)."""
    shapes = []
    for cfg in cfgs:
        k = cfg.orb.max_keypoints
        for shape in ((cfg.capacity.local_points, k), (k, k)):
            if shape not in shapes:
                shapes.append(shape)
    return shapes


def phase_k1_parity(dev, rng, shapes) -> int:
    """K1 against its plain version at every shape of the path."""
    import torch

    from sgslam_tpu_torch.ops import hamming_cuda as hc

    max_err = 0
    for n, m in K1_EXTRA_SHAPES + shapes:
        a = _descs(rng, dev, n)
        b = a if n == m == 128 else _descs(rng, dev, m)
        out = hc.hamming_kernel(a, b)
        torch.cuda.synchronize()
        ref = hc.hamming_matrix_reference(a, b)
        err = int((out - ref).abs().max())
        max_err = max(max_err, err)
        if not torch.equal(out, ref):
            raise AssertionError(f"K1 differs from its plain version at "
                                 f"{n}x{m}: max |err| {err}")
        if n == m == 128 and bool((out.diagonal() != 0).any()):
            raise AssertionError("K1: nonzero self-distance")
        print(f"[parity] K1 {n}x{m}: exact (max |err| {err})")
    return max_err


def phase_k1_time(dev, rng, max_err: int, shapes):
    """Time K1 at the paths' shapes; its entry of the kernels line."""
    import torch

    from sgslam_tpu_torch.ops import hamming_cuda as hc
    from sgslam_tpu_torch.utils import timing

    for n, m in shapes:
        if (n, m) == (4096, 1024):
            continue
        a, b = _descs(rng, dev, n), _descs(rng, dev, m)
        ms = timing.graph_ms(lambda: hc.hamming_kernel(a, b), calls=20)
        bound = hc.hamming_bound(n, m)[0]
        print(f"[time] K1 {n}x{m}: kernel_ms={ms:.5f} bound_ms={bound:.5f}")

    # the tracking shape: 4096 local points x 1024 keypoints
    n, m = 4096, 1024
    a, b = _descs(rng, dev, n), _descs(rng, dev, m)
    call_ms = timing.event_ms(lambda: hc.hamming_kernel(a, b), runs=100)
    kernel_ms = timing.graph_ms(lambda: hc.hamming_kernel(a, b), calls=50)
    plain_ms = timing.graph_ms(lambda: hc.hamming_matrix_reference(a, b),
                               calls=5)
    ba, bb = hc.unpack_bits(a), hc.unpack_bits(b)
    lib = torch.cdist(ba, bb, p=0)
    if not torch.equal(lib.round().to(torch.int32),
                       hc.hamming_matrix_reference(a, b)):
        raise AssertionError("cdist yardstick disagrees with K1's function")
    library_ms = timing.graph_ms(lambda: torch.cdist(ba, bb, p=0), calls=5)
    bound_ms, bytes_ms, ops_ms = hc.hamming_bound(n, m)
    print(f"[time] K1 {n}x{m}: kernel_ms={kernel_ms:.5f} "
          f"bound_ms={bound_ms:.5f} (bytes {bytes_ms:.5f}, int8 tensor-core "
          f"ops {ops_ms:.5f}) plain_ms="
          f"{plain_ms:.5f} library_ms(cdist p=0)={library_ms:.5f} (device "
          f"times from CUDA-graph replay); one eager wrapper call between "
          f"events: {call_ms:.5f} ms")
    return {"name": "hamming_matrix", "route": "cuda",
            "source": "sgslam_tpu_torch/csrc/hamming.cu",
            "replaces": "sgslam_tpu/ops/pallas_hamming.py:34",
            "launches": 0, "max_abs_err": max_err, "ms": kernel_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": library_ms}


def path_configs():
    """The configurations of the paths that phases 4-19 drive."""
    from sgslam_tpu_torch import config, run_eval

    return [config.synthetic_config(640, 480), eval_config(),
            capacity_config(), run_eval._make_cfg(False), objects_config(),
            kidnap_config(), mono_config()]


def k1s_cases(cfgs):
    """K1s's call sites on the paths of `cfgs`, as (q, n, level window or
    None, mutual): tracking (local points x keypoints, window 1) and its
    brute-force fallback (mutual), duplicate fusion (local points x
    keypoints, window 7), the cull and loop closing's widening (keypoints
    x keypoints, window 1), triangulation and loop matching (keypoints x
    keypoints, mutual) and mono initialisation (not mutual); then
    K1S_EXTRA_CASES."""
    cases = []
    for cfg in cfgs:
        k, lp = cfg.orb.max_keypoints, cfg.capacity.local_points
        for case in ((lp, k, 1, False), (lp, k, 7, False),
                     (lp, k, None, True), (k, k, 1, False),
                     (k, k, None, True), (k, k, None, False)):
            if case not in cases:
                cases.append(case)
    return cases + [c for c in K1S_EXTRA_CASES if c not in cases]


def _k1s_label(lw, mutual):
    return (f"window {lw}" if lw is not None else "descriptor") + (
        ", mutual" if mutual else "")


def phase_k1s_parity(dev, cases=None) -> int:
    """K1s against its plain version (K1 and the torch chain) to the bit,
    best_idx, best, second and the column argmin, twice (the workspace
    must come back zeroed), at every case, on
    seeded inputs with every planted edge case (`ops/search_cases.py`,
    denormal windows included); then that a search at the tracking shape
    allocates nothing near [Q, N]."""
    import torch

    from sgslam_tpu_torch.ops import hamming_search as hs
    from sgslam_tpu_torch.ops.search_cases import search_args, search_case

    cases = cases or k1s_cases(path_configs())
    rng = np.random.default_rng(1)
    names = ("best_idx", "best", "second", "rbest")
    max_err = 0
    for q, n, lw, mutual in cases:
        label = f"{q}x{n} {_k1s_label(lw, mutual)}"
        args = search_args(search_case(rng, q, n, denormals=True), dev, lw)
        want = hs.hamming_search_reference(*args, mutual=mutual)
        if lw is not None and int(want[0][26]) == n - 10:
            raise AssertionError(f"K1s {label}: the plain version took the "
                                 "feature outside the denormal window")
        for _ in range(2):
            got = hs.hamming_search_kernel(*args, mutual=mutual)
            torch.cuda.synchronize()
            for name, g, w in zip(names, got, want):
                if w is None:
                    continue
                err = int((g.long() - w.long()).abs().max())
                max_err = max(max_err, err)
                if g.dtype != w.dtype or not torch.equal(g, w):
                    bad = int((g != w).sum())
                    raise AssertionError(
                        f"K1s {label}: {name} differs from its plain "
                        f"version in {bad} entries (max |err| {err})")
        print(f"[parity] K1s {label}: exact, twice (max |err| {max_err})")

    q, n = 4096, 1024
    args = search_args(search_case(rng, q, n), dev, 1)
    hs.hamming_search_kernel(*args)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    hs.hamming_search_kernel(*args)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated(dev) - base
    print(f"[parity] K1s {q}x{n}: a search allocates {extra} bytes (a "
          f"[Q, N] bool mask alone would be {q * n})")
    if extra >= q * n // 8:
        raise AssertionError(f"K1s allocated {extra} bytes at {q}x{n}")
    return max_err


def phase_k1s_time(dev, max_err: int = 0):
    """Time K1s, its plain chain and its bound at K1S_TIMED; its entry of
    the kernels line, at the tracking shape. The bound counts what the
    input needs: with a window every pair's window test and the
    candidates' distances (the dense count, every pair's distance, is
    printed beside it). No single PyTorch call computes the search:
    `library_ms` is null, and the chain is the number it replaces."""
    from sgslam_tpu_torch.ops import hamming_search as hs
    from sgslam_tpu_torch.ops.search_cases import search_args, search_case
    from sgslam_tpu_torch.utils import timing

    rng = np.random.default_rng(2)
    kern = hs.hamming_search_kernel
    entry = None
    for q, n, lw, mutual in K1S_TIMED:
        args = search_args(search_case(rng, q, n, edge=False), dev, lw)
        ms = timing.graph_ms(lambda: kern(*args, mutual=mutual), calls=50)
        chain_ms = timing.graph_ms(
            lambda: hs.hamming_search_reference(*args, mutual=mutual),
            calls=5)
        dense_ms = hs.search_bound(q, n, mutual, lw is not None)[0]
        n_cand = (int(hs.candidates(args[1], args[3], args[4]).sum())
                  if lw is not None else None)
        bound_ms, bytes_ms, ops_ms = hs.search_bound(q, n, mutual,
                                                     lw is not None, n_cand)
        print(f"[time] K1s {q}x{n} {_k1s_label(lw, mutual)}: kernel_ms="
              f"{ms:.5f} bound_ms={bound_ms:.5f} (bytes {bytes_ms:.5f}, "
              f"operations {ops_ms:.5f}"
              + (f": every pair's window test and the {n_cand} candidates' "
                 f"distances; every pair's distance on the tensor cores "
                 f"{dense_ms:.5f}" if n_cand is not None else
                 ": every pair's distance on the tensor cores")
              + f"); the chain it replaces (K1 + torch masks and "
              f"reductions) {chain_ms:.5f} ms (device times from CUDA-graph "
              f"replay)")
        if entry is None:
            call_ms = timing.event_ms(lambda: kern(*args, mutual=mutual),
                                      runs=100)
            print(f"[time] K1s {q}x{n}: one eager wrapper call between "
                  f"events: {call_ms:.5f} ms")
            entry = {"name": "hamming_search", "route": "cuda",
                     "source": "sgslam_tpu_torch/csrc/hamming_search.cu",
                     "replaces": "sgslam_tpu/ops/pallas_hamming.py:34",
                     "launches": 0, "max_abs_err": max_err, "ms": ms,
                     "plain_ms": chain_ms, "bound_ms": bound_ms,
                     "bound_by": "operations" if ops_ms >= bytes_ms
                     else "bytes", "library_ms": None}
    return entry


def pose_opt_cases():
    """track_step's two pose optimizations at the tracking configuration's
    shape, as (name, n, rounds, iters, guarded)."""
    from sgslam_tpu_torch import config

    cfg = config.synthetic_config(640, 480)
    t, n = cfg.tracker, cfg.capacity.local_points
    return [("stage1", n, t.pose_opt_rounds_stage1, t.pose_opt_iters_stage1,
             False),
            ("stage2", n, t.pose_opt_rounds_stage2, t.pose_opt_iters_stage2,
             False)]


def phase_pose_opt(dev):
    """The pose kernel against the plain body of `pose_optimization` on the
    card at track_step's two calls, on seeded stereo, mono and mixed rows
    (`ops/pose_cases.py`): poses within TOL_POSE_KERNEL, inlier masks equal
    but for rows whose chi2 lies within CHI2_BAND_KERNEL of the gate, each
    call one launch and repeated to the bit. Then both timed by graph
    replay, with the plain chain's device operations per call; the kernels
    line's `pose_opt` entry. The kernel is latency-bound by design (one
    block, serial iterations): the entry has no byte or operation bound."""
    import torch

    from sgslam_tpu_torch.ops import pose_cases
    from sgslam_tpu_torch.ops import pose_opt_cuda as po
    from sgslam_tpu_torch.optim import pose_opt
    from sgslam_tpu_torch.utils import timing

    cam = pose_cases.camera()
    rng = np.random.default_rng(3)
    max_err = 0.0
    for name, n, rounds, iters, guarded in pose_opt_cases():
        kw = dict(rounds=rounds, iters=iters, guarded=guarded)
        for mix in ("stereo", "mono", "mixed"):
            case = pose_cases.pose_case(rng, n, mix)
            args = pose_cases.pose_args(case, dev)
            before = po.pose_opt_kernel.launches
            got = [pose_opt.pose_optimization(cam, *args, **kw)
                   for _ in range(2)]
            want = pose_opt.pose_optimization_reference(cam, *args, **kw)
            torch.cuda.synchronize()
            if po.pose_opt_kernel.launches - before != 2 or not all(
                    torch.equal(a, b) for a, b in zip(*got)):
                raise AssertionError(f"pose kernel {name} {mix}: not one "
                                     "launch a call, or two calls differ")
            T, inl, cnt = got[0]
            err = float((T - want[0]).abs().max())
            max_err = max(max_err, err)
            chi2, gate = pose_cases.chi2(case, want[0])
            differ = (inl != want[1]).cpu().numpy()
            near = np.abs(chi2 - gate) < CHI2_BAND_KERNEL
            print(f"[parity] pose kernel {name} ({n} rows, {rounds}x{iters}, "
                  f"{mix}): pose gap {err:.3e}, inliers {int(cnt)} / plain "
                  f"{int(want[2])}, {int(differ.sum())} flags differ "
                  f"({int(near.sum())} rows at the gate)")
            if not err <= TOL_POSE_KERNEL or (differ & ~near).any() \
                    or int(cnt) != int(inl.sum()):
                raise AssertionError(f"pose kernel {name} {mix}: pose gap "
                                     f"{err:.3e} or inlier flags away from "
                                     "the gate differ")

    entry = None
    for name, n, rounds, iters, guarded in pose_opt_cases():
        args = pose_cases.pose_args(pose_cases.pose_case(rng, n, "mixed"),
                                    dev)
        kw = dict(rounds=rounds, iters=iters, guarded=guarded)
        call = lambda: pose_opt.pose_optimization(cam, *args, **kw)
        plain = lambda: pose_opt.pose_optimization_reference(cam, *args,
                                                             **kw)
        ms = timing.graph_ms(call, calls=20)
        plain_ms = timing.graph_ms(plain, calls=1)
        plain_ops = sum(c for _, c, _ in timing.device_ops(plain, 2))
        call_ms = timing.event_ms(call, runs=50)
        print(f"[time] pose kernel {name} ({n} rows, {rounds}x{iters}): "
              f"kernel_ms={ms:.5f}; the plain chain {plain_ms:.5f} ms "
              f"({plain_ops:.0f} device operations a call; device times "
              f"from CUDA-graph replay); one eager pose_optimization call "
              f"between events {call_ms:.5f} ms")
        if entry is None:
            entry = {"name": "pose_opt", "route": "cuda",
                     "source": "sgslam_tpu_torch/csrc/pose_opt.cu",
                     "replaces": "sgslam_tpu/optim/pose_opt.py (XLA ops; "
                                 "no Pallas kernel)",
                     "launches": 0, "max_abs_err": max_err, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": None,
                     "bound_by": "latency", "library_ms": None}
    return entry


def fast_images(dev):
    """The FAST kernel's inputs: a rendered frame of each camera the
    benchmark runs (the RGB-D 640x480 and the stereo rig's 752x480 left
    view) and, at 640x480, an image of five grey values (plateaus and many
    equal scores) and the same with a NaN patch, as (label, image)."""
    import torch

    from sgslam_tpu_torch import config
    from sgslam_tpu_torch.io import synthetic as syn

    out = []
    for w, h in ((640, 480), (752, 480)):
        cam = config.synthetic_config(w, h).camera
        gray, _ = syn.render_frame(cam, syn.make_trajectory(30, dev)[7])
        out.append((f"rendered {w}x{h}", gray.to(torch.float32)))
    rng = np.random.default_rng(5)
    flat = torch.from_numpy((np.round(rng.random((480, 640)) * 4) / 4)
                            .astype(np.float32)).to(dev)
    out.append(("five grey values 640x480", flat))
    nan = flat.clone()
    nan[100:103, 200:230] = float("nan")
    out.append(("NaN patch 640x480", nan))
    return out


def phase_fast_detect(dev):
    """The FAST kernel against the plain detection
    (`orb.detect_cells_reference`) on the card, on both cameras' pyramids
    and two planted images, at cells of 8, 16 and 32: every bit of the
    cell scores and indices equal, one launch a call, no host wait. Then
    the main path's front end (`tracking.extract_frame`) on 8 frames of
    each camera: one launch a frame, `fast.kernel` equal to `fast.calls`,
    and the device operations of one extraction. Then its time by graph
    replay beside its bound (the levels' bytes read once, the outputs
    written once) and the plain version's device operations and time; the
    kernels line's `fast_detect` entry."""
    import torch

    from sgslam_tpu_torch import config
    from sgslam_tpu_torch.io import synthetic as syn
    from sgslam_tpu_torch.ops import fast_cuda as fc
    from sgslam_tpu_torch.ops import image, orb
    from sgslam_tpu_torch.slam import tracking
    from sgslam_tpu_torch.utils import timing

    orb_cfg = config.synthetic_config().orb
    thr = orb_cfg.fast_min_threshold / 255.0

    pyramids = [(label, image.build_pyramid(img, orb_cfg.n_levels,
                                            orb_cfg.scale_factor))
                for label, img in fast_images(dev)]
    for label, levels in pyramids:
        for cell in (8, 16, 32):
            before = fc.fast_detect_kernel.launches
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                got = [orb.detect_cells(levels, cell, thr) for _ in range(2)]
            finally:
                torch.cuda.set_sync_debug_mode(0)
            want = orb.detect_cells_reference(levels, cell, thr)
            torch.cuda.synchronize()
            same = all(a.dtype == b.dtype and torch.equal(
                a.view(torch.int32) if a.dtype == torch.float32 else a,
                b.view(torch.int32) if b.dtype == torch.float32 else b)
                for run in got for a, b in zip(run, want))
            kept = int((want[0] > 0).sum())
            print(f"[parity] FAST kernel, {label}, cell {cell}: "
                  f"{want[0].numel()} cells, {kept} with a corner: "
                  f"{'every bit equal' if same else 'DIFFERS'}")
            if fc.fast_detect_kernel.launches - before != 2 or not same:
                raise AssertionError(f"FAST kernel {label} cell {cell}: not "
                                     "one launch a call, or a bit differs "
                                     "from the plain detection")

    for w, h in ((640, 480), (752, 480)):
        cfg = config.synthetic_config(w, h)
        poses = syn.make_trajectory(8, dev)
        grays = [syn.render_frame(cfg.camera, poses[i]) for i in range(8)]
        m = timing.Metrics()
        before = fc.fast_detect_kernel.launches
        with timing.tracing(m):
            for gray, depth in grays:
                tracking.extract_frame(cfg, gray, depth, dev)
        torch.cuda.synchronize()
        launches = fc.fast_detect_kernel.launches - before
        ops = timing.device_ops(
            lambda: tracking.extract_frame(cfg, *grays[0], dev), reps=3)
        print(f"[fast] tracking.extract_frame at {w}x{h}: {launches} FAST "
              f"launches in 8 frames, fast.calls {m.counters['fast.calls']},"
              f" fast.kernel {m.counters['fast.kernel']}; "
              f"{sum(c for _, c, _ in ops):.0f} device operations a frame")
        if not (launches == m.counters["fast.calls"]
                == m.counters["fast.kernel"] == 8):
            raise AssertionError(f"extract_frame at {w}x{h}: {launches} "
                                 f"FAST launches, counts {dict(m.counters)}")

    entry = None
    for label, levels in pyramids[:2]:
        cell = orb_cfg.cell_size
        shapes = [tuple(t.shape) for t in levels]
        call = lambda: orb.detect_cells(levels, cell, thr)
        ms = timing.graph_ms(call, calls=20)
        bound_ms = fc.fast_detect_bound(shapes, cell)
        plain = lambda: orb.detect_cells_reference(levels, cell, thr)
        plain_ops = timing.device_ops(plain, reps=3)
        plain_dev_ms = sum(us for _, _, us in plain_ops) / 1e3
        plain_ms = timing.event_ms(plain, runs=20)
        print(f"[time] FAST kernel, {label} (8 levels, cell {cell}): "
              f"kernel_ms={ms:.5f} (CUDA-graph replay), bound {bound_ms:.5f}"
              f" ms ({100 * bound_ms / ms:.1f}% of it reached); the plain "
              f"detection {sum(c for _, c, _ in plain_ops):.0f} device "
              f"operations, {plain_dev_ms:.5f} ms of device time, "
              f"{plain_ms:.5f} ms a call between events")
        if entry is None:
            entry = {"name": "fast_detect", "route": "cuda",
                     "source": "sgslam_tpu_torch/csrc/fast_detect.cu",
                     "replaces": "sgslam_tpu/ops/fast.py and orb.py's "
                                 "_detect_level (XLA ops; no Pallas kernel)",
                     "launches": 0, "max_abs_err": 0.0, "ms": ms,
                     "plain_ms": plain_dev_ms, "bound_ms": bound_ms,
                     "bound_by": "bytes", "library_ms": None}
    return entry


class SegmentInputs:
    """Stands in for `ops.segment.segment_kernel` for the whole run: every
    call goes to the kernel (which counts its launches). Per phase and call
    site it counts the calls and, on the card without a host read, the
    segments' lengths (the longest, and how many fall in each power of
    two); the inputs of the first call of each site and shape are kept for
    `phase_segment`."""

    BUCKETS = 24

    def __init__(self, kernel):
        self.kernel = kernel
        self.phase = "-"
        self.inputs = {}
        self.calls = {}
        self.lengths = {}

    @property
    def launches(self):
        return self.kernel.launches

    @launches.setter
    def launches(self, value):
        self.kernel.launches = value

    def load(self, verbose: bool = False):
        return self.kernel.load(verbose)

    def __call__(self, values, index, n, init=None):
        import torch

        code = sys._getframe(2).f_code      # the caller of segment_sum
        root = os.path.dirname(os.path.abspath(__file__))
        site = f"{os.path.relpath(code.co_filename, root)}:{code.co_name}"
        key = (site, tuple(values.shape), n, init is not None)
        pk = (self.phase, site)
        self.calls[pk] = self.calls.get(pk, 0) + 1
        self.calls[(self.phase, key)] = self.calls.get((self.phase, key),
                                                       0) + 1
        if key not in self.inputs:
            self.inputs[key] = (self.phase, values.clone(), index.clone(), n,
                                None if init is None else init.clone())
        idx = torch.where((index >= 0) & (index < n), index.long(), n)
        cnt = torch.zeros(n + 1, dtype=torch.int64, device=index.device)
        cnt = cnt.scatter_add_(0, idx, torch.ones_like(idx))[:n]
        bucket = torch.floor(torch.log2(cnt.clamp(min=1).double())).long()
        hist, longest = self.lengths.get(pk, (None, None))
        if hist is None:
            hist = torch.zeros(self.BUCKETS, dtype=torch.int64,
                               device=index.device)
            longest = torch.zeros((), dtype=torch.int64, device=index.device)
        hist = hist.scatter_add_(0, bucket.clamp(max=self.BUCKETS - 1),
                                 (cnt > 0).long())
        self.lengths[pk] = (hist, torch.maximum(longest, cnt.max()))
        return self.kernel(values, index, n, init)


def check_segment_sum(kernel, v, i, n: int, init, label: str) -> tuple:
    """Launch the segment-sum `kernel` twice on these inputs, hold both
    outputs to the plain version on the same inputs copied to the CPU (to
    the bit) and to each other, print the result with the gap to the plain
    version on the card (which sums short segments through atomics) and
    fail if they differ. Returns (max abs error, longest segment)."""
    import torch

    from sgslam_tpu_torch.ops import segment

    out = kernel(v, i, n, init)
    again = kernel(v, i, n, init)
    torch.cuda.synchronize()
    ref = segment.segment_sum_reference(
        v.cpu(), i.cpu(), n, None if init is None else init.cpu())
    plain = segment.segment_sum_reference(v, i, n, init)
    err = float((out.cpu() - ref).abs().max()) if ref.numel() else 0.0
    keep = i[(i >= 0) & (i < n)]
    seg_max = int(torch.bincount(keep.long()).max()) if keep.numel() else 0
    same = torch.equal(out, again) and torch.equal(out.cpu(), ref)
    print(f"[segment] {label}: values {tuple(v.shape)} -> {n} rows"
          f"{' onto init' if init is not None else ''}, longest segment "
          f"{seg_max}: repeat {torch.equal(out, again)}, equal to the "
          f"plain version on the CPU {torch.equal(out.cpu(), ref)}, the "
          f"plain version on the card within "
          f"{float((out - plain).abs().max()) if out.numel() else 0:.3g}")
    if not same:
        raise AssertionError(f"segment sum differs at {label}")
    return err, seg_max


def time_segment_sum(dev, kernel, v, i, n: int, init, label: str) -> dict:
    """Time one call of the segment-sum `kernel` on these inputs (CUDA-graph
    replay) beside its bound, its plain version and the library calls
    (`index_add_`: atomics; `index_put_` with accumulate: a sort), print
    it with the device time of each step of one eager call (torch.profiler)
    and return the kernels line's timing fields."""
    import torch

    from sgslam_tpu_torch.ops import segment
    from sgslam_tpu_torch.utils import timing

    # the library calls, the dropped rows sent to a spare row
    spare = torch.where((i >= 0) & (i < n), i, n).long()
    base = torch.zeros((n + 1,) + tuple(v.shape[1:]), dtype=v.dtype,
                       device=dev)
    if init is not None:
        base[:n] = init
    lib_out = base.clone()

    def index_add():
        lib_out.copy_(base).index_add_(0, spare, v)

    def index_put():
        lib_out.copy_(base).index_put_((spare,), v, accumulate=True)

    put = [base.clone().index_put_((spare,), v, accumulate=True)
           for _ in range(3)]
    put_repeats = all(torch.equal(put[0], p) for p in put[1:])
    del put
    ms = timing.graph_ms(lambda: kernel(v, i, n, init), calls=20)
    ops = timing.device_ops(lambda: kernel(v, i, n, init))
    plain_ms = timing.event_ms(
        lambda: segment.segment_sum_reference(v, i, n, init), runs=20)
    library_ms = timing.graph_ms(index_add, calls=20)
    put_ms = timing.event_ms(index_put, runs=3, warmup=1)   # slow: eager
    del base, lib_out
    bound_ms, bytes_ms, ops_ms = segment.segment_bound(v, i, n, init)
    kept = int(((i >= 0) & (i < n)).sum())
    print(f"[segment] time at {label}, values {tuple(v.shape)} "
          f"{str(v.dtype)[6:]}, index {str(i.dtype)[6:]}, {kept} of "
          f"{v.shape[0]} rows kept -> {n} rows"
          f"{' onto init' if init is not None else ''}: ms={ms:.5f} (one "
          f"wrapper call: sort, sum; CUDA-graph replay) "
          f"bound_ms={bound_ms:.5f} (bytes {bytes_ms:.5f}, adds "
          f"{ops_ms:.5f}) plain_ms={plain_ms:.5f} (eager; its masks "
          f"read back) library_ms(index_add_)={library_ms:.5f} "
          f"index_put_(accumulate=True)={put_ms:.5f} (three calls "
          f"identical: {put_repeats})")
    steps = {}
    for op, n_ops, us in ops:
        step = _segment_step(op)
        steps[step] = steps.get(step, 0.0) + us / 1e3
    print(f"[segment]   device ms per step of one eager call "
          f"(torch.profiler): "
          + ", ".join(f"{st} {x:.5f}" for st, x in steps.items())
          + f"; total {sum(steps.values()):.5f}, beside bound_ms "
          f"{bound_ms:.5f} and index_add_ {library_ms:.5f}")
    for op, n_ops, us in ops:
        print(f"[segment]     {us / 1e3:.5f} ms x{n_ops:g} "
              f"{_segment_step(op)}: {op[:100]}")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": library_ms}


def phase_segment(dev, rec: SegmentInputs, launches: int):
    """The segment sum against its plain version at every site and shape
    the run gave it (to the bit, on the same inputs copied to the CPU; the
    plain version on the card sums short segments through atomics, so its
    gap is printed), the segments' lengths per phase and site, and its time,
    bound, plain and library times, with the device time of each step of
    one call (sort, sum), at phase 10's most launched shape, at the
    shape with the longest segments and at the one with the largest output
    (the global BA's). Returns its entry of the kernels line."""
    k = rec.kernel
    print("[segment] segment lengths per phase and call site (calls; "
          "longest; segments of 1, 2-3, 4-7, ... rows):")
    for (phase, site), (hist, longest) in rec.lengths.items():
        h = hist.cpu().tolist()
        while h and h[-1] == 0:
            h.pop()
        print(f"[segment]   phase {phase} {site}: {rec.calls[(phase, site)]} "
              f"calls; longest {int(longest)}; {h}")
    max_err, longest_key, longest_len = 0.0, None, -1
    for key, (phase, v, i, n, init) in rec.inputs.items():
        err, seg_max = check_segment_sum(
            k, v, i, n, init, f"{key[0]} (first in phase {phase})")
        max_err = max(max_err, err)
        if seg_max > longest_len:
            longest_key, longest_len = key, seg_max

    shapes = [(phase, key, c) for (phase, key), c in rec.calls.items()
              if isinstance(key, tuple)]
    bench = [x for x in shapes if x[0] == "10"] or shapes
    phase, top, calls = max(bench, key=lambda x: x[2])

    def timing(key, label):
        return time_segment_sum(dev, k, *rec.inputs[key][1:],
                                f"{label}, {key[0]}")

    t = timing(top, f"phase {phase}'s most launched shape ({calls} calls)")
    if longest_key is not None and longest_key != top:
        timing(longest_key, f"the longest segments ({longest_len} rows)")
    widest = max(rec.inputs, key=lambda key: key[2] * int(np.prod(key[1][1:])))
    if widest not in (top, longest_key):
        timing(widest, "the largest output")
    return {"name": "segment_sum", "route": "cuda",
            "source": "sgslam_tpu_torch/csrc/segment_sum.cu",
            "replaces": "sgslam_tpu/optim/local_ba.py:186",
            "launches": launches, "max_abs_err": max_err, **t}


def _zero_counts():
    """Set K1's, K1s's, the segment sum's, the pose kernel's and the FAST
    kernel's launch counts to 0 before a path."""
    from sgslam_tpu_torch.ops import fast_cuda as fc
    from sgslam_tpu_torch.ops import hamming_cuda as hc
    from sgslam_tpu_torch.ops import hamming_search as hs
    from sgslam_tpu_torch.ops import pose_opt_cuda as po
    from sgslam_tpu_torch.ops import segment

    hc.hamming_kernel.launches = 0
    hs.hamming_search_kernel.launches = 0
    po.pose_opt_kernel.launches = 0
    fc.fast_detect_kernel.launches = 0
    segment.segment_kernel.launches = 0


def _k1s_launches() -> int:
    """K1s's launches since `_zero_counts`: one per association search on
    the card."""
    from sgslam_tpu_torch.ops import hamming_search as hs

    return hs.hamming_search_kernel.launches


def _segment_count(path: str, least: int = 1) -> int:
    """Read the segment sum's launch count just after a path, print it,
    and fail if it is below `least` (every path that runs the BA, the pose
    graph, the mapper or a keyframe's bag of words launches it)."""
    from sgslam_tpu_torch.ops import segment

    n = segment.segment_kernel.launches
    print(f"[segment] {path}: {n} launches")
    if n < least:
        raise AssertionError(f"{path}: the segment sum launched {n} times")
    return n


class StageTimer:
    """`Tracker.on_backend_stage` / `process_new_keyframe(on_stage=)` /
    `System.on_stage`: a CUDA event at the start of each back-end pass (or
    frame) and after each of its stages."""

    def __init__(self):
        self.passes = []

    def __call__(self, name):
        import torch

        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        if name == "begin":
            self.passes.append([])
        self.passes[-1].append((name, ev))

    def ordered(self):
        """[[(stage, ms), ...]], one list per pass, the stages in order (a
        stage may repeat, as the global BA's slices do)."""
        import torch

        torch.cuda.synchronize()
        return [[(name, a.elapsed_time(b))
                 for (_, a), (name, b) in zip(ev, ev[1:])]
                for ev in self.passes]

    def groups(self):
        """[{stage: ms}], one dict per pass (or frame)."""
        return [dict(p) for p in self.ordered()]

    @classmethod
    def loop_correction(cls, metrics):
        """A StageTimer fed by a tracer's `loop.*` spans (the tracer is
        switched on): "begin" as `loop.correct` opens, then after its
        "essential_graph", "fuse" and each "gba" slice."""
        timer, inside = cls(), [False]

        def listen(name, opening):
            if name == "loop.correct":
                inside[0] = opening
                if opening:
                    timer("begin")
            elif inside[0] and not opening and name in (
                    "loop.essential_graph", "loop.fuse", "loop.gba"):
                timer(name[len("loop."):])

        metrics.listeners.append(listen)
        metrics.start()
        return timer

    def split(self):
        """(median ms of the whole pass, {stage: median ms}) over passes."""
        groups = self.groups()
        stages = {}
        for g in groups:
            for name, ms in g.items():
                stages.setdefault(name, []).append(ms)
        return (float(np.median([sum(g.values()) for g in groups])),
                {k: float(np.median(v)) for k, v in stages.items()})


def _split_text(stages):
    return ", ".join(f"{k} {v:.3f}" for k, v in stages.items())


def _ate_cw(est_cw, gt_wc):
    """run_eval's ATE, after checking that the trajectory is whole (one
    pose per ground-truth frame) and finite."""
    from sgslam_tpu_torch import run_eval

    est = np.asarray(est_cw)
    if est.shape != (len(gt_wc), 7) or not np.isfinite(est).all():
        raise AssertionError(f"trajectory {est.shape} not finite")
    return run_eval.ate_cw(est, gt_wc)


def _ate(tracker, gt_wc):
    return _ate_cw(tracker.poses_cw(), gt_wc)


def phase_main_path(dev, kernels, cfg=None, n_frames=N_FRAMES):
    """Track full-width frames through the port's default `Tracker`, the
    keyframe back-end on."""
    import torch

    from sgslam_tpu_torch import config
    from sgslam_tpu_torch.io import synthetic
    from sgslam_tpu_torch.slam import tracking

    cfg = cfg or config.synthetic_config(640, 480)
    seq = synthetic.SyntheticSequence(cfg.camera, n_frames=n_frames,
                                      device=dev)
    frames = [seq.frame(i) for i in range(n_frames)]
    torch.cuda.synchronize()
    tr = tracking.Tracker(cfg, device=dev)
    timer = StageTimer()
    tr.on_backend_stage = timer

    _zero_counts()
    extract_ms, track_ms, kf_track_ms = [], [], []
    t_run = time.perf_counter()
    for i, (gray, depth) in enumerate(frames):
        t0 = time.perf_counter()
        feats = tracking.extract_frame(cfg, gray, depth, device=dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        n_pass = len(timer.passes)
        tr.process(None, None, feats=feats)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        extract_ms.append((t1 - t0) * 1e3)
        if i > 0:
            (kf_track_ms if len(timer.passes) > n_pass
             else track_ms).append((t2 - t1) * 1e3)
    run_s = time.perf_counter() - t_run
    launches = _k1s_launches()
    kernels["hamming_search"]["launches"] = launches
    _segment_count("phase 4, Tracker")

    tracked = len(tr.n_inliers_hist)
    passes = len(timer.passes)
    rmse = _ate(tr, seq.poses.cpu().numpy())
    min_inl = min(tr.n_inliers_hist)
    pass_ms, stages = timer.split()
    print(f"[main] {n_frames} frames {cfg.camera.width}x{cfg.camera.height} "
          f"in {run_s:.2f} s: state {tr.state}, {tr.n_kf} keyframes, "
          f"{passes} back-end passes, {tr.compactions} compactions, "
          f"{int(tr.map.pt_valid.sum())} live map points, {tracked} tracked "
          f"frames, min inliers {min_inl}, ATE {rmse:.5f} m, K1s launches "
          f"{launches} ({launches / max(tracked, 1):.2f}/frame)")
    print(f"[main] per frame (median, synchronized): extract_frame "
          f"{np.median(extract_ms):.3f} ms, track (Tracker.process on "
          f"extracted features, no keyframe) {np.median(track_ms):.3f} ms, "
          f"Tracker.process with a back-end pass "
          f"{np.median(kf_track_ms) if kf_track_ms else float('nan'):.3f} ms")
    print(f"[main] back-end pass (median over {passes}, CUDA events): "
          f"{pass_ms:.3f} ms = {_split_text(stages)}")
    if tr.state != "OK":
        raise AssertionError(f"tracker state {tr.state}")
    if min_inl < MIN_INLIERS:
        raise AssertionError(f"inliers collapsed to {min_inl}")
    if not rmse < ATE_GATE_M:
        raise AssertionError(f"ATE {rmse:.4f} m >= {ATE_GATE_M} m")
    if passes != tr.n_kf - 1 or passes < 1:
        raise AssertionError(f"{passes} back-end passes for {tr.n_kf} "
                             "keyframes (expected one per keyframe after "
                             "the first)")
    if launches < 2 * tracked + 2 * passes:
        raise AssertionError(
            f"K1s launched {launches} times for {tracked} tracked frames and "
            f"{passes} back-end passes (expected >= 2 each)")


def eval_config():
    """tools/build_eval_map.py's configuration."""
    from sgslam_tpu_torch import config

    return config.synthetic_config(
        width=640, height=480,
        orb=config.OrbConfig(n_features=2048, max_keypoints=2176),
        tracker=config.TrackerConfig(max_frames_between_kf=2,
                                     depth_threshold_factor=150.0),
        capacity=config.MapCapacity(max_keyframes=288, max_points=32768,
                                    local_window=16, local_points=4096))


def phase_eval_map(dev, runs: int = 3):
    """One back-end pass at the eval map's newest keyframe, on the card and
    through the port on the CPU; the card's passes must repeat."""
    import torch

    import dataclasses

    from sgslam_tpu_torch.io import checkpoint
    from sgslam_tpu_torch.ops import segment
    from sgslam_tpu_torch.slam import tracking

    cfg = eval_config()
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), EVAL_MAP)
    m_dev, _ = checkpoint.load_map(path, device=dev)
    m_cpu, _ = checkpoint.load_map(path, device="cpu")
    kf = int(torch.nonzero(m_cpu.kf_valid).max())

    _zero_counts()
    timer = StageTimer()
    outs = []
    for _ in range(runs):     # the first run includes first-use set-up
        outs.append(tracking.process_new_keyframe(cfg, m_dev, kf,
                                                  on_stage=timer))
    torch.cuda.synchronize()
    out = outs[-1]
    launches = _k1s_launches()
    seg_launches = segment.segment_kernel.launches
    differ = [f.name for f in dataclasses.fields(out) for o in outs[:-1]
              if not torch.equal(getattr(o, f.name), getattr(out, f.name))]
    first_ms = timer.passes[0][0][1].elapsed_time(timer.passes[0][-1][1])
    timer.passes = timer.passes[1:]
    pass_ms, stages = timer.split()
    t0 = time.perf_counter()
    ref = tracking.process_new_keyframe(cfg, m_cpu, kf)
    cpu_s = time.perf_counter() - t0
    got = out.to("cpu")

    for name in ("kf_valid", "pt_valid", "kf_obs_point", "next_pt",
                 "next_kf"):
        if not torch.equal(getattr(got, name), getattr(ref, name)):
            raise AssertionError(f"eval map: {name} differs between the "
                                 "card and the CPU")
    dt = float((got.kf_pose[:, 4:] - ref.kf_pose[:, 4:]).abs().max())
    dq = float((got.kf_pose[:, :4] - ref.kf_pose[:, :4]).abs().max())
    moved = ref.pt_valid & ((got.pt_pos != m_cpu.pt_pos).any(1)
                            | (ref.pt_pos != m_cpu.pt_pos).any(1))
    d = torch.linalg.vector_norm(got.pt_pos - ref.pt_pos, dim=1)[moved]
    d = d.numpy()
    print(f"[eval-map] keyframe {kf}: {int(m_cpu.kf_valid.sum())} -> "
          f"{int(got.kf_valid.sum())} keyframes, {int(m_cpu.pt_valid.sum())} "
          f"-> {int(got.pt_valid.sum())} points, K1s launches {launches}, "
          f"segment-sum launches {seg_launches} in {runs} passes; the "
          f"passes' maps identical to the bit: {not differ}")
    print(f"[eval-map] back-end pass on the card (CUDA events, median of "
          f"{runs - 1} after a first of {first_ms:.3f} ms): {pass_ms:.3f} "
          f"ms = {_split_text(stages)}; the port on the CPU {cpu_s:.2f} s")
    print(f"[eval-map] card vs CPU: integer outputs equal; poses "
          f"{dt:.3g} m, quaternion {dq:.3g}; {len(d)} moved points: median "
          f"{np.median(d):.3g} m, p95 {np.percentile(d, 95):.3g} m, max "
          f"{d.max():.3g} m")
    if launches < 2 * runs or seg_launches < runs:
        raise AssertionError(f"K1s launched {launches} times, the segment "
                             f"sum {seg_launches} times in {runs} passes")
    if differ:
        raise AssertionError(f"eval map: the card's passes differ in "
                             f"{sorted(set(differ))}: the back-end pass does "
                             "not repeat")
    if not (dt < TOL_WIN_POSE_T and dq < TOL_WIN_POSE_Q):
        raise AssertionError(f"eval map: poses differ by {dt} m / {dq}")
    if not (np.median(d) < TOL_WIN_POINT_MEDIAN
            and np.percentile(d, 95) < TOL_WIN_POINT_P95):
        raise AssertionError("eval map: points differ beyond tolerance")


def capacity_config():
    """tests/test_maintenance_live.py's configuration."""
    from sgslam_tpu_torch import config

    return config.synthetic_config(
        width=320, height=240,
        orb=config.OrbConfig(n_features=600, max_keypoints=640),
        tracker=config.TrackerConfig(max_frames_between_kf=2,
                                     depth_threshold_factor=70.0),
        capacity=config.MapCapacity(max_keyframes=24, max_points=8192,
                                    local_window=4, local_points=1024))


def phase_capacity_pressure(dev, n_frames=LIVE_FRAMES):
    """tests/test_maintenance_live.py's run: 24 keyframe slots, a keyframe
    at least every 2 frames, so that compaction must fire."""
    import torch

    from sgslam_tpu_torch.io import synthetic
    from sgslam_tpu_torch.slam import tracking

    cfg = capacity_config()
    seq = synthetic.SyntheticSequence(cfg.camera, n_frames=n_frames,
                                      device=dev)
    tr = tracking.Tracker(cfg, device=dev)
    _zero_counts()
    t0 = time.perf_counter()
    for i in range(n_frames):
        tr.process(*seq.frame(i))
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    _segment_count("phase 6, capacity pressure")
    rmse = _ate(tr, seq.poses.cpu().numpy())
    print(f"[capacity] {n_frames} frames 320x240 in {run_s:.2f} s: state "
          f"{tr.state}, {tr.n_kf} keyframes into "
          f"{cfg.capacity.max_keyframes} slots, {tr.compactions} "
          f"compactions, {int(tr.map.kf_valid.sum())} live keyframes, "
          f"{int(tr.map.pt_valid.sum())} live points, ATE {rmse:.5f} m, K1s "
          f"launches {_k1s_launches()}")
    if tr.state != "OK" or tr.compactions < 1 or \
            tr.n_kf <= cfg.capacity.max_keyframes:
        raise AssertionError("capacity pressure: compaction did not fire")
    if not rmse < LIVE_ATE_GATE_M:
        raise AssertionError(f"capacity pressure: ATE {rmse:.4f} m")
    if _k1s_launches() < 1:
        raise AssertionError("capacity pressure: K1s never launched")


def eval_sequence(name, cfg, dev, n_frames=None):
    """run_eval's sequence `name` rendered on `dev` through its `_render`:
    (SyntheticSequence, frames, ground truth [n, 7] T_wc). A run of fewer
    frames takes the first frames of the sequence."""
    from sgslam_tpu_torch import run_eval

    spec = run_eval._sequences(False, dev)[name]
    if n_frames is not None:
        spec = dict(spec, n=n_frames, poses=spec["poses"][:n_frames],
                    people=None if spec["people"] is None
                    else spec["people"][:n_frames])
    seq, frames = run_eval._render(cfg, spec, dev)
    return seq, frames, seq.poses.cpu().numpy()


def objects_config():
    """tests/test_semantic_objects_live.py's configuration."""
    from sgslam_tpu_torch import config

    return config.synthetic_config(
        width=320, height=240,
        orb=config.OrbConfig(n_features=600, max_keypoints=640),
        capacity=config.MapCapacity(max_keyframes=64, max_points=8192,
                                    local_window=4, local_points=1024))


def _rgb(gray):
    return gray[..., None].expand(-1, -1, 3)


def phase_semantic_system(dev, kernels, cfg=None, n_frames=SEM_FRAMES):
    """The slice's main path: `System.track_rgbd` with the detector, the
    cull, tracking with the back-end and the mapper."""
    import torch

    from sgslam_tpu_torch import run_eval
    from sgslam_tpu_torch.slam.system import System

    cfg = cfg or run_eval._make_cfg(False)
    _, frames, gt = eval_sequence("dynamic_640_3walkers_fastrot", cfg, dev,
                                  n_frames)
    torch.cuda.synchronize()
    s = System(cfg, device=dev)               # loop closing on: the default
    timer, backend = StageTimer(), StageTimer()
    s.on_stage = timer
    s.tracker.on_backend_stage = backend

    _zero_counts()
    person, kf_frames = 0, []
    t0 = time.perf_counter()
    for i, (gray, depth) in enumerate(frames):
        s.track_rgbd(gray, depth, rgb=_rgb(gray))
        person += int(s.person_cull_boxes.valid.any())
        if s.tracker.kf_inserted:
            kf_frames.append(i)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = _k1s_launches()
    kernels["hamming_search"]["launches"] = launches
    _segment_count("phase 7, semantic System")

    tracked = len(s.tracker.n_inliers_hist)
    rmse = _ate(s.tracker, gt)
    occupied = int((s.mapper.occupancy_2d() > 0).sum())
    n_obj = int(s.mapper.objects.valid.sum())
    per_frame = timer.groups()
    med = {}
    for name in ("detector", "extract", "cull", "track"):
        plain = [f[name] for i, f in enumerate(per_frame)
                 if i not in kf_frames]
        med[name] = float(np.median(plain))
    kf_track = [per_frame[i]["track"] for i in kf_frames[1:]]
    mapping = [per_frame[i]["mapping"] for i in kf_frames]
    loop_ms = [per_frame[i]["loop_closing"] for i in kf_frames]
    total = [sum(f.values()) for f in per_frame]
    pass_ms, stages = backend.split()
    WHOLE_RUN["7 ATE m"] = round(rmse, 5)
    print(f"[semantic] {n_frames} frames {cfg.camera.width}x"
          f"{cfg.camera.height}, 3 walkers, in {run_s:.2f} s: state "
          f"{s.state}, {s.tracker.n_kf} keyframes, {len(backend.passes)} "
          f"back-end passes, person boxes in {person}/{n_frames} frames, "
          f"ATE {rmse:.5f} m, K1s launches {launches} "
          f"({launches / max(tracked, 1):.2f}/tracked frame), occupied "
          f"cells {occupied}, database objects {n_obj}")
    print(f"[semantic] per frame (median, CUDA events, frames without a "
          f"keyframe): detector {med['detector']:.3f} ms, extract "
          f"{med['extract']:.3f} ms, cull {med['cull']:.3f} ms, track "
          f"{med['track']:.3f} ms; whole track_rgbd {np.median(total):.3f} "
          f"ms; keyframe frames: track with the back-end "
          f"{np.median(kf_track) if kf_track else float('nan'):.3f} ms, "
          f"loop closing (database update + candidates) "
          f"{np.median(loop_ms):.3f} ms, mapping {np.median(mapping):.3f} "
          f"ms; loops closed {len(s.loop.loops_closed)}")
    print(f"[semantic] back-end pass (median over {len(backend.passes)}): "
          f"{pass_ms:.3f} ms = {_split_text(stages)}")
    if s.state != "OK":
        raise AssertionError(f"semantic system state {s.state}")
    if not rmse < SEM_ATE_GATE_M:
        raise AssertionError(f"semantic system ATE {rmse:.4f} m >= "
                             f"{SEM_ATE_GATE_M} m")
    if person < MIN_PERSON_SHARE * n_frames:
        raise AssertionError(f"person boxes in only {person}/{n_frames} "
                             "frames")
    if launches < 3 * tracked:
        raise AssertionError(f"K1s launched {launches} times for {tracked} "
                             "tracked frames (expected >= 3 each)")
    if occupied <= MIN_OCCUPIED_CELLS:
        raise AssertionError(f"occupancy map has {occupied} occupied cells")
    return frames[:5], frames


def phase_semantic_objects(dev, n_frames=OBJ_FRAMES):
    """tests/test_semantic_objects_live.py's run: props become fused 3-D
    objects of the database."""
    import torch

    from sgslam_tpu_torch.geometry import se3
    from sgslam_tpu_torch.io import synthetic
    from sgslam_tpu_torch.slam.system import System

    cfg = objects_config()
    seq = synthetic.SyntheticSequence(cfg.camera, n_frames=n_frames,
                                      dynamic=True, props=True, device=dev)
    s = System(cfg, enable_loop=False, device=dev)
    _zero_counts()
    t0 = time.perf_counter()
    for i in range(n_frames):
        gray, depth = seq.frame(i)
        s.track_rgbd(gray, depth, rgb=_rgb(gray))
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    _segment_count("phase 8, semantic objects")
    gt = se3.se3_apply(se3.se3_inverse(seq.poses[0])[None],
                       seq.props[:, :3]).cpu().numpy()
    gt_cls = seq.props[:, 5].cpu().numpy().astype(int)
    db = s.mapper.objects
    valid = db.valid.cpu().numpy()
    cents, clss = db.centroid.cpu().numpy()[valid], db.cls.cpu().numpy()[valid]
    dists = []
    for p, c in zip(gt, gt_cls):
        d = np.linalg.norm(cents - p[None], axis=1)[clss == c]
        dists.append(float(d.min()) if len(d) else float("inf"))
    hits = sum(d < OBJ_MATCH_M for d in dists)
    print(f"[objects] {n_frames} frames 320x240 in {run_s:.2f} s: state "
          f"{s.state}, {int(valid.sum())} database objects (classes "
          f"{sorted(clss.tolist())}), nearest same-class object to each "
          f"prop {[round(d, 3) for d in dists]} m, {hits} matched within "
          f"{OBJ_MATCH_M} m, K1s launches {_k1s_launches()}")
    if s.state != "OK" or hits < 1:
        raise AssertionError("semantic objects: no database object matches "
                             "a prop")
    if _k1s_launches() < 1:
        raise AssertionError("semantic objects: K1s never launched")


def phase_card_vs_cpu(dev, det_frames, pair):
    """The detector on the card and on the CPU (TF32 off), the match
    tables, and `reject_dynamic_matched` with the same samples."""
    import torch

    from sgslam_tpu_torch import run_eval
    from sgslam_tpu_torch.models.detector import Detector2D
    from sgslam_tpu_torch.semantic import dynamic
    from sgslam_tpu_torch.slam import tracking

    cfg = run_eval._make_cfg(False)
    d_dev = Detector2D(cfg.detector, device=dev)
    d_cpu = Detector2D(cfg.detector, device="cpu")
    logit_err, box_err, score_err = 0.0, 0.0, 0.0
    for gray, _ in det_frames:
        rgb = _rgb(gray)
        _, lg = d_dev.raw(rgb)
        _, lc = d_cpu.raw(rgb.cpu())
        logit_err = max(logit_err, float((lg.cpu() - lc).abs().max()))
        og = [x.cpu() for x in d_dev.detect_normalized(rgb)]
        oc = d_cpu.detect_normalized(rgb.cpu())
        if not (torch.equal(og[3], oc[3]) and torch.equal(og[1][oc[3]],
                                                         oc[1][oc[3]])):
            raise AssertionError("detector: valid flags or classes differ "
                                 "between the card and the CPU")
        ok = oc[3]
        box_err = max(box_err, float((og[0][ok] - oc[0][ok]).abs().max()))
        score_err = max(score_err, float((og[2][ok] - oc[2][ok]).abs().max()))
    print(f"[card-vs-cpu] detector on {len(det_frames)} frames: valid flags "
          f"and classes equal; max |logit| gap {logit_err:.3g}, boxes "
          f"{box_err:.3g} (normalized), scores {score_err:.3g}")
    if box_err > TOL_DET_BOX or score_err > TOL_DET_SCORE:
        raise AssertionError("detector boxes or scores differ beyond "
                             "tolerance")

    (g0, d0), (g1, d1) = pair
    fp = tracking.extract_frame(cfg, g0, d0, dev)
    fc = tracking.extract_frame(cfg, g1, d1, dev)
    person_boxes = d_dev.detect(_rgb(g1), cfg.camera.width,
                                cfg.camera.height)[1]
    prev_boxes = d_dev.detect(_rgb(g0), cfg.camera.width,
                              cfg.camera.height)[2]

    def match(f_cur, f_prev):
        return dynamic.match_prev_frame(
            cfg.matcher, cfg.orb.scale_factor, f_cur, f_prev.xy_raw,
            f_prev.level, f_prev.angle, f_prev.desc, f_prev.valid,
            radius=cfg.dynamic.match_radius)

    xy_g, st_g = match(fc, fp)
    xy_c, st_c = match(fc.to("cpu"), fp.to("cpu"))
    if not (torch.equal(st_g.cpu(), st_c) and torch.equal(xy_g.cpu(), xy_c)):
        raise AssertionError("match_prev_frame differs between the card "
                             "and the CPU")
    rng = np.random.default_rng(0)
    drawn = {}

    def sampler(n_valid, iters):
        n = max(int(n_valid), 8)
        if "r" not in drawn:
            drawn["r"] = rng.integers(0, n, (iters, 8))
        return torch.from_numpy(drawn["r"]).to(n_valid.device)

    out = []
    for d in (dev, torch.device("cpu")):
        keep, n_corr, n_inl = dynamic.reject_dynamic_matched(
            cfg.dynamic, fc.xy_raw.to(d), fc.valid.to(d), xy_c.to(d),
            st_c.to(d), person_boxes.to(d), prev_boxes.to(d), sampler)
        out.append((keep.cpu(), int(n_corr), int(n_inl)))
    flips = int((out[0][0] != out[1][0]).sum())
    print(f"[card-vs-cpu] reject_dynamic_matched, same samples: "
          f"{out[0][1]} correspondences on both, keeps {int(out[0][0].sum())}"
          f" / {int(out[1][0].sum())}, F inliers {out[0][2]} / {out[1][2]}, "
          f"{flips} keep flips (the reference's own one-ulp spread: up to "
          f"{MAX_KEEP_FLIPS} flips, {MAX_INLIER_GAP} inliers)")
    if out[0][1] != out[1][1] or flips > MAX_KEEP_FLIPS or \
            abs(out[0][2] - out[1][2]) > MAX_INLIER_GAP:
        raise AssertionError("reject_dynamic_matched: card and CPU differ "
                             "beyond the reference's own spread")


def _chunk_stage_split(timer):
    """{stage: median ms per chunk} of the chunk function's stages; the
    insertion rounds over the chunks that ran them."""
    groups = timer.groups()
    names = ("extract", "detector", "cull", "track", "insert1", "retrack1",
             "insert2", "retrack2")
    return {n: (float(np.median([g[n] for g in groups if n in g])),
                sum(n in g for g in groups))
            for n in names if any(n in g for g in groups)}


def phase_bench_path(dev, kernels, cfg=None, warm=None, timed=None):
    """bench.py's measured step through the port: `sgslam_tpu_torch.bench
    .run`, the chunked semantic pipeline with loop closing on bench.py's
    schedule, with the chunk stages and loop closing timed (CUDA events)
    and the kernels' counts set to 0 just before the timed region."""
    from sgslam_tpu_torch import bench
    from sgslam_tpu_torch.ops import fast_cuda as fc
    from sgslam_tpu_torch.ops import hamming_cuda as hc
    from sgslam_tpu_torch.ops import pose_opt_cuda as po
    from sgslam_tpu_torch.ops import segment
    from sgslam_tpu_torch.utils import timing

    warm = bench.WARM_CHUNKS if warm is None else warm
    timed = bench.TIMED_CHUNKS if timed is None else timed
    chunk_timer, loop_timer = StageTimer(), StageTimer()

    def before_timed(ct):
        ct.on_chunk_stage, ct.on_stage = chunk_timer, loop_timer
        _zero_counts()

    fps, ct, info = bench.run(dev, cfg, warm, timed, before_timed)
    launches = _k1s_launches()
    kernels["hamming_search"]["launches"] = launches
    k1_launches = hc.hamming_kernel.launches
    kernels["hamming_matrix"]["launches"] = k1_launches
    pose_launches = po.pose_opt_kernel.launches
    kernels["pose_opt"]["launches"] = pose_launches
    fast_launches = fc.fast_detect_kernel.launches
    kernels["fast_detect"]["launches"] = fast_launches
    seg_launches = segment.segment_kernel.launches
    n = info["frames"]

    est = ct.poses_cw()
    gt = info["seq"].poses[:len(est)].cpu().numpy()
    rmse = _ate_cw(est, gt)
    min_inl = min(ct.n_inliers_hist)
    stages = _chunk_stage_split(chunk_timer)
    lc = [grp["loop_closing"] for grp in loop_timer.groups()]
    print(f"[bench-path] {json.dumps(bench.result(fps))}")
    print(f"[bench-path] bench.py's schedule: {bench.N_BOOT} bootstrap "
          f"frames, {warm} warm chunks + flush, {timed} timed chunks of "
          f"{bench.CHUNK} + flush, drained every {bench.FETCH_EVERY} "
          f"chunks; {ct._next_kf_host - info['kf0']} keyframes in the timed "
          f"window, {ct.n_kf} live keyframes, loops closed "
          f"{ct.loops_closed - info['loops0']}, relocalizations "
          f"{ct.relocs}, min inliers {min_inl}, ATE {rmse:.5f} m over "
          f"{len(est)} frames, K1s launches {launches} "
          f"({launches / n:.2f}/frame), segment-sum launches {seg_launches} "
          f"({seg_launches / n:.2f}/frame), pose-kernel launches "
          f"{pose_launches} ({pose_launches / n:.2f}/frame), FAST-kernel "
          f"launches {fast_launches} ({fast_launches / n:.2f}/frame)")
    print(f"[bench-path] frames/s (bench.py's metric: timed frames over the "
          f"wall time of the timed chunks and the final flush): {fps:.3f} "
          f"({info['seconds']:.3f} s for {n} frames) on "
          f"{timing.card(dev)}")
    print("[bench-path] per chunk (CUDA events, median; insertion rounds "
          "over the chunks that ran them): " + ", ".join(
              f"{k} {v:.3f} ms ({c})" for k, (v, c) in stages.items()))
    print(f"[bench-path] loop closing at the drain, per keyframe (CUDA "
          f"events): median {np.median(lc) if lc else float('nan'):.3f} ms,"
          f" max {max(lc) if lc else float('nan'):.3f} ms over {len(lc)}")
    if min_inl < bench.MIN_INLIERS:
        raise AssertionError(f"bench path: inliers fell to {min_inl}")
    if not rmse < ATE_GATE_M:
        raise AssertionError(f"bench path: ATE {rmse:.4f} m")
    if launches < 1 or seg_launches < 1 or pose_launches < 2 * n \
            or fast_launches < n:
        raise AssertionError("bench path: K1s or the segment sum never "
                             "launched, the pose kernel fewer than twice "
                             "a frame, or the FAST kernel fewer than once")
    if k1_launches:
        raise AssertionError(f"bench path: K1 launched {k1_launches} times "
                             "(a search wrote its [Q, N] matrix)")
    return fps, seg_launches


def _stress_gate(path, label, rmse):
    """run_eval's ATE gate on the sequence as rendered; a moved run must
    stay within STRESS_SANE_M."""
    gate = STRESS_ATE_GATE_M if label == "rendered" else STRESS_SANE_M
    if not rmse < gate:
        raise AssertionError(f"loop closing ({path}, {label}): ATE "
                             f"{rmse:.4f} m (gate {gate} m)")


def phase_loop_closing(dev, cfg=None, n_frames=None, loops=None,
                       moved_seeds=STRESS_MOVED_SEEDS):
    """run_eval's 2-lap stress circuit through its System path and its
    chunked runner with a LoopCloser, as rendered (under run_eval's ATE
    gate) and with its images moved by one ulp (under STRESS_SANE_M). Each
    path must close a loop and end under run_eval's gate on at least one
    of its runs: whether a loop closes on a given input, and where its
    correction leaves the trajectory, is chaotic for the reference as for
    the port (ROADMAP section 3). One global-BA pass at the default
    capacity is timed on the System's map. A rehearsal passes `n_frames`
    and `loops` for a shorter circuit."""
    import torch

    from sgslam_tpu_torch import run_eval
    from sgslam_tpu_torch.debug_stress import moved_frames
    from sgslam_tpu_torch.io import synthetic
    from sgslam_tpu_torch.optim.global_ba import global_ba_step

    cfg = cfg or run_eval._make_cfg(False)
    spec = run_eval._sequences(False, dev)["static_640_circuit_2laps_stress"]
    if n_frames is not None:
        spec = dict(spec, n=n_frames, poses=synthetic.make_circuit_trajectory(
            n_frames, loops=loops, device=dev))
    n_frames = spec["n"]
    seq, rendered = run_eval._render(cfg, spec, dev)
    gt = seq.poses.cpu().numpy()
    inputs = [("rendered", rendered)] + [
        (f"moved by one ulp (seed {s})", moved_frames(rendered, s))
        for s in moved_seeds]
    torch.cuda.synchronize()

    def report(name, loop, timer, wall, rmse, extra):
        print(f"[loop] {name}: {n_frames} frames in {wall:.2f} s, loops "
              f"closed {loop.loops_closed}, ATE {rmse:.5f} m, {extra}")
        for k, corr in enumerate(timer.ordered()):
            gba = [ms for nm, ms in corr if nm == "gba"]
            other = ", ".join(f"{nm} {ms:.3f} ms" for nm, ms in corr
                              if nm != "gba")
            print(f"[loop]   correction {k}: {other}, global BA slices "
                  f"(2 iterations each) {[round(x, 3) for x in gba]} ms")

    # per path: did a run close a loop and end under run_eval's gate
    closed = {"System": False, "ChunkedTracker": False}
    gba_ms = peak = None
    for label, frames in inputs:
        torch.cuda.reset_peak_memory_stats(dev)
        s = run_eval.make_system(cfg, spec, None, dev)
        timer = StageTimer.loop_correction(s.metrics)
        _zero_counts()
        t0 = time.perf_counter()
        run_eval.drive_system(s, spec, frames)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        _segment_count(f"phase 11a, System, {label}")
        rmse = _ate(s.tracker, gt)
        WHOLE_RUN[f"11a System {label}: ATE m, loops"] = [
            round(rmse, 5), len(s.loop.loops_closed)]
        report(f"System (loop closing on), {label}", s.loop, timer, wall,
               rmse, f"state {s.state}, {s.tracker.n_kf} keyframes, K1s "
               f"launches {_k1s_launches()}, peak memory "
               f"{torch.cuda.max_memory_allocated(dev) / 2 ** 30:.2f} GiB")
        _stress_gate("System", label, rmse)
        closed["System"] |= bool(s.loop.loops_closed) and (
            rmse < STRESS_ATE_GATE_M)
        if gba_ms is None:
            # one global-BA pass at the default capacity, on this run's map
            m = s.tracker.map
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            global_ba_step(cfg, m, iters=2)
            ev[1].record()
            ev[1].synchronize()
            gba_ms = ev[0].elapsed_time(ev[1]) / 2
            peak = (torch.cuda.max_memory_allocated(dev) - base) / 2 ** 30
            print(f"[loop] global BA at C={m.max_kf} keyframe slots, "
                  f"P={m.max_pt} points, {int(m.kf_valid.sum())} valid "
                  f"keyframes: {gba_ms:.3f} ms per LM iteration (2-iteration "
                  f"pass, CUDA events), peak memory above the map "
                  f"{peak:.2f} GiB")
            del m
        del s

        torch.cuda.reset_peak_memory_stats(dev)
        ct = run_eval.make_chunked(cfg, spec, None, dev)
        loop, timer = ct.loop, StageTimer.loop_correction(ct.metrics)
        _zero_counts()
        t0 = time.perf_counter()
        run_eval.drive_chunked(ct, frames)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        _segment_count(f"phase 11a, ChunkedTracker, {label}")
        rmse = _ate_cw(ct.poses_cw(), gt)
        WHOLE_RUN[f"11a chunked {label}: ATE m, loops"] = [
            round(rmse, 5), ct.loops_closed]
        report(f"ChunkedTracker(chunk=4, fetch_every=6, loop), {label}",
               loop, timer, wall, rmse, f"{ct.n_kf} keyframes, "
               f"relocalizations {ct.relocs}, lost frames "
               f"{int(ct.lost_mask().sum())}, peak memory "
               f"{torch.cuda.max_memory_allocated(dev) / 2 ** 30:.2f} GiB")
        _stress_gate("ChunkedTracker", label, rmse)
        closed["ChunkedTracker"] |= ct.loops_closed > 0 and (
            rmse < STRESS_ATE_GATE_M)
    for name, ok in closed.items():
        if not ok:
            raise AssertionError(
                f"loop closing ({name}): no run of {len(inputs)} closed a "
                f"loop and ended under {STRESS_ATE_GATE_M} m")
    return gba_ms, peak


def forced_loop_config():
    """tests/test_loop_e2e.py's tracker settings at full width and the
    default capacity."""
    from sgslam_tpu_torch import config

    return config.synthetic_config(
        width=640, height=480,
        tracker=config.TrackerConfig(max_frames_between_kf=4,
                                     depth_threshold_factor=70.0))


def _inject_drift(m, xi):
    """tests/test_loop_e2e.py's injection: keyframe k is warped by
    exp((k / (n_kf - 1)) xi) and each point follows its reference keyframe.
    Returns (drifted map, the newest keyframe's warp)."""
    import torch

    from sgslam_tpu_torch.geometry import se3
    from sgslam_tpu_torch.slam.loop_closing import _apply_correction

    n_kf = int(m.next_kf)
    frac = torch.clamp(torch.arange(m.max_kf, device=m.device,
                                    dtype=torch.float32) / max(n_kf - 1, 1),
                       0, 1)
    D = se3.se3_exp(frac[:, None] * torch.as_tensor(xi, device=m.device))
    new = se3.se3_compose(m.kf_pose, se3.se3_inverse(D))
    return _apply_correction(m, m.kf_pose, new), se3.se3_inverse(D[n_kf - 1])


def phase_forced_loop(dev, cfg=None):
    """The loop fixtures of tests/test_loop_e2e.py (System) and
    tests/test_chunked_full_system.py (ChunkedTracker) at full width: the
    closed-room circuit, a progressive drift injected into the map before
    the revisit, so that the revisit is no longer covisible and only loop
    closing can join it; each path must close a loop, and the System path
    must halve its keyframe ATE (tests/test_loop_e2e.py's gate). The
    chunked path's keyframe ATE is printed, not gated: at that test's
    320x240 the reference's own chunked run ends anywhere from 0.103 to
    0.300 m under one-ulp image moves (ROADMAP section 3)."""
    import torch

    from sgslam_tpu_torch.debug_stress import kf_ate
    from sgslam_tpu_torch.geometry import se3
    from sgslam_tpu_torch.io import synthetic
    from sgslam_tpu_torch.slam import scan_pipeline
    from sgslam_tpu_torch.slam.loop_closing import LoopCloser
    from sgslam_tpu_torch.slam.system import System

    cfg = cfg or forced_loop_config()

    def circuit(n, laps):
        seq = synthetic.SyntheticSequence(
            cfg.camera, n_frames=n, planes=synthetic.ROOM_CLOSED,
            poses=synthetic.make_circuit_trajectory(n, loops=laps,
                                                    device=dev), device=dev)
        return [seq.frame(i) for i in range(n)], seq.poses.cpu().numpy()

    def report(name, loop, timer, drifted, final, wall):
        print(f"[forced-loop] {name}: loops closed {loop.loops_closed}, "
              f"keyframe ATE drifted {drifted:.5f} m -> {final:.5f} m, "
              f"{wall:.2f} s")
        for corr in timer.ordered():
            gba = [round(ms, 3) for nm, ms in corr if nm == "gba"]
            other = ", ".join(f"{nm} {ms:.3f} ms" for nm, ms in corr
                              if nm != "gba")
            print(f"[forced-loop]   correction: {other}, global BA slices "
                  f"(2 iterations each) {gba} ms")

    # System: 86 frames, 1.075 laps, drift after frame 70
    frames, gt = circuit(86, 1.075)
    s = System(cfg, enable_semantic=False, enable_mapping=False, device=dev)
    timer = StageTimer.loop_correction(s.metrics)
    _zero_counts()
    t0 = time.perf_counter()
    for g, d in frames[:70]:
        s.track_rgbd(g, d)
    clean = len(s.loop.loops_closed)
    s.tracker.map, dl = _inject_drift(s.tracker.map, FORCED_DRIFT_SYSTEM)
    s.tracker.Tcw = se3.se3_compose(s.tracker.Tcw, dl)
    s.tracker.last_Tcw = se3.se3_compose(s.tracker.last_Tcw, dl)
    drifted = kf_ate(s.tracker.map, gt)
    for g, d in frames[70:]:
        s.track_rgbd(g, d)
    torch.cuda.synchronize()
    _segment_count("phase 11b, System")
    final = kf_ate(s.tracker.map, gt)
    report("System", s.loop, timer, drifted, final,
           time.perf_counter() - t0)
    if clean or not s.loop.loops_closed:
        raise AssertionError("forced loop (System): no loop after the drift"
                             " or a loop before it")
    if not final < drifted / 2:
        raise AssertionError(f"forced loop (System): keyframe ATE "
                             f"{drifted:.4f} -> {final:.4f} m, not halved")
    if not (np.isfinite(final) and bool(torch.isfinite(
            s.tracker.map.pt_pos).all())):
        raise AssertionError("forced loop (System): the corrected map is "
                             "not finite")

    # ChunkedTracker: 92 frames, 1.15 laps, drift after frame 66; run
    # twice from fresh objects, which must agree to the bit
    frames, gt = circuit(92, 1.15)

    def chunked():
        loop = LoopCloser(cfg, device=dev)
        ct = scan_pipeline.ChunkedTracker(cfg, chunk=BENCH_CHUNK,
                                          fetch_every=2, loop=loop,
                                          device=dev)
        timer = StageTimer.loop_correction(ct.metrics)
        _zero_counts()
        t0 = time.perf_counter()
        i = 0
        while ct._carry is None:
            ct.bootstrap(*frames[i])
            i += 1
        for stop in (66, 92):
            while i + BENCH_CHUNK <= stop:
                fr = frames[i:i + BENCH_CHUNK]
                ct.process_chunk(torch.stack([f[0] for f in fr]),
                                 torch.stack([f[1] for f in fr]))
                i += BENCH_CHUNK
            if stop == 66:
                ct.flush()
                clean = ct.loops_closed
                ct._map, dl = _inject_drift(ct._map, FORCED_DRIFT_CHUNKED)
                ct._carry.Tcw = se3.se3_compose(ct._carry.Tcw, dl)
                ct._ref_pose_ins = ct._map.kf_pose[ct._ref_slot].cpu().numpy()
                drifted = kf_ate(ct._map, gt)
        ct.flush()
        torch.cuda.synchronize()
        _segment_count("phase 11b, ChunkedTracker")
        final = kf_ate(ct.map, gt)
        report("ChunkedTracker(chunk=4, fetch_every=2, loop)", loop, timer,
               drifted, final, time.perf_counter() - t0)
        if clean or ct.loops_closed < 1:
            raise AssertionError("forced loop (chunked): no loop after the "
                                 "drift or a loop before it")
        m = ct.map
        return {name: getattr(m, name).cpu() for name in
                ("kf_pose", "kf_valid", "pt_pos", "pt_valid")}

    first, second = chunked(), chunked()
    same = {k: torch.equal(first[k], second[k]) for k in first}
    print(f"[forced-loop] ChunkedTracker run twice: keyframe poses, map "
          f"points and their masks identical to the bit: {same}")
    if not all(same.values()):
        raise AssertionError(f"forced loop (chunked): the two runs differ "
                             f"({same})")


def kidnap_config():
    """tests/test_chunked_full_system.py's configuration."""
    from sgslam_tpu_torch import config

    return config.synthetic_config(
        width=320, height=240,
        orb=config.OrbConfig(n_features=600, max_keypoints=640),
        tracker=config.TrackerConfig(max_frames_between_kf=4,
                                     depth_threshold_factor=70.0),
        capacity=config.MapCapacity(max_keyframes=64, max_points=8192,
                                    local_window=4, local_points=1024))


def kidnap_run(dev, cfg, frames):
    """tests/test_chunked_full_system.py::test_chunked_kidnap_relocalizes
    through the port's ChunkedTracker: map the first frames, then three
    chunks from frame KIDNAP_TO. Returns (relocalizations, the tail's
    inliers, the last four frames' gaps to the map's own estimate)."""
    import torch

    from sgslam_tpu_torch.slam import scan_pipeline
    from sgslam_tpu_torch.slam.loop_closing import LoopCloser

    ct = scan_pipeline.ChunkedTracker(cfg, chunk=BENCH_CHUNK, fetch_every=1,
                                      loop=LoopCloser(cfg, device=dev),
                                      device=dev)

    def chunk_at(lo):
        fr = frames[lo:lo + BENCH_CHUNK]
        ct.process_chunk(torch.stack([f[0] for f in fr]),
                         torch.stack([f[1] for f in fr]))

    i = 0
    while ct._carry is None:
        ct.bootstrap(*frames[i])
        i += 1
    while i + BENCH_CHUNK <= KIDNAP_MAP:
        chunk_at(i)
        i += BENCH_CHUNK
    ct.flush()
    own = ct.poses_cw()
    for c in range(3):                  # kidnapped ~140 degrees back
        chunk_at(KIDNAP_TO + c * BENCH_CHUNK)
    ct.flush()
    est = ct.poses_cw()
    last = KIDNAP_TO + 3 * BENCH_CHUNK - 1
    errs = [float(np.linalg.norm(est[-(k + 1)][4:7] - own[last - k][4:7]))
            for k in range(BENCH_CHUNK)]
    return ct.relocs, ct.n_inliers_hist[-BENCH_CHUNK:], errs


def phase_relocalization(dev, moved_seeds=RELOC_MOVED_SEEDS):
    """tests/test_chunked_full_system.py::test_chunked_kidnap_relocalizes
    on the card, as rendered and with the images moved by one ulp. Every run
    must relocalize, track again and land within RELOC_SANE_M of the map's
    own estimate; the test's pose gate (the smallest of the last four
    frames' gaps < 0.06 m) must hold on at least one run. Where a run lands
    is chaotic: the reference misses that gate on 4 of its 9 runs (as
    rendered and eight one-ulp moves), by up to 0.348 m, the port on the
    CPU on 5 of 9 (tools/parity_spread.py reloc)."""
    import torch

    from sgslam_tpu_torch.debug_stress import moved_frames
    from sgslam_tpu_torch.io import synthetic

    cfg = kidnap_config()
    seq = synthetic.SyntheticSequence(
        cfg.camera, n_frames=KIDNAP_FRAMES, planes=synthetic.ROOM_CLOSED,
        poses=synthetic.make_circuit_trajectory(KIDNAP_FRAMES, loops=1.0,
                                                device=dev), device=dev)
    rendered = [seq.frame(i) for i in range(KIDNAP_FRAMES)]
    inputs = [("rendered", rendered)] + [
        (f"moved by one ulp (seed {s})", moved_frames(rendered, s))
        for s in moved_seeds]
    best = []
    for label, frames in inputs:
        _zero_counts()
        relocs, tail, errs = kidnap_run(dev, cfg, frames)
        _segment_count(f"phase 12, {label}")
        best.append(min(errs))
        print(f"[reloc] {label}: {KIDNAP_MAP} frames mapped, then 3 chunks "
              f"from frame {KIDNAP_TO}: relocalizations {relocs}, tail "
              f"inliers {tail}, tail pose vs the map's own estimate "
              f"{[round(e, 4) for e in errs]} m")
        if relocs < 1:
            raise AssertionError(f"relocalization ({label}): never "
                                 f"relocalized")
        if max(tail) < cfg.tracker.min_inliers_local_map:
            raise AssertionError(f"relocalization ({label}): tail inliers "
                                 f"{tail}")
        if not min(errs) < RELOC_SANE_M:
            raise AssertionError(f"relocalization ({label}): pose error "
                                 f"{errs}")
    n_ok = sum(b < RELOC_GATE_M for b in best)
    print(f"[reloc] the pose gate (< {RELOC_GATE_M} m) holds on {n_ok} of "
          f"{len(best)} runs; K1s launches {_k1s_launches()}")
    if n_ok < 1:
        raise AssertionError(f"relocalization: the pose gate holds on no "
                             f"run: {best}")

def phase_stereo(dev, cfg=None, n_frames=STEREO_FRAMES):
    """Stereo at full width: run_eval's stereo_640_walk through
    `System.track_stereo` (loop closing on) and `ChunkedStereoTracker`
    with a LoopCloser, both under run_eval's STEREO_GATE; the semantic
    stereo runner at tests/test_chunked_parity.py's size under that test's
    gate; the stereo + mapper guard. Times each stage (CUDA events) and
    `stereo_match` alone at the path's shapes."""
    import torch

    from sgslam_tpu_torch import run_eval
    from sgslam_tpu_torch.io import synthetic
    from sgslam_tpu_torch.mapping.semantic_mapper import SemanticMapper
    from sgslam_tpu_torch.models.detector import Detector2D
    from sgslam_tpu_torch.ops import orb
    from sgslam_tpu_torch.ops.stereo import stereo_match
    from sgslam_tpu_torch.slam import scan_pipeline
    from sgslam_tpu_torch.utils import timing

    name = "stereo_640_walk"
    cfg = cfg or run_eval._make_cfg(False)
    _, pairs, gt = eval_sequence(name, cfg, dev, n_frames)
    spec = dict(run_eval._sequences(False, dev)[name], n=n_frames)
    torch.cuda.synchronize()

    # (a) System.track_stereo, loop closing on
    s = run_eval.make_system(cfg, spec, None, dev)
    timer = StageTimer()
    s.on_stage = timer
    _zero_counts()
    t0 = time.perf_counter()
    kf_frames = []

    def on_frame(i):
        if s.tracker.kf_inserted:
            kf_frames.append(i)

    run_eval.drive_system(s, spec, pairs, on_frame)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = _k1s_launches()
    _segment_count("phase 13a, System.track_stereo")
    rmse = _ate(s.tracker, gt)
    WHOLE_RUN["13 stereo System ATE m"] = round(rmse, 5)
    groups = timer.groups()
    med = {n: float(np.median([g[n] for i, g in enumerate(groups)
                               if i not in kf_frames]))
           for n in ("extract", "track")}
    kf_track = [groups[i]["track"] for i in kf_frames[1:]]
    loop_ms = [groups[i]["loop_closing"] for i in kf_frames]
    gl, gr = pairs[n_frames // 2]
    feats = orb.extract(gl, cfg.orb, cfg.camera)
    sm_ms = timing.event_ms(lambda: stereo_match(
        cfg.camera, gl, gr, feats.xy_raw, feats.level, feats.valid), runs=20)
    n_ok = int(stereo_match(cfg.camera, gl, gr, feats.xy_raw, feats.level,
                            feats.valid)[2].sum())
    print(f"[stereo] run_eval's stereo_640_walk, {n_frames} frames "
          f"{cfg.camera.width}x{cfg.camera.height}, System.track_stereo "
          f"(loop closing on) in {run_s:.2f} s: state {s.state}, "
          f"{s.tracker.n_kf} keyframes, loops closed "
          f"{len(s.loop.loops_closed)}, ATE {rmse:.5f} m (gate "
          f"{STEREO_GATE_M} m), K1s launches {launches} "
          f"({launches / n_frames:.2f}/frame)")
    print(f"[stereo] per frame (median, CUDA events, frames without a "
          f"keyframe): extract_frame_stereo {med['extract']:.3f} ms, track "
          f"{med['track']:.3f} ms; keyframe frames: track with the back-end "
          f"{np.median(kf_track) if kf_track else float('nan'):.3f} ms, "
          f"loop closing {np.median(loop_ms):.3f} ms; stereo_match alone "
          f"({int(feats.valid.sum())} keypoints x 96 disparities x 25 taps,"
          f" one eager call between CUDA events): {sm_ms:.3f} ms, "
          f"{n_ok} matches accepted")
    if s.state != "OK" or not rmse < STEREO_GATE_M:
        raise AssertionError(f"stereo System: state {s.state}, ATE "
                             f"{rmse:.4f} m")
    if launches < 2 * (n_frames - 1):
        raise AssertionError(f"stereo System: K1s launched {launches} times")

    # (b) ChunkedStereoTracker with a loop closer, run_eval's schedule
    ct = run_eval.make_chunked(cfg, spec, None, dev)
    chunk_timer = StageTimer()
    ct.on_chunk_stage = chunk_timer
    _zero_counts()
    t0 = time.perf_counter()
    run_eval.drive_chunked(ct, pairs)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = _k1s_launches()
    _segment_count("phase 13b, ChunkedStereoTracker")
    rmse = _ate_cw(ct.poses_cw(), gt)
    WHOLE_RUN["13 stereo chunked ATE m"] = round(rmse, 5)
    stages = _chunk_stage_split(chunk_timer)
    print(f"[stereo] ChunkedStereoTracker(chunk={BENCH_CHUNK}, fetch_every="
          f"{BENCH_FETCH}, loop) in {run_s:.2f} s: {ct.n_kf} keyframes, "
          f"loops closed {ct.loops_closed}, lost frames "
          f"{int(ct.lost_mask().sum())}, ATE {rmse:.5f} m, K1s launches "
          f"{launches} ({launches / n_frames:.2f}/frame); per chunk "
          f"(median): " + ", ".join(f"{k} {v:.3f} ms ({n})"
                                    for k, (v, n) in stages.items()))
    if not rmse < STEREO_GATE_M:
        raise AssertionError(f"chunked stereo: ATE {rmse:.4f} m")
    if launches < 1:
        raise AssertionError("chunked stereo: K1s never launched")

    # (c) ChunkedSemanticStereoTracker at test_chunked_semantic_stereo's
    # size: 26 dynamic frames at 320x240, chunk 4, fetch 2
    scfg = kidnap_config()
    sseq = synthetic.SyntheticSequence(scfg.camera,
                                       n_frames=SEM_STEREO_FRAMES,
                                       dynamic=True, device=dev)
    spairs = [sseq.frame_stereo(i)[:2] for i in range(SEM_STEREO_FRAMES)]
    st = scan_pipeline.ChunkedSemanticStereoTracker(
        scfg, Detector2D(scfg.detector, device=dev), chunk=BENCH_CHUNK,
        fetch_every=2, device=dev)
    _zero_counts()
    run_eval.drive_chunked(st, spairs)
    launches = _k1s_launches()
    _segment_count("phase 13c, ChunkedSemanticStereoTracker")
    est = st.poses_cw()
    rmse = _ate_cw(est, sseq.poses[:len(est)].cpu().numpy())
    med_inl = sorted(st.n_inliers_hist)[len(st.n_inliers_hist) // 2]
    print(f"[stereo] ChunkedSemanticStereoTracker, {len(est)} frames "
          f"{scfg.camera.width}x{scfg.camera.height} with a walking person: "
          f"{st.n_kf} keyframes, median inliers {med_inl}, ATE {rmse:.5f} m "
          f"(gate {SEM_STEREO_GATE_M} m), K1s launches {launches}")
    if st.n_kf < 2 or not rmse < SEM_STEREO_GATE_M or med_inl < 30:
        raise AssertionError(f"semantic stereo: {st.n_kf} keyframes, ATE "
                             f"{rmse:.4f} m, median inliers {med_inl}")

    # (d) the stereo + mapper guard
    try:
        scan_pipeline.ChunkedStereoTracker(
            cfg, mapper=SemanticMapper(cfg, device=dev), device=dev)
    except ValueError as e:
        if "right image" not in str(e):
            raise
        print("[stereo] the stereo + SemanticMapper guard raises ValueError")
    else:
        raise AssertionError("stereo + mapper: no ValueError")


def mono_config():
    """tests/test_mono_stereo.py::test_mono_pipeline_e2e's tracker at full
    width: default widths and capacity."""
    from sgslam_tpu_torch import config

    return config.synthetic_config(
        640, 480, tracker=config.TrackerConfig(max_frames_between_kf=2,
                                               depth_threshold_factor=70.0))


def phase_mono(dev, cfg=None, n_frames=MONO_FRAMES):
    """Monocular at full width: `System.monocular(...).track_monocular`
    over the default room, under tests/test_mono_stereo.py's gates;
    `initialize_mono` timed alone and run again on the CPU on the same
    matches and draws (the batched SVDs of the two devices)."""
    import torch

    from sgslam_tpu_torch.eval import ate
    from sgslam_tpu_torch.geometry import se3
    from sgslam_tpu_torch.geometry.epipolar import draw_ranks
    from sgslam_tpu_torch.io import synthetic
    from sgslam_tpu_torch.optim import initializer
    from sgslam_tpu_torch.slam import mono
    from sgslam_tpu_torch.slam.system import System
    from sgslam_tpu_torch.utils import timing

    cfg = cfg or mono_config()
    seq = synthetic.SyntheticSequence(cfg.camera, n_frames=n_frames,
                                      device=dev)
    grays = [seq.frame(i)[0] for i in range(n_frames)]
    s = System.monocular(cfg, enable_semantic=False, enable_mapping=False,
                         device=dev)
    calls = []

    def recorded(cam, p1, p2, valid, generator=None, *, iters=200,
                 samples=None):
        """initialize_mono with its draws made here (as it makes them), so
        that the call can be replayed; CUDA events around it."""
        if samples is None:
            n_valid = torch.clamp(torch.sum(valid.to(torch.int32)), min=8)
            samples = (draw_ranks(n_valid, iters, 8, generator),
                       draw_ranks(n_valid, iters, 4, generator))
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        out = initializer.initialize_mono(cam, p1, p2, valid,
                                          samples=samples)
        b.record()
        calls.append(((cam, p1, p2, valid, samples), out, a, b))
        return out

    mono.initialize_mono = recorded
    timer = StageTimer()
    s.on_stage = timer
    _zero_counts()
    t0 = time.perf_counter()
    init = None
    try:
        for i, g in enumerate(grays):
            s.track_monocular(g)
            if init is None and s.state == "OK":
                init = i
    finally:
        mono.initialize_mono = initializer.initialize_mono
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = _k1s_launches()
    _segment_count("phase 14, System.monocular")
    tr = s.tracker
    n_pts = int(tr.map.pt_valid.sum())
    if init is None:
        raise AssertionError("mono: never initialized")
    gt = seq.poses.cpu().numpy()
    est_wc = se3.se3_inverse(torch.as_tensor(tr.poses_cw()[init:])).numpy()
    rmse = ate.ate_rmse(est_wc, gt[init:], with_scale=True)[0]
    span = float(np.linalg.norm(gt[init:, 4:7].max(0)
                                - gt[init:, 4:7].min(0)))
    gate = MONO_ATE_FACTOR * max(span, 1.0)
    args, out = calls[-1][0], calls[-1][1]      # the accepted attempt
    init_ms = [a.elapsed_time(b) for _, _, a, b in calls]
    alone_ms = timing.event_ms(lambda: initializer.initialize_mono(*args[:4],
                                                             samples=args[4]),
                         runs=10)
    # every attempt again on the CPU, same matches and draws; and the sign
    # of each hypothesis' DLT null vector from the two devices' SVDs
    def dlt_nulls(p1, p2, valid, samples):
        """The H and F hypotheses' DLT matrices, as initialize_mono makes
        them, on the inputs' device."""
        order = torch.argsort((~valid).to(torch.uint8), stable=True)
        a1 = initializer._normalize_pts(p1)[0]
        a2 = initializer._normalize_pts(p2)[0]
        sf, sh = (order[x] for x in samples)
        return (initializer._dlt_homography(a1[sh], a2[sh]).cpu(),
                initializer._dlt_fundamental(a1[sf], a2[sf]).cpu())

    ok_diff = used_h_diff = same_h = same_f = n_hyp = 0
    for (cam, *card_in), card, _, _ in calls:
        host_in = [x.cpu() for x in card_in[:3]] + [
            tuple(x.cpu() for x in card_in[3])]
        cpu = initializer.initialize_mono(cam, *host_in[:3],
                                          samples=host_in[3])
        ok_diff += bool(cpu["ok"]) != bool(card["ok"])
        used_h_diff += bool(cpu["used_H"]) != bool(card["used_H"])
        (card_h, card_f), (cpu_h, cpu_f) = (dlt_nulls(*card_in),
                                            dlt_nulls(*host_in))
        same_h += int(((card_h * cpu_h).sum((1, 2)) > 0).sum())
        same_f += int(((card_f * cpu_f).sum((1, 2)) > 0).sum())
        n_hyp += card_h.shape[0]
    cpu = initializer.initialize_mono(
        args[0], *(x.cpu() for x in args[1:4]),
        samples=tuple(x.cpu() for x in args[4]))
    t21_gap = float((cpu["T21"] - out["T21"].cpu()).abs().max())
    good_flips = int((cpu["good"] != out["good"].cpu()).sum())
    groups = timer.groups()
    track = [g["track"] for g in groups[init + 1:]]
    print(f"[mono] {n_frames} frames {cfg.camera.width}x"
          f"{cfg.camera.height}, System.monocular(...).track_monocular in "
          f"{run_s:.2f} s: initialized at frame {init} after {len(calls)} "
          f"initialize_mono call(s), used_H {bool(out['used_H'])}, rh "
          f"{float(out['rh']):.4f}, state {s.state}, {tr.n_kf} keyframes, "
          f"{n_pts} valid points, Sim(3)-aligned ATE {rmse:.5f} m (gate "
          f"{gate:.4f} m over a {span:.3f} m span), K1s launches {launches} "
          f"({launches / n_frames:.2f}/frame)")
    print(f"[mono] initialize_mono (200 F + 200 H hypotheses): "
          f"{np.median(init_ms):.3f} ms in the run, {alone_ms:.3f} ms alone "
          f"(CUDA events, eager); the same matches and draws on the CPU: "
          f"ok {bool(cpu['ok'])} / card {bool(out['ok'])}, used_H "
          f"{bool(cpu['used_H'])} / {bool(out['used_H'])}, T21 within "
          f"{t21_gap:.3g}, good flags differing {good_flips}; track per "
          f"frame after initialization (median, CUDA events) "
          f"{np.median(track):.3f} ms")
    print(f"[mono] all {len(calls)} initialize_mono calls again on the CPU "
          f"(same matches and draws): ok differs on {ok_diff}, used_H on "
          f"{used_h_diff}; the card's SVD returns the DLT null vector with "
          f"the CPU's sign for {same_h} of {n_hyp} H and {same_f} of "
          f"{n_hyp} F hypotheses")
    if not init < MONO_INIT_BEFORE or s.state != "OK":
        raise AssertionError(f"mono: initialized at {init}, state {s.state}")
    if n_pts <= MONO_MIN_POINTS or not rmse < gate:
        raise AssertionError(f"mono: {n_pts} points, ATE {rmse:.4f} m")
    if launches < 1:
        raise AssertionError("mono: K1s never launched")


# the summary keys of sgslam_tpu/run_tum.py (per frame, chunked)
CLI_KEYS = ["frames", "fps", "wall_s", "median_track_ms", "state",
            "keyframes", "loops_closed", "ate_rmse_m", "trajectory"]
CLI_CHUNKED_KEYS = ["mode", "frames", "fps", "wall_s", "state", "keyframes",
                    "lost_frames", "loops_closed", "relocalizations",
                    "objects", "ate_rmse_m", "trajectory"]


def phase_cli(dev, n_frames=CLI_FRAMES):
    """`python -m sgslam_tpu_torch.run_tum` on the card, per frame and
    chunked, on a synthetic TUM-layout dataset that the first call writes
    (default flags: the detector, the cull, loop closing and the mapper)."""
    import contextlib
    import io
    import tempfile

    from sgslam_tpu_torch import run_tum

    with tempfile.TemporaryDirectory() as tmp:
        seq_dir = os.path.join(tmp, "seq")
        for extra, keys in (([], CLI_KEYS), (["--chunked"], CLI_CHUNKED_KEYS)):
            argv = ["--synthetic", str(n_frames), "--seq-dir", seq_dir,
                    "--out", os.path.join(tmp, "out_chunked" if extra
                                          else "out")]
            _zero_counts()
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                result = run_tum.main(argv + extra)
            wall = time.perf_counter() - t0
            lines = buf.getvalue().strip().splitlines()
            printed = json.loads(lines[-1])
            launches = _k1s_launches()
            _segment_count(f"phase 15, run_tum "
                           f"{' '.join(extra) or 'per frame'}")
            print(f"[cli] run_tum {' '.join(argv[:2] + extra)} in "
                  f"{wall:.2f} s, K1s launches {launches}: {lines[-1]}")
            if printed != result or list(printed) != keys:
                raise AssertionError(f"run_tum summary keys {list(printed)}")
            if printed["frames"] != n_frames or printed["state"] != "OK":
                raise AssertionError(f"run_tum: {printed}")
            if printed["ate_rmse_m"] is None or not (
                    printed["ate_rmse_m"] < CLI_ATE_GATE_M):
                raise AssertionError(f"run_tum ATE: {printed}")
            if launches < n_frames:
                raise AssertionError(f"run_tum: K1s launched {launches} "
                                     "times: the run did not use the card")
            traj = np.loadtxt(printed["trajectory"])
            if traj.shape != (n_frames, 8) or not np.isfinite(traj).all():
                raise AssertionError(f"run_tum trajectory {traj.shape}")


def phase_scale_out(dev, use_asset: bool = True):
    """The port's dryrun of the multi-chip contract at world size 1 on
    NCCL, then one distributed step on the card against the same step on a
    gloo grid on the CPU."""
    import torch
    import torch.distributed as dist

    from sgslam_tpu_torch.ops import segment
    from sgslam_tpu_torch.parallel import dist_ba, dryrun, map_partition
    from sgslam_tpu_torch.parallel import multihost

    root = os.path.dirname(os.path.abspath(__file__))
    rdv = os.path.join(root, "build", f"rendezvous_{os.getpid()}")
    os.makedirs(os.path.dirname(rdv), exist_ok=True)
    if os.path.exists(rdv):
        os.unlink(rdv)
    multihost.init_process(f"file://{rdv}", 1, 0, device=dev)
    try:
        mesh = dist_ba.make_mesh(1, 1, device=dev)
        _zero_counts()
        cfg, m, label = dryrun.load_problem(dev, use_asset)
        rep = dryrun.dryrun(mesh, cfg, m, label, iters=SCALE_OUT_ITERS)
        seg_launches = _segment_count("phase 16, dryrun",
                                      5 * SCALE_OUT_ITERS)
        print(f"[scale-out] world size 1 on {dist.get_backend()}, {label}: "
              f"C={rep['C']} keyframes, P={rep['P']} points, {rep['obs']} "
              f"observations; reprojection cost {rep['cost0']:.2f} -> "
              f"{rep['cost1']:.2f} in {rep['iters']} LM iterations; "
              f"{rep['ms_per_iter']:.3f} ms per iteration (CUDA events, "
              f"median; each {[round(x, 3) for x in rep['step_ms']]}), peak "
              f"memory above the map {rep['peak_gib']} GiB, bytes handed "
              f"to collectives per iteration {rep['collective_bytes_per_iter']}"
              f", segment-sum launches {seg_launches}")
        if not rep["ok"]:
            raise AssertionError(f"scale-out: cost {rep['cost0']} -> "
                                 f"{rep['cost1']}")

        # one step, card vs CPU, at the damping where the first step is
        # accepted
        cpu_mesh = dist_ba.make_mesh(1, 1, device="cpu", backend="gloo")
        part = map_partition.partition_map(cfg, m, 1)
        outs = []
        for msh in (mesh, cpu_mesh):
            sh = dist_ba.make_shardings(msh)
            noisy = part.points + dryrun.point_noise(
                (m.max_pt, 3))[np.maximum(part.pt_ids, 0)]
            step = dist_ba.make_distributed_ba_step(cfg.camera, msh,
                                                    part.poses.shape[0])
            out = step(sh["replicated"](part.poses),
                       sh["replicated"](part.opt_mask), sh["pt"](noisy),
                       sh["pt"](part.obs_cam), sh["pt"](part.obs_pt),
                       sh["pt"](part.obs_uvr), sh["pt"](part.obs_w),
                       torch.tensor(SCALE_OUT_STEP_LAM, device=msh.device))
            outs.append([x.cpu() for x in out])
        (p_gpu, x_gpu, l_gpu), (p_cpu, x_cpu, l_cpu) = outs
        dp = float((p_gpu - p_cpu).abs().max())
        dx = torch.linalg.vector_norm(x_gpu - x_cpu, dim=1)
        moved = float((p_gpu - torch.as_tensor(part.poses)).abs().max())
        print(f"[scale-out] one distributed step (lam {SCALE_OUT_STEP_LAM})"
              f" card vs CPU: accepted on the card "
              f"{float(l_gpu) < SCALE_OUT_STEP_LAM}, on the CPU "
              f"{float(l_cpu) < SCALE_OUT_STEP_LAM}; poses moved {moved:.3g} "
              f"and differ by {dp:.3g}; points differ by median "
              f"{float(dx.median()):.3g} m, max {float(dx.max()):.3g} m")
        if not (float(l_gpu) == float(l_cpu) and dp < TOL_STEP_POSE
                and float(dx.median()) < TOL_STEP_POINT_MEDIAN):
            raise AssertionError("scale-out: the card's step differs from "
                                 "the CPU's")
    finally:
        dist.destroy_process_group()
        if os.path.exists(rdv):
            os.unlink(rdv)
    return rep


def phase_detector_training(dev, steps=TRAIN_STEPS, batch=TRAIN_BATCH):
    """`TRAIN_STEPS` AdamW steps at batch `TRAIN_BATCH` through the port's
    trainer on the card, then one step card vs CPU on the same batch."""
    import torch

    from sgslam_tpu_torch import train_detector

    tr = train_detector.Trainer(steps, batch, device=dev)
    losses, sample_ms, step_ms = [], [], []
    for i in range(steps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        b = tr.batch_for(i)
        ev[1].record()
        loss, _ = tr.step(*b)
        ev[2].record()
        losses.append(loss)
        ev[2].synchronize()
        sample_ms.append(ev[0].elapsed_time(ev[1]))
        step_ms.append(ev[1].elapsed_time(ev[2]))
    losses = [float(x) for x in losses]
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    print(f"[train] {steps} steps at batch {batch}, 300x300, the 8 room x "
          f"camera variants in turn: loss {losses[0]:.4f} -> {losses[-1]:.4f}"
          f" (mean of the first 5 {first:.4f}, of the last 5 {last:.4f}); per"
          f" step (CUDA events, median after the first): sampling "
          f"{np.median(sample_ms[1:]):.3f} ms, forward + backward + AdamW "
          f"{np.median(step_ms[1:]):.3f} ms (first step {step_ms[0]:.3f} ms)")
    if not (np.isfinite(losses).all() and last < first):
        raise AssertionError(f"detector training: the loss did not fall "
                             f"({losses})")

    # one step card vs CPU: the same initialization and batch
    rgb, boxes, labels, vis = tr.batch_for(0)
    runs = []
    for d in (dev, torch.device("cpu")):
        t = train_detector.Trainer(steps, batch, device=d)
        loss, _ = t.step(rgb.to(d), boxes.to(d), labels.to(d), vis.to(d))
        runs.append((t, float(loss)))
    (t_gpu, l_gpu), (t_cpu, l_cpu) = runs
    gaps = [_grad_gap(t_gpu.model, t_cpu.model)]
    # AdamW given the same gradients: the card's, on a fresh CPU trainer
    t_ref = train_detector.Trainer(steps, batch, device="cpu")
    for pr, pg in zip(t_ref.model.parameters(), t_gpu.model.parameters()):
        pr.grad = pg.grad.cpu()
    t_ref.opt.step()
    u_gap = max(float((pr - pg.cpu()).detach().abs().max()) for pr, pg in
                zip(t_ref.model.parameters(), t_gpu.model.parameters()))
    # the gradient gap on other seeds and batches, and with a planted
    # fault on the card's side: the localization term dropped
    for seed, i in TRAIN_GRAD_READINGS:
        b = train_detector.Trainer(steps, batch, seed=seed,
                                   device=dev).batch_for(i)
        gaps.append(_grad_gap(_grads(dev, steps, batch, seed, b),
                              _grads("cpu", steps, batch, seed, b)))
    faulty = _grads(dev, steps, batch, 0, (rgb, boxes, labels, vis), True)
    fault = _grad_gap(faulty, t_cpu.model)
    fault_shared = _grad_gap(faulty, t_cpu.model, shared_only=True)
    print(f"[train] one step card vs CPU (TF32 off): loss {l_gpu:.6f} vs "
          f"{l_cpu:.6f}; gradients within {gaps[0]:.3g} of each tensor's "
          f"largest entry (seeds and batches {[(0, 0)] + TRAIN_GRAD_READINGS}"
          f": {[float(f'{g:.3g}') for g in gaps]}; with the card's "
          f"localization term dropped: {fault:.3g}, over the layers that "
          f"still have gradients {fault_shared:.3g}; limit "
          f"{TOL_TRAIN_GRAD}); "
          f"AdamW on the card's gradients within {u_gap:.3g}")
    if not (abs(l_gpu - l_cpu) <= TOL_TRAIN_LOSS * abs(l_cpu)
            and max(gaps) < TOL_TRAIN_GRAD and u_gap < TOL_TRAIN_UPDATE):
        raise AssertionError("detector training: the card's step differs "
                             "from the CPU's")
    if not fault_shared > TOL_TRAIN_GRAD:
        raise AssertionError("detector training: the gradient limit does "
                             "not tell a missing loss term")
    return float(np.median(step_ms[1:]))


@contextlib.contextmanager
def launches_per_path():
    """Within the block, run_eval's `_run_system` and `_run_chunked` set
    K1s's and the segment sum's launch counts to 0 before each run and read
    them after it; yields the list of (path, K1s launches, segment-sum
    launches) in the order the paths ran."""
    import torch

    from sgslam_tpu_torch import run_eval
    from sgslam_tpu_torch.ops import segment

    counts = []

    def counted(fn, path):
        def run_path(*a, **k):
            _zero_counts()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            counts.append((path, _k1s_launches(),
                           segment.segment_kernel.launches))
            return out
        return run_path

    originals = {p: getattr(run_eval, p)
                 for p in ("_run_system", "_run_chunked")}
    for path, fn in originals.items():
        setattr(run_eval, path, counted(fn, path[5:]))
    try:
        yield counts
    finally:
        for path, fn in originals.items():
            setattr(run_eval, path, fn)


def phase_eval_suite(dev, name=EVAL_SEQUENCE):
    """`run_eval.main(["--only", name, ...])` at full length: the
    sequence through run_eval's System path and its chunked path, with
    K1s's and the segment sum's counts set to 0 before each path and read
    after it. Both paths must pass the row's gate with parity, and each
    must have launched both kernels."""
    from sgslam_tpu_torch import run_eval

    argv = ["--only", name, "--out", EVAL_OUT]
    with launches_per_path() as counts:
        t0 = time.perf_counter()
        res = run_eval.main(argv + (["--cpu"] if dev.type == "cpu" else []))
        wall = time.perf_counter() - t0
    row = res["sequences"][name]
    sy, ch = row["system"], row["chunked"]
    WHOLE_RUN["18 ATE m (System, chunked)"] = [round(sy["ate"], 5),
                                               round(ch["ate"], 5)]
    WHOLE_RUN["18 (path, K1s, S launches)"] = counts
    print(f"[eval] run_eval.main({argv}) in {wall:.1f} s on "
          f"{res['device']['name']} ({res['device']['power_limit']}): "
          f"{row['n_frames']} frames, distortion {row['distortion']}; "
          f"System ATE {sy['ate']:.5f} m, {sy['keyframes']} keyframes, "
          f"state {sy['state']}, {sy['wall_s']} s; chunked ATE "
          f"{ch['ate']:.5f} m, {ch['keyframes']} keyframes, lost frames "
          f"{ch['lost_frames']}, {ch['wall_s']} s; gate {row['gate_ate_m']}"
          f" m, parity_ok {row['parity_ok']}; (path, K1s launches, "
          f"segment-sum launches): {counts}")
    if not (sy["ate"] < row["gate_ate_m"] and ch["ate"] < row["gate_ate_m"]
            and row["parity_ok"]):
        raise AssertionError(f"eval {name}: System ATE {sy['ate']:.4f} m, "
                             f"chunked {ch['ate']:.4f} m, parity_ok "
                             f"{row['parity_ok']}")
    if [c[0] for c in counts] != ["system", "chunked"]:
        raise AssertionError(f"eval {name}: paths run {counts}")
    for path, k1s, seg in counts:
        if k1s < 1 or seg < 1:
            raise AssertionError(f"eval {name}, {path}: K1s launched {k1s} "
                                 f"times, the segment sum {seg}")


def _run_harness(name, main, argv):
    """Run a harness's `main(argv)` with its stdout captured; echo each
    line as `[harness] name: line` (so that the last line stays the
    contract's) and return the JSON objects it printed and its wall s."""
    import io

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    wall = time.perf_counter() - t0
    lines = buf.getvalue().splitlines()
    for line in lines:
        print(f"[harness] {name}: {line}")
    if rc != 0:
        raise AssertionError(f"harness {name} {argv}: exit code {rc}")
    return [json.loads(x) for x in lines if x.startswith("{")], wall


def _positive(label, x):
    if not (isinstance(x, (int, float)) and np.isfinite(x) and x > 0):
        raise AssertionError(f"{label}: {x!r} is not a finite positive "
                             "number")


def _launched(label, k1s: bool, seg: bool):
    """Fail unless K1s / the segment sum launched since `_zero_counts`."""
    from sgslam_tpu_torch.ops import segment

    got = (_k1s_launches(), segment.segment_kernel.launches)
    print(f"[harness] {label}: K1s launches {got[0]}, segment-sum launches "
          f"{got[1]}")
    if (k1s and got[0] < 1) or (seg and got[1] < 1):
        raise AssertionError(f"{label}: K1s / the segment sum launched "
                             f"{got} times")


def phase_harnesses(dev):
    """The measurement harnesses, each through its `main` on the card, at
    reduced depth, and `entry()` once. Cuts: `profile_chunk` 2 reps (10);
    `bench_sweep` chunk 4 only (4, 8) at depths 0 and 1 over 30 frames
    (110), no `--stages`; `bench_kernels` 2 reps of 2 calls (5 of 8);
    `bench_dist_ba` at world size 1 on NCCL (1, 2, 4, 8 shards; one card);
    `bench_dist_ba_realmap` at (1,1) only (one card), 4 LM iterations (its
    default). `bench` itself is phase 10. Each output must be well formed:
    its keys, finite positive times, the card's name and power limit, the
    realmap cost falling; K1s and the segment sum must have launched on
    each path that runs them (in the spawned ranks of the two distributed
    benches, as their rank 0 reports)."""
    import torch

    from sgslam_tpu_torch import (bench_dist_ba, bench_dist_ba_realmap,
                                  bench_kernels, bench_sweep, entry,
                                  profile_chunk)
    from sgslam_tpu_torch.utils import timing

    card = timing.card(dev)
    walls = {}

    def labelled(name, label):
        if not str(label).startswith(card):
            raise AssertionError(f"{name}: labelled {label!r}, not {card!r}")

    _zero_counts()
    (res,), walls["profile_chunk"] = _run_harness(
        "profile_chunk", profile_chunk.main,
        ["--reps", str(HARNESS_PROFILE_REPS)])
    labelled("profile_chunk", res["device"])
    rows = ("chunk4_full_kf_allowed", "chunk4_no_kf", "extract4",
            "chunk4_no_kf_no_det_no_sem", "track_step_1",
            "insert_and_maintain", "local_ba_step")
    if set(res["ms"]) != set(rows) or res["map"]["keyframes"] < 2:
        raise AssertionError(f"profile_chunk: {res}")
    for r in rows:
        _positive(f"profile_chunk {r}", res["ms"][r])
    _launched("profile_chunk", True, True)

    _zero_counts()
    sweep, walls["bench_sweep"] = _run_harness(
        "bench_sweep", bench_sweep.main,
        ["--chunks", "4", "--depths", "0,1", "--frames",
         str(HARNESS_SWEEP_FRAMES)])
    if [(r["chunk"], r["depth"]) for r in sweep] != [(4, 0), (4, 1)]:
        raise AssertionError(f"bench_sweep: {sweep}")
    for r in sweep:
        labelled("bench_sweep", r["device"])
        _positive("bench_sweep fps", r["fps"])
        if r["hamming"] != "k1s" or r["min_inliers"] < MIN_INLIERS:
            raise AssertionError(f"bench_sweep: {r}")
    _launched("bench_sweep", True, True)

    _zero_counts()
    path = os.path.join(HARNESS_OUT, "kernels_chip_smoke.json")
    _, walls["bench_kernels"] = _run_harness(
        "bench_kernels", bench_kernels.main,
        ["--reps", str(HARNESS_KERNEL_REPS), "--k", str(HARNESS_KERNEL_K),
         "--out", path])
    with open(path) as f:
        table = json.load(f)
    labelled("bench_kernels", table["device"])
    for key in ("bf16_gemm_tflops", "hbm_stream_gbps"):
        _positive(f"bench_kernels {key}", table["calibration"][key])
    timed = {k: r for k, r in table["kernels"].items() if "ms" in r}
    if len(timed) != 7 or not all(any(k.startswith(p) for k in timed)
                                  for p in ("hamming_k1", "hamming_search")):
        raise AssertionError(f"bench_kernels rows: {list(table['kernels'])}")
    for k, r in timed.items():
        _positive(f"bench_kernels {k}", r["ms"])
        if r.get("work") != "not counted":
            _positive(f"bench_kernels {k} share", r["share_of_bound"])
    _launched("bench_kernels", True, True)

    dist_rows, walls["bench_dist_ba"] = _run_harness(
        "bench_dist_ba", bench_dist_ba.main, ["--devices", "1"])
    if [r["pt_shards"] for r in dist_rows] != [1]:
        raise AssertionError(f"bench_dist_ba: {dist_rows}")
    labelled("bench_dist_ba", dist_rows[0]["device"])
    _positive("bench_dist_ba wall_s", dist_rows[0]["wall_s"])
    _positive("bench_dist_ba segment-sum launches (rank 0)",
              dist_rows[0]["segment_sum_launches"])

    path = os.path.join(HARNESS_OUT, "multichip_chip_smoke.json")
    _, walls["bench_dist_ba_realmap"] = _run_harness(
        "bench_dist_ba_realmap", bench_dist_ba_realmap.main,
        ["--devices", "1", "--iters", str(HARNESS_REALMAP_ITERS), "--out",
         path])
    with open(path) as f:
        scale = json.load(f)
    labelled("bench_dist_ba_realmap", scale["device"])
    (lay,) = scale["layouts"]
    _positive("bench_dist_ba_realmap wall_s", lay["wall_s"])
    _positive("bench_dist_ba_realmap segment-sum launches (rank 0)",
              lay["segment_sum_launches"])
    if not (lay["mesh"] == "kf=1 x pt=1"
            and lay["cost_after"] < scale["cost_before"]):
        raise AssertionError(f"bench_dist_ba_realmap: {scale}")

    _zero_counts()
    t0 = time.perf_counter()
    fn, args = entry.entry(dev)
    Tcw, matched, n_inl = fn(*args)[:3]
    torch.cuda.synchronize()
    walls["entry"] = time.perf_counter() - t0
    if not (bool(torch.isfinite(Tcw).all()) and tuple(Tcw.shape) == (7,)
            and int(n_inl) >= MIN_INLIERS
            and int((matched >= 0).sum()) >= MIN_INLIERS):
        raise AssertionError(f"entry(): pose {Tcw}, {int(n_inl)} inliers")
    print(f"[harness] entry(): pose {Tcw.cpu().numpy().round(6).tolist()}, "
          f"{int(n_inl)} inliers, {int((matched >= 0).sum())} matched")
    _launched("entry()", True, False)
    print(f"[harness] wall s per harness on {card}: "
          + ", ".join(f"{k} {v:.1f}" for k, v in walls.items()))


def _grads(dev, steps, batch, seed, b, drop_loc=False):
    """A fresh trainer's model (seed `seed`) with the gradients of
    `batched_loss` on batch `b`; `drop_loc` leaves the localization term
    out of the loss (a planted fault)."""
    from sgslam_tpu_torch import train_detector
    from sgslam_tpu_torch.models import detector_train as dt

    t = train_detector.Trainer(steps, batch, seed=seed, device=dev)
    full = dt.multibox_loss

    def cls_only(*args, **kwargs):
        _, parts = full(*args, **kwargs)
        return parts[0], parts

    dt.multibox_loss = cls_only if drop_loc else full
    try:
        loss, _ = dt.batched_loss(t.model, t.anchors, None,
                                  *[x.to(t.device) for x in b])
    finally:
        dt.multibox_loss = full
    loss.backward()
    return t.model


def _grad_gap(card, cpu, shared_only: bool = False) -> float:
    """The largest gradient difference of any parameter tensor, over that
    tensor's largest CPU gradient entry (a missing gradient counts as
    zeros); `shared_only` skips the tensors that have no gradient on the
    card's side."""
    import torch

    gap = 0.0
    for (_, pg), (_, pc) in zip(card.named_parameters(),
                                cpu.named_parameters()):
        if pg.grad is None and shared_only:
            continue
        g = torch.zeros_like(pc.grad) if pg.grad is None else pg.grad.cpu()
        scale = float(pc.grad.abs().max()) + 1e-12
        gap = max(gap, float((g - pc.grad).abs().max()) / scale)
    return gap


def main() -> int:
    try:
        import torch
    except ImportError:
        return _fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        return _fail("no CUDA device: this smoke run needs a GPU")
    try:
        import sgslam_tpu_torch  # noqa: F401
    except ImportError as e:
        return _fail(f"the port is not beside this script ({e})")

    # full float32 everywhere: no TF32 in matmuls (resize pyramid, BA)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)

    from sgslam_tpu_torch.utils import timing

    t_start = time.perf_counter()
    cfgs = path_configs()
    shapes, cases = k1_shapes(cfgs), k1s_cases(cfgs)
    phase_build()
    from sgslam_tpu_torch.ops import segment

    rec = SegmentInputs(segment.segment_kernel)
    segment.segment_kernel = rec     # every phase's sums recorded
    max_err = phase_k1_parity(dev, rng, shapes)
    max_err_s = phase_k1s_parity(dev, cases)
    kernels = {"hamming_matrix": phase_k1_time(dev, rng, max_err, shapes),
               "hamming_search": phase_k1s_time(dev, max_err_s),
               "pose_opt": phase_pose_opt(dev),
               "fast_detect": phase_fast_detect(dev)}

    def run(phase, fn, *args):
        rec.phase = phase
        return fn(dev, *args)

    run("4", phase_main_path, kernels)
    run("5", phase_eval_map)
    run("6", phase_capacity_pressure)
    det_frames, frames = run("7", phase_semantic_system, kernels)
    run("8", phase_semantic_objects)
    run("9", phase_card_vs_cpu, det_frames, frames[40:42])
    _, seg_launches = run("10", phase_bench_path, kernels)
    run("11a", phase_loop_closing)
    run("11b", phase_forced_loop)
    run("12", phase_relocalization)
    run("13", phase_stereo)
    run("14", phase_mono)
    run("15", phase_cli)
    run("16", phase_scale_out)
    run("17", phase_detector_training)
    run("18", phase_eval_suite)
    run("19", phase_harnesses)
    rec.phase = "-"
    kernels["segment_sum"] = phase_segment(dev, rec, seg_launches)
    if any(k["launches"] < 1 for name, k in kernels.items()
           if name != "hamming_matrix"):      # K1: held and timed, off path
        raise AssertionError("a kernel of the path was never launched")
    if "jax" in sys.modules or "sgslam_tpu" in sys.modules:
        raise AssertionError("the port imported JAX or the JAX package")

    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - t_start:.1f} s")
    print(f"[whole-run] {json.dumps(WHOLE_RUN)}")
    print(json.dumps({"kernels": list(kernels.values())}))
    print(timing.smi("name,power.limit"))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
