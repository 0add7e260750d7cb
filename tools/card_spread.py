#!/usr/bin/env python3
"""Whole runs of the port under one-ulp image moves, on the card or the CPU:
how often run_eval's 2-lap stress circuit closes a loop, where the chunked
kidnap of tests/test_chunked_full_system.py lands, and what the kidnap's
relocalization computes.

    python tools/card_spread.py draws build/jax_draws.npz          # JAX, CPU
    python tools/card_spread.py stress system|chunked [--device D]
                                [--draws build/jax_draws.npz] -- -1,0,1
    python tools/card_spread.py correction system|chunked 0,1 [--device D]
                                [--dump DIR]
    python tools/card_spread.py kidnap 4 11 [--device D]
    python tools/card_spread.py reloc-dump OUT.pt [--device D] [--cpu-draws]
    python tools/card_spread.py reloc-replay OUT.pt
    python tools/card_spread.py mono-draws build/jax_mono_draws.npz  # JAX
    python tools/card_spread.py mono [--device D] [--draws FILE]
    python tools/card_spread.py eval SEQUENCE [--device D] -- -1,0,1,2

The images move as tools/parity_spread.py moves the reference's (seed s:
frame i's gray by signs from default_rng(2000 s + i), its depth by
default_rng(3000 s + i); s = -1 leaves them as rendered).

  draws         writes the random bits behind the reference's Sim3 / PnP
                RANSAC draws, `randint(PRNGKey(seed), (iters, k), ...)`
                for seeds 0-255 (needs JAX; the other commands do not);
  stress        chip_smoke.py phase 11a's sequence through `System` or
                `ChunkedTracker(chunk=4, fetch_every=6, loop)`, the
                reference's draws replayed from `--draws`; stops at the
                first accepted closure and prints it;
  correction    the stress circuit with its loop correction opened up: the
                verified Sim3 against the ground truth's relative pose, the
                keyframe ATE before, after the essential graph and fusion,
                after the global BA, and the ATE at the end; `--dump DIR`
                writes each correction's input (the map in the checkpoint
                layout, the pair, the Sim3, the loop edges, the ground
                truth) for `tools/parity_spread.py correction`, which runs
                the reference's correction on it;
  kidnap        chip_smoke.py phase 12's run for seeds FIRST..LAST: the last
                four frames' gaps to the map's own estimate;
  reloc-dump    phase 12's rendered run with its relocalization recorded:
                the map and features it got, every PnP input and output,
                the pose that `track_step` refined (default draws, or the
                CPU generator's with --cpu-draws);
  reloc-replay  re-runs a dump's PnP (same samples) and `track_step` on the
                CPU: whether the card's relocalization differs from the
                CPU's on the same inputs;
  mono-draws    writes the random bits behind the reference MonoTracker's
                initialization draws (`PRNGKey(17)` split once per attempt,
                then `initialize_mono`'s split and two `randint`s), for 30
                attempts (needs JAX);
  mono          chip_smoke.py phase 14's run (`System.monocular`, 30 frames
                at 640x480) with the reference's initialization draws
                replayed from `--draws` (the card's own generator without
                it): each attempt's outcome, the frame the run initializes
                at, and again on the CPU each attempt with the same
                matches and draws;
  eval          one sequence of the accuracy suite (`run_eval`'s name, for
                example dynamic_640_walkers_circuit) through run_eval's own
                System and chunked paths (`_run_system`, `_run_chunked`, the
                shipped detector), as rendered (seed -1) and moved by one
                ulp (`debug_stress.moved_frames`): one JSON line per run
                with its ATE, loops closed and keyframes, and the device's
                name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

SEEDS = 256
SHAPES = {3: 128, 6: 256}        # k -> iters: Sim3 (128, 3), PnP (256, 6)


def cmd_draws(out):
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    arrays = {}
    for k, iters in SHAPES.items():
        hi, lo = [], []
        for s in range(SEEDS):
            # jax.random.randint's two halves: split, then 32 bits each
            k1, k2 = jax.random.split(jax.random.PRNGKey(s))
            hi.append(np.asarray(jax.random.bits(k1, (iters, k), jnp.uint32)))
            lo.append(np.asarray(jax.random.bits(k2, (iters, k), jnp.uint32)))
        arrays[f"hi_{k}"], arrays[f"lo_{k}"] = np.stack(hi), np.stack(lo)
    np.savez_compressed(out, **arrays)
    bits = dict(np.load(out))
    rng = np.random.default_rng(0)
    for _ in range(50):
        k = int(rng.choice(list(SHAPES)))
        s, nv = int(rng.integers(SEEDS)), int(rng.integers(3000))
        want = jax.random.randint(jax.random.PRNGKey(s), (SHAPES[k], k), 0,
                                  max(nv, k))
        if not (randint_from_bits(bits, s, nv, k) == np.asarray(want)).all():
            raise AssertionError(f"draws differ: seed {s}, n_valid {nv}")
    print(f"wrote {out}: the reference's draws for seeds 0-{SEEDS - 1}")


def randint_from_bits(bits, seed, n_valid, k):
    """jax.random.randint(PRNGKey(seed), (iters, k), 0, max(n_valid, k))
    with 32-bit integers, from its random bits."""
    return _randint(bits[f"hi_{k}"][seed], bits[f"lo_{k}"][seed],
                    max(int(n_valid), k))


def _randint(hi, lo, span):
    """`randint(key, shape, 0, span)` from the bits of the key's two
    halves: the remainder of their combination by the span, in uint32
    arithmetic."""
    span = np.uint64(span)
    hi, lo = hi.astype(np.uint64), lo.astype(np.uint64)
    mult = (np.uint64(65536) % span) ** 2 % span
    off = ((hi % span) * mult + (lo % span)) & np.uint64(0xFFFFFFFF)
    return (off % span).astype(np.int64)


MONO_ATTEMPTS = 30


def cmd_mono_draws(out):
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    arrays = {n: [] for n in ("hi_f", "lo_f", "hi_h", "lo_h")}
    key = jax.random.PRNGKey(17)
    for _ in range(MONO_ATTEMPTS):
        key, sub = jax.random.split(key)
        for name, k, m in zip("fh", jax.random.split(sub), (8, 4)):
            k1, k2 = jax.random.split(k)
            arrays[f"hi_{name}"].append(np.asarray(
                jax.random.bits(k1, (200, m), jnp.uint32)))
            arrays[f"lo_{name}"].append(np.asarray(
                jax.random.bits(k2, (200, m), jnp.uint32)))
    np.savez_compressed(out, **{k: np.stack(v) for k, v in arrays.items()})
    bits = dict(np.load(out))
    key = jax.random.PRNGKey(17)
    rng = np.random.default_rng(0)
    for a in range(MONO_ATTEMPTS):
        key, sub = jax.random.split(key)
        kf, kh = jax.random.split(sub)
        n = int(rng.integers(8, 3000))
        for name, k, m in (("f", kf, 8), ("h", kh, 4)):
            want = np.asarray(jax.random.randint(k, (200, m), 0, n))
            got = _randint(bits[f"hi_{name}"][a], bits[f"lo_{name}"][a], n)
            if not (got == want).all():
                raise AssertionError(f"mono draws differ: attempt {a}")
    print(f"wrote {out}: the reference's MonoTracker draws for "
          f"{MONO_ATTEMPTS} attempts")


def cmd_mono(device, draws_file):
    import torch

    import chip_smoke as cs
    from sgslam_tpu_torch.io import synthetic
    from sgslam_tpu_torch.optim import initializer
    from sgslam_tpu_torch.slam import mono
    from sgslam_tpu_torch.slam.system import System

    dev = _setup(device)
    cfg = cs.mono_config()
    seq = synthetic.SyntheticSequence(cfg.camera, n_frames=cs.MONO_FRAMES,
                                      device=dev)
    s = System.monocular(cfg, enable_semantic=False, enable_mapping=False,
                         device=dev)
    if draws_file:
        bits = dict(np.load(draws_file))
        attempt = [0]

        def draws(n_valid):
            a, n = attempt[0], int(n_valid)
            attempt[0] += 1
            return tuple(torch.as_tensor(_randint(
                bits[f"hi_{x}"][a], bits[f"lo_{x}"][a], n), device=dev)
                for x in "fh")

        s.tracker._draws = draws
    outcomes = []
    orig = mono.initialize_mono

    def logged(cam, p1, p2, valid, generator=None, *, iters=200,
               samples=None):
        if samples is None:
            n_valid = torch.clamp(torch.sum(valid.to(torch.int32)), min=8)
            samples = (initializer.draw_ranks(n_valid, iters, 8, generator),
                       initializer.draw_ranks(n_valid, iters, 4, generator))
        out = orig(cam, p1, p2, valid, samples=samples)
        cpu = orig(cam, *(x.cpu() for x in (p1, p2, valid)),
                   samples=tuple(x.cpu() for x in samples))
        outcomes.append((bool(out["ok"]), bool(cpu["ok"]),
                         bool(out["used_H"]), bool(cpu["used_H"])))
        return out

    mono.initialize_mono = logged
    init = None
    try:
        for i in range(cs.MONO_FRAMES):
            s.track_monocular(seq.frame(i)[0])
            if s.state == "OK":
                init = i
                break
    finally:
        mono.initialize_mono = orig
    print(json.dumps({
        "device": str(dev), "draws": draws_file or "own generator",
        "initialized_at": init,
        "attempts (ok here, ok on the CPU, used_H here, on the CPU)":
            outcomes,
        "ok differs from the CPU's": sum(o[0] != o[1] for o in outcomes)}))


def _setup(device):
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    if dev.type == "cpu":
        torch.set_num_threads(int(os.environ.get("THREADS", "2")))
    return dev


def cmd_stress(path, seeds, device, draws_file):
    import torch

    import chip_smoke as cs
    from sgslam_tpu_torch import run_eval
    from sgslam_tpu_torch.debug_stress import moved_frames
    from sgslam_tpu_torch.io import synthetic
    from sgslam_tpu_torch.slam import loop_closing as lc
    from sgslam_tpu_torch.slam import scan_pipeline
    from sgslam_tpu_torch.slam.system import System

    dev = _setup(device)
    bits = dict(np.load(draws_file))

    def draws(seed, n_valid, iters, k):
        return torch.as_tensor(randint_from_bits(bits, seed, n_valid, k),
                               device=dev)

    class Closed(Exception):
        pass

    def correct(self, m, kf_cur, kf_loop, S, cov):
        raise Closed((int(kf_cur), int(kf_loop)))

    lc.LoopCloser._correct = correct
    cfg = run_eval._make_cfg(False)
    n = cs.STRESS_FRAMES
    seq = synthetic.SyntheticSequence(
        cfg.camera, n_frames=n, planes=synthetic.ROOM_CLOSED,
        poses=synthetic.make_circuit_trajectory(n, loops=2.15, device=dev),
        device=dev)
    rendered = [seq.frame(i) for i in range(n)]
    for s in seeds:
        t0 = time.time()
        frames = rendered if s < 0 else moved_frames(rendered, s)
        res = {"path": path, "seed": s, "closed": None}
        try:
            if path == "system":
                sy = System(cfg, enable_semantic=False, enable_mapping=False,
                            device=dev)
                sy.loop.draws = draws
                for i, (g, d) in enumerate(frames):
                    res["frame"] = i
                    sy.track_rgbd(g, d)
            else:
                run_eval.drive_chunked(scan_pipeline.ChunkedTracker(
                    cfg, chunk=cs.BENCH_CHUNK, fetch_every=cs.BENCH_FETCH,
                    loop=lc.LoopCloser(cfg, device=dev, draws=draws),
                    device=dev), frames)
        except Closed as e:
            res["closed"] = list(e.args[0])
        res["s"] = round(time.time() - t0, 1)
        print(json.dumps(res), flush=True)


def _rel_err(T_est, T_gt):
    """(translation m, rotation deg) of T_est o inverse(T_gt)."""
    from sgslam_tpu_torch.geometry import se3

    d = se3.se3_compose(T_est, se3.se3_inverse(T_gt))
    w = float(d[0].abs().clamp(max=1.0))
    return (round(float(d[4:7].norm()), 4),
            round(float(2 * np.degrees(np.arccos(w))), 3))


def cmd_correction(path, seeds, device, dump=None):
    """The stress circuit with its loop correction opened up: the verified
    Sim3 against the ground truth's relative pose, the keyframe ATE before
    the correction, after the essential graph alone and after the whole
    correction, and the ATE at the end."""
    import dataclasses

    import torch

    import chip_smoke as cs
    from sgslam_tpu_torch import run_eval
    from sgslam_tpu_torch.debug_stress import kf_ate, moved_frames
    from sgslam_tpu_torch.geometry import se3
    from sgslam_tpu_torch.io import checkpoint
    from sgslam_tpu_torch.slam import loop_closing as lc
    from sgslam_tpu_torch.slam import scan_pipeline
    from sgslam_tpu_torch.slam.system import System

    dev = _setup(device)
    cfg = run_eval._make_cfg(False)
    _, rendered, gt = cs.eval_sequence("static_640_circuit_2laps_stress",
                                       cfg, dev)
    gt_cw = se3.se3_inverse(torch.as_tensor(gt)).to(dev)
    no_gba = dataclasses.replace(cfg, loop=dataclasses.replace(
        cfg.loop, run_global_ba=False))
    correct = lc.LoopCloser._correct

    def spy(self, m, kf_cur, kf_loop, S, cov):
        fid = m.kf_frame_id.cpu().numpy()
        rel_gt = se3.se3_compose(gt_cw[fid[kf_cur]],
                                 se3.se3_inverse(gt_cw[fid[kf_loop]]))
        rel_map = se3.se3_compose(m.kf_pose[kf_cur],
                                  se3.se3_inverse(m.kf_pose[kf_loop]))
        print(f"[correction] loop ({kf_cur}, {kf_loop}), frames "
              f"({fid[kf_cur]}, {fid[kf_loop]}), scale {float(S[7]):.4f}: "
              f"the Sim3 vs the ground truth's relative pose "
              f"{_rel_err(se3.sim3_to_se3(S), rel_gt)} (m, deg); the map's "
              f"{_rel_err(rel_map, rel_gt)}; keyframe ATE before "
              f"{kf_ate(m, gt):.4f} m", flush=True)
        if dump is not None:
            os.makedirs(dump, exist_ok=True)
            edges = self.loop_edges
            checkpoint.save_map(
                os.path.join(dump, f"correction_{kf_cur}_{kf_loop}.npz"), m,
                {"kf_cur": kf_cur, "kf_loop": kf_loop, "S": S.cpu().numpy(),
                 "gt": gt, "edges_i": [e[0] for e in edges],
                 "edges_j": [e[1] for e in edges],
                 "edges_s": np.reshape([e[2] for e in edges], (-1, 8))})
        eg = lc.LoopCloser(no_gba, device=dev)
        eg.loop_edges = list(self.loop_edges)
        m_eg, _ = correct(eg, m, kf_cur, kf_loop, S, cov)
        out = correct(self, m, kf_cur, kf_loop, S, cov)
        print(f"[correction] keyframe ATE after the essential graph and the "
              f"fusion {kf_ate(m_eg, gt):.4f} m, after the global BA "
              f"{kf_ate(out[0], gt):.4f} m", flush=True)
        return out

    lc.LoopCloser._correct = spy
    for seed in seeds:
        frames = rendered if seed < 0 else moved_frames(rendered, seed)
        if path == "system":
            sy = System(cfg, enable_semantic=False, enable_mapping=False,
                        device=dev)
            for g, d in frames:
                sy.track_rgbd(g, d)
            m, rmse = sy.tracker.map, cs._ate(sy.tracker, gt)
            loops = sy.loop.loops_closed
        else:
            ct = scan_pipeline.ChunkedTracker(
                cfg, chunk=cs.BENCH_CHUNK, fetch_every=cs.BENCH_FETCH,
                loop=lc.LoopCloser(cfg, device=dev), device=dev)
            run_eval.drive_chunked(ct, frames)
            m, rmse = ct.map, cs._ate_cw(ct.poses_cw(), gt)
            loops = ct.loop.loops_closed
        print(f"[correction] {path}, seed {seed}: loops {loops}, ATE "
              f"{rmse:.5f} m, keyframe ATE {kf_ate(m, gt):.4f} m at the "
              f"end", flush=True)


def _kidnap_frames(dev):
    import chip_smoke as cs
    from sgslam_tpu_torch.io import synthetic

    cfg = cs.kidnap_config()
    seq = synthetic.SyntheticSequence(
        cfg.camera, n_frames=cs.KIDNAP_FRAMES, planes=synthetic.ROOM_CLOSED,
        poses=synthetic.make_circuit_trajectory(cs.KIDNAP_FRAMES, loops=1.0,
                                                device=dev), device=dev)
    return cfg, [seq.frame(i) for i in range(cs.KIDNAP_FRAMES)]


def cmd_kidnap(first, last, device):
    import chip_smoke as cs
    from sgslam_tpu_torch.debug_stress import moved_frames

    dev = _setup(device)
    cfg, rendered = _kidnap_frames(dev)
    best = []
    for s in range(first, last + 1):
        frames = rendered if s < 0 else moved_frames(rendered, s)
        relocs, tail, errs = cs.kidnap_run(dev, cfg, frames)
        best.append(min(errs))
        print(f"[kidnap] seed {s}: relocalizations {relocs}, tail inliers "
              f"{tail}, gaps {[round(e, 4) for e in errs]} m, smallest "
              f"{min(errs):.4f}", flush=True)
    print(f"[kidnap] the gate (< {cs.RELOC_GATE_M} m) holds on "
          f"{sum(b < cs.RELOC_GATE_M for b in best)} of {len(best)}; "
          f"smallest gaps {np.round(sorted(best), 4).tolist()}")


def cmd_reloc_dump(out, device, cpu_draws):
    import torch

    import chip_smoke as cs
    from sgslam_tpu_torch.geometry.epipolar import seeded_ranks
    from sgslam_tpu_torch.slam import loop_closing as lc
    from sgslam_tpu_torch.slam import scan_pipeline, tracking

    dev = _setup(device)
    cfg, frames = _kidnap_frames(dev)
    rec = {"pnp": [], "track": []}
    pnp, track_step = lc.ransac_pnp, tracking.track_step
    in_reloc = [False]

    def pnp_spy(cam, pw, uv, ok, *a, samples=None, **k):
        T, inl, n = pnp(cam, pw, uv, ok, *a, samples=samples, **k)
        rec["pnp"].append(dict(pw=pw.cpu(), uv=uv.cpu(), ok=ok.cpu(),
                               samples=samples.cpu(), T=T.cpu(), n=int(n)))
        return T, inl, n

    def track_spy(cfg_, m, feats, T, *a, **k):
        r = track_step(cfg_, m, feats, T, *a, **k)
        if in_reloc[0]:
            rec["track"].append(dict(T_in=T.cpu(), T=r[0].cpu(),
                                     n=int(r[2])))
        return r

    reloc = lc.LoopCloser.relocalize

    def reloc_spy(self, m, feats):
        in_reloc[0] = True
        rec["map"], rec["feats"] = m.to("cpu"), feats.to("cpu")
        out = reloc(self, m, feats)
        in_reloc[0] = False
        return out

    lc.ransac_pnp, tracking.track_step = pnp_spy, track_spy
    lc.LoopCloser.relocalize = reloc_spy
    if cpu_draws:
        init = lc.LoopCloser.__init__

        def init_cpu_draws(self, *a, **k):
            init(self, *a, **k)
            self.draws = lambda s, nv, it, kk: seeded_ranks(
                s, nv.cpu(), it, kk).to(nv.device)

        lc.LoopCloser.__init__ = init_cpu_draws
    # the frame relocalized is the first kidnapped chunk's last
    f_reloc = cs.KIDNAP_TO + cs.BENCH_CHUNK - 1
    own = {}
    flush = scan_pipeline._ChunkRunnerBase.flush

    def flush_spy(self):
        """The map's own trajectory, at the flush after the mapping."""
        flush(self)
        if "own" not in own:
            own["own"] = None             # poses_cw() flushes again
            own["own"] = np.asarray(self.poses_cw())

    scan_pipeline._ChunkRunnerBase.flush = flush_spy
    relocs, tail, errs = cs.kidnap_run(dev, cfg, frames)
    rec["own"] = own["own"]
    gap = lambda T: float(np.linalg.norm(  # noqa: E731
        np.asarray(T)[4:7] - rec["own"][f_reloc][4:7]))
    for p in rec["pnp"]:
        print(f"[reloc-dump] PnP inliers {p['n']} of {int(p['ok'].sum())} "
              f"matches, pose {gap(p['T']):.4f} m from the map's own")
    for t in rec["track"]:
        print(f"[reloc-dump] track_step: {t['n']} inliers, {gap(t['T_in']):.4f}"
              f" m -> {gap(t['T']):.4f} m from the map's own")
    print(f"[reloc-dump] relocalizations {relocs}, tail inliers {tail}, last "
          f"four frames' gaps {[round(e, 4) for e in errs]} m")
    torch.save(rec, out)


def cmd_reloc_replay(dump):
    import torch

    import chip_smoke as cs
    from sgslam_tpu_torch.optim.pnp import ransac_pnp
    from sgslam_tpu_torch.slam import tracking

    _setup("cpu")
    cfg = cs.kidnap_config()
    rec = torch.load(dump, weights_only=False, map_location="cpu")
    f_reloc = cs.KIDNAP_TO + cs.BENCH_CHUNK - 1
    gap = lambda T: float(np.linalg.norm(  # noqa: E731
        np.asarray(T)[4:7] - rec["own"][f_reloc][4:7]))
    for p in rec["pnp"]:
        T, _, n = ransac_pnp(cfg.camera, p["pw"], p["uv"], p["ok"],
                             samples=p["samples"], iters=p["samples"].shape[0])
        print(f"[reloc-replay] PnP, the same samples: dump {p['n']} inliers "
              f"{gap(p['T']):.4f} m, CPU {int(n)} inliers {gap(T):.4f} m")
    for t in rec["track"]:
        T, _, n, *_ = tracking.track_step(cfg, rec["map"], rec["feats"],
                                          t["T_in"], "cpu")
        print(f"[reloc-replay] track_step from the same seed: dump "
              f"{t['n']} inliers {gap(t['T']):.4f} m, CPU {int(n)} inliers "
              f"{gap(T):.4f} m")


def cmd_eval(name, seeds, device):
    from sgslam_tpu_torch import run_eval
    from sgslam_tpu_torch.debug_stress import moved_frames
    from sgslam_tpu_torch.models.detector import Detector2D

    dev = _setup(device)
    spec = run_eval._sequences(False, dev)[name]
    cfg = run_eval._make_cfg(spec["distort"])
    detector = (Detector2D(cfg.detector, device=dev)
                if spec["kind"] == "dynamic" else None)
    seq, rendered = run_eval._render(cfg, spec, dev)
    info = run_eval.device_info(dev)
    for s in seeds:
        frames = rendered if s < 0 else moved_frames(rendered, s)
        for path, run in (("system", run_eval._run_system),
                          ("chunked", run_eval._run_chunked)):
            r = run(cfg, spec, frames, seq, detector, dev)
            print(json.dumps({
                "sequence": name, "seed": s, "path": path,
                "ate": round(r["ate"], 5), "loops_closed": r["loops_closed"],
                "keyframes": r["keyframes"], "wall_s": r["wall_s"],
                "device": info["name"], "power_limit": info["power_limit"]}),
                flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("draws")
    p.add_argument("out")
    p = sub.add_parser("stress")
    p.add_argument("path", choices=["system", "chunked"])
    p.add_argument("seeds", help="comma-separated; -1 is the rendered "
                   "sequence (put -- before a list that starts with it)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--draws", default=os.path.join("build", "jax_draws.npz"))
    p = sub.add_parser("correction")
    p.add_argument("path", choices=["system", "chunked"])
    p.add_argument("seeds")
    p.add_argument("--device", default="cuda")
    p.add_argument("--dump", default=None)
    p = sub.add_parser("kidnap")
    p.add_argument("first", type=int)
    p.add_argument("last", type=int)
    p.add_argument("--device", default="cuda")
    p = sub.add_parser("reloc-dump")
    p.add_argument("out")
    p.add_argument("--device", default="cuda")
    p.add_argument("--cpu-draws", action="store_true")
    p = sub.add_parser("reloc-replay")
    p.add_argument("dump")
    p = sub.add_parser("mono-draws")
    p.add_argument("out")
    p = sub.add_parser("mono")
    p.add_argument("--device", default="cuda")
    p.add_argument("--draws", default=None)
    p = sub.add_parser("eval")
    p.add_argument("sequence")
    p.add_argument("seeds", help="comma-separated; -1 is the rendered "
                   "sequence (put -- before a list that starts with it)")
    p.add_argument("--device", default="cuda")
    a = ap.parse_args()
    if a.cmd == "draws":
        cmd_draws(a.out)
    elif a.cmd == "stress":
        cmd_stress(a.path, [int(s) for s in a.seeds.split(",")], a.device,
                   a.draws)
    elif a.cmd == "correction":
        cmd_correction(a.path, [int(x) for x in a.seeds.split(",")],
                       a.device, a.dump)
    elif a.cmd == "kidnap":
        cmd_kidnap(a.first, a.last, a.device)
    elif a.cmd == "reloc-dump":
        cmd_reloc_dump(a.out, a.device, a.cpu_draws)
    elif a.cmd == "mono-draws":
        cmd_mono_draws(a.out)
    elif a.cmd == "mono":
        cmd_mono(a.device, a.draws)
    elif a.cmd == "eval":
        cmd_eval(a.sequence, [int(x) for x in a.seeds.split(",")], a.device)
    else:
        cmd_reloc_replay(a.dump)
    return 0


if __name__ == "__main__":
    sys.exit(main())
