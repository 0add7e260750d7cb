"""Motion-only BA's kernel (`csrc/pose_opt.cu`) against the plain body on
the card, over seeded inputs (`ops/pose_cases.py`): stereo, mono, mixed
and all-invalid rows, N of 4096, 37 and 1, and the callers' rounds,
iterations and guard. No JAX here: the CPU comparison with the reference
is `test_torch_pose_opt.py`. The tests without the `cuda` mark check the
dispatch on the CPU: a CPU call never reaches the kernel, and a tensor off
the CPU never takes the plain body (a build failure:
`test_torch_cuda_lib.py`).

On a machine with a card:
    python -m pytest --noconftest tests/test_torch_pose_opt_cuda.py
"""

import numpy as np
import pytest
import torch

from sgslam_tpu_torch.ops import pose_cases, pose_opt_cuda
from sgslam_tpu_torch.optim import pose_opt
from sgslam_tpu_torch.utils import timing

# track_step's stage 1 and stage 2, its brute-force fallback, ransac_pnp
CALLERS = {"stage1": (2, 5, False), "stage2": (3, 5, False),
           "fallback": (4, 10, True), "pnp": (2, 8, True)}
TOL_POSE = 1e-5
# observations whose chi2 lies this close to the gate may flip
CHI2_BAND = 1e-3


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(n, mix):
    return pose_cases.pose_case(np.random.default_rng(1000 * n + len(mix)),
                                n, mix)


def _run(args, rounds, iters, guarded):
    """pose_optimization on the card: (outputs, launches, tracer counts)."""
    m = timing.Metrics()
    before = pose_opt_cuda.pose_opt_kernel.launches
    with timing.tracing(m):
        out = pose_opt.pose_optimization(pose_cases.camera(), *args,
                                         rounds=rounds, iters=iters,
                                         guarded=guarded)
    return out, pose_opt_cuda.pose_opt_kernel.launches - before, m.counters


@pytest.mark.cuda
@pytest.mark.parametrize("caller", list(CALLERS))
@pytest.mark.parametrize("mix", pose_cases.MIXES)
@pytest.mark.parametrize("n", [4096, 37, 1])
def test_kernel_matches_plain_on_gpu(cuda_device, n, mix, caller):
    """Poses within TOL_POSE and inlier masks equal but for rows near the
    gate. A single valid row cannot fix six degrees of freedom: the damped
    system's solution along the free directions is rounding noise (the
    plain body in float32 ends 0.05-1.6 away from its float64 result on
    these cases), so at N = 1 the pose is not compared; the kernel's mask
    and count must then follow the gate at its own pose, and the pose be
    a finite unit quaternion and translation."""
    rounds, iters, guarded = CALLERS[caller]
    case = _case(n, mix)
    args = pose_cases.pose_args(case, cuda_device)
    (T, inl, cnt), launches, counts = _run(args, rounds, iters, guarded)
    torch.cuda.synchronize()
    assert launches == 1
    assert counts["pose_opt.calls"] == counts["pose_opt.kernel"] == 1
    Tp, inl_p, cnt_p = pose_opt.pose_optimization_reference(
        pose_cases.camera(), *args, rounds=rounds, iters=iters,
        guarded=guarded)
    assert T.dtype == Tp.dtype and inl.dtype == inl_p.dtype
    assert cnt.dtype == cnt_p.dtype and cnt.shape == cnt_p.shape
    assert int(cnt) == int(inl.sum())
    inl, inl_p = inl.cpu().numpy(), inl_p.cpu().numpy()
    if n == 1 and case["valid"].any():
        assert torch.isfinite(T).all()
        assert abs(float(torch.linalg.vector_norm(T[:4])) - 1.0) < 1e-6
        chi2, gate = pose_cases.chi2(case, T)
        if abs(chi2[0] - gate[0]) >= CHI2_BAND:
            assert inl[0] == (chi2[0] <= gate[0])
        return
    np.testing.assert_allclose(T.cpu().numpy(), Tp.cpu().numpy(),
                               atol=TOL_POSE, rtol=0)
    chi2, gate = pose_cases.chi2(case, Tp)
    near = np.abs(chi2 - gate) < CHI2_BAND
    differ = inl != inl_p
    assert not (differ & ~near).any(), np.nonzero(differ & ~near)
    assert abs(int(cnt) - int(cnt_p)) <= int(near.sum())
    if mix == "invalid":
        assert int(cnt) == 0 and not inl.any()
    elif n == 4096:
        assert int(cnt) > 2000          # the optimisation converged


@pytest.mark.cuda
@pytest.mark.parametrize("guarded", [False, True])
def test_one_launch_and_no_host_wait(cuda_device, guarded):
    """A call is one launch, repeats to the bit, and waits for nothing."""
    args = pose_cases.pose_args(_case(4096, "mixed"), cuda_device)
    pose_opt_cuda.pose_opt_kernel.load()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        runs = [_run(args, 3, 5, guarded) for _ in range(2)]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert [launches for _, launches, _ in runs] == [1, 1]
    for a, b in zip(runs[0][0], runs[1][0]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("guarded", [False, True])
def test_cpu_call_never_reaches_the_kernel(monkeypatch, guarded):
    def no_kernel(*a, **k):
        raise AssertionError("a CPU call reached the kernel")

    monkeypatch.setattr(pose_opt, "pose_opt_kernel", no_kernel)
    case = _case(37, "mixed")
    m = timing.Metrics()
    with timing.tracing(m):
        T, inl, cnt = pose_opt.pose_optimization(
            pose_cases.camera(), *pose_cases.pose_args(case, "cpu"),
            rounds=2, iters=5, guarded=guarded)
    assert m.counters["pose_opt.calls"] == 1
    assert m.counters["pose_opt.kernel"] == 0
    want = pose_opt.pose_optimization_reference(
        pose_cases.camera(), *pose_cases.pose_args(case, "cpu"), rounds=2,
        iters=5, guarded=guarded)
    for g, w in zip((T, inl, cnt), want):
        assert torch.equal(g, w)
    assert int(cnt) > 20


def test_tensors_off_the_cpu_never_take_the_plain_body(monkeypatch):
    """Meta tensors stand in for CUDA ones: the call goes to the kernel's
    wrapper, which refuses them, and the plain body is not taken."""
    def no_plain(*a, **k):
        raise AssertionError("took the plain body")

    monkeypatch.setattr(pose_opt, "pose_optimization_reference", no_plain)
    args = tuple(t.to("meta") for t in pose_cases.pose_args(
        _case(37, "mixed"), "cpu"))
    with pytest.raises(ValueError, match="CUDA"):
        pose_opt.pose_optimization(pose_cases.camera(), *args)

