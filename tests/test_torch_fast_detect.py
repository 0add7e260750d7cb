"""FAST detection of a whole pyramid (`orb.detect_cells`): the plain path
against the per-level detection as `orb._detect_level` computed it before
the kernel (frozen below), tie cases, and the dispatch: a CPU call never
reaches the kernel (`csrc/fast_detect.cu`), and a tensor off the CPU never
takes the plain body (a build failure: `test_torch_cuda_lib.py`). The
`cuda` tests hold the kernel to the plain version on the card, to the bit,
and check one launch a frame and no host wait. No JAX here: the CPU
comparison of the score and NMS with the reference is
`test_torch_image_fast.py`.

On a machine with a card:
    python -m pytest --noconftest tests/test_torch_fast_detect.py
"""

import numpy as np
import pytest
import torch

from sgslam_tpu_torch import config
from sgslam_tpu_torch.io import synthetic as syn
from sgslam_tpu_torch.ops import fast, fast_cuda, image, orb
from sgslam_tpu_torch.utils import timing

CAMERAS = {"rgbd640": (640, 480), "stereo752": (752, 480)}
CELLS = (8, 16, 32)
THRESHOLD = 7.0 / 255.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as in the other port tests: the test workers
    share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _detect_level_before(img_l, budget, cell, threshold):
    """`orb._detect_level` as it was before the kernel: (cell_score,
    cell_best, xy_l, score) of one level."""
    h, w = img_l.shape
    dev = img_l.device
    score = fast.fast_score_map(img_l, threshold)
    score = fast.nms_3x3(score)
    score = score * fast.border_mask(h, w, orb.EDGE_MARGIN, score.dtype, dev)
    ncy = -(-h // cell)
    ncx = -(-w // cell)
    sp = torch.nn.functional.pad(score, (0, ncx * cell - w, 0, ncy * cell - h))
    cells = sp.reshape(ncy, cell, ncx, cell).permute(0, 2, 1, 3)
    cells = cells.reshape(ncy * ncx, cell * cell)
    cell_best = torch.argmax(cells, dim=1)
    cell_score = torch.amax(cells, dim=1)
    k = min(budget, ncy * ncx)
    top_score, top_cell = orb.topk_stable(cell_score, k)
    by, bx = top_cell // ncx, top_cell % ncx
    iy, ix = cell_best[top_cell] // cell, cell_best[top_cell] % cell
    x = (bx * cell + ix).to(torch.float32)
    y = (by * cell + iy).to(torch.float32)
    if k < budget:
        zeros = torch.zeros(budget - k, dtype=torch.float32, device=dev)
        x, y = torch.cat([x, zeros]), torch.cat([y, zeros])
        top_score = torch.cat([top_score, zeros])
    return cell_score, cell_best, torch.stack([x, y], dim=-1), top_score


def _rendered(w, h, frame=7, device="cpu"):
    cam = config.synthetic_config(w, h).camera
    gray, _ = syn.render_frame(cam, syn.make_trajectory(30)[frame])
    return gray.to(torch.float32).to(device)


def _plateaus(seed=0, shape=(480, 640), device="cpu"):
    """Values on five levels: wide flat regions and many equal scores."""
    rng = np.random.default_rng(seed)
    img = np.round(rng.random(shape) * 4) / 4
    return torch.from_numpy(img.astype(np.float32)).to(device)


def _pyramid(img, cfg=None):
    cfg = cfg or config.synthetic_config().orb
    return image.build_pyramid(img, cfg.n_levels, cfg.scale_factor)


def _identical(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.view(torch.int32) if a.dtype == torch.float32 else a,
        b.view(torch.int32) if b.dtype == torch.float32 else b)


@pytest.fixture(scope="module")
def pyramids():
    out = {name: _pyramid(_rendered(w, h)) for name, (w, h) in CAMERAS.items()}
    out["odd"] = (_rendered(333, 217),)      # sides no multiple of a cell
    out["plateaus"] = _pyramid(_plateaus())
    return out


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("kind", ["rgbd640", "stereo752", "odd", "plateaus"])
def test_all_levels_equal_the_per_level_detection(pyramids, kind, cell):
    """`detect_cells` on CPU levels: every level's cells as the per-level
    detection gave them, bit for bit, in level order; and each level's
    selection from its slice as before."""
    levels = pyramids[kind]
    score, best = orb.detect_cells(levels, cell, THRESHOLD)
    budgets = orb.level_budgets(config.synthetic_config().orb)
    first = 0
    for img_l, budget in zip(levels, budgets):
        want_s, want_b, want_xy, want_top = _detect_level_before(
            img_l, budget, cell, THRESHOLD)
        ncy, ncx = fast_cuda.cell_grid(*img_l.shape, cell)
        assert want_s.shape[0] == ncy * ncx
        got = slice(first, first + ncy * ncx)
        first = got.stop
        assert _identical(score[got], want_s)
        assert _identical(best[got], want_b)
        xy, top = orb._select_level(score[got], best[got], ncx, budget, cell)
        assert _identical(xy, want_xy) and _identical(top, want_top)
    assert first == score.shape[0] == best.shape[0]
    assert int((score > 0).sum()) > 0 or kind == "odd"


def _plateau(device="cpu"):
    """Two neighbouring bright pixels: each scores 1 and has the other as
    a neighbour of equal score."""
    img = torch.zeros((96, 96), dtype=torch.float32, device=device)
    img[40, 40:42] = 1.0
    return img


def _twin_corners(device="cpu"):
    """Two isolated bright pixels of equal score 1 in the cell at (2, 2)
    of 16: cell indices 5 * 16 + 10 = 90 and 10 * 16 + 3 = 163."""
    img = torch.zeros((96, 96), dtype=torch.float32, device=device)
    img[32 + 5, 32 + 10] = 1.0
    img[32 + 10, 32 + 3] = 1.0
    return img


def _check_ties(device):
    flat = _plateau(device)
    raw = fast.fast_score_map(flat, THRESHOLD)
    assert raw[40, 40:42].tolist() == [1.0, 1.0]     # a plateau ...
    score, best = orb.detect_cells((flat,), 16, THRESHOLD)
    assert not bool(score.any()) and not bool(best.any())   # ... suppressed
    score, best = orb.detect_cells((_twin_corners(device),), 16, THRESHOLD)
    ncx = fast_cuda.cell_grid(96, 96, 16)[1]
    twin = 2 * ncx + 2
    assert float(score[twin]) == 1.0 and int(best[twin]) == 90
    others = torch.ones_like(score, dtype=torch.bool)
    others[twin] = False
    assert not bool(score[others].any()) and not bool(best[others].any())


def test_ties_plateaus_suppressed_and_the_first_maximum_taken():
    _check_ties("cpu")


def test_cpu_call_never_reaches_the_kernel(monkeypatch):
    def no_kernel(*a, **k):
        raise AssertionError("a CPU call reached the kernel")

    monkeypatch.setattr(orb, "fast_detect_kernel", no_kernel)
    cfg = config.synthetic_config(320, 240)
    m = timing.Metrics()
    with timing.tracing(m):
        feats = orb.extract(_rendered(320, 240), cfg.orb, cfg.camera)
    assert m.counters["fast.calls"] == 1
    assert m.counters["fast.kernel"] == 0
    assert int(feats.valid.sum()) > 100


def test_tensors_off_the_cpu_never_take_the_plain_body(monkeypatch):
    """Meta tensors stand in for CUDA ones: the call goes to the kernel's
    wrapper, which refuses them, and the plain body is not taken."""
    def no_plain(*a, **k):
        raise AssertionError("took the plain body")

    monkeypatch.setattr(orb, "detect_cells_reference", no_plain)
    levels = tuple(t.to("meta") for t in _pyramid(_rendered(320, 240)))
    m = timing.Metrics()
    with timing.tracing(m), pytest.raises(ValueError, match="CUDA"):
        orb.detect_cells(levels, 16, THRESHOLD)
    assert m.counters["fast.calls"] == 1 and m.counters["fast.kernel"] == 0



@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("kind", ["rgbd640", "stereo752", "odd", "plateaus",
                                  "nan"])
def test_kernel_matches_plain_on_gpu(cuda_device, kind, cell):
    """Every bit of both outputs equal to the plain version on the card."""
    if kind in CAMERAS:
        levels = _pyramid(_rendered(*CAMERAS[kind], device=cuda_device))
    elif kind == "odd":
        levels = (_rendered(333, 217, device=cuda_device),)
    else:
        img = _plateaus(device=cuda_device)
        if kind == "nan":
            img[100:103, 200:230] = float("nan")
        levels = _pyramid(img)
    before = fast_cuda.fast_detect_kernel.launches
    score, best = orb.detect_cells(levels, cell, THRESHOLD)
    torch.cuda.synchronize()
    assert fast_cuda.fast_detect_kernel.launches - before == 1
    want_s, want_b = orb.detect_cells_reference(levels, cell, THRESHOLD)
    assert _identical(score, want_s) and _identical(best, want_b)
    assert int((score > 0).sum()) > 0 or kind == "odd"


@pytest.mark.cuda
def test_ties_on_gpu(cuda_device):
    _check_ties(cuda_device)


@pytest.mark.cuda
def test_one_launch_a_frame_and_no_host_wait(cuda_device):
    """orb.extract launches the kernel once a frame; the detection itself
    waits for nothing and repeats to the bit."""
    cfg = config.synthetic_config()
    img = _rendered(640, 480, device=cuda_device)
    fast_cuda.fast_detect_kernel.load()
    m = timing.Metrics()
    before = fast_cuda.fast_detect_kernel.launches
    with timing.tracing(m):
        orb.extract(img, cfg.orb, cfg.camera)
    assert fast_cuda.fast_detect_kernel.launches - before == 1
    assert m.counters["fast.calls"] == m.counters["fast.kernel"] == 1
    levels = _pyramid(img, cfg.orb)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        runs = [orb.detect_cells(levels, cfg.orb.cell_size, THRESHOLD)
                for _ in range(2)]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert _identical(a, b)
