"""Seeded inputs for the association search (numpy only), with the cases
that its first-index rule and candidate mask must get right.

`search_case(rng, q, n)` draws q query rows and n features on a 640x480
image: descriptors from a small pool with a few bits flipped (equal
distances are common), positions on a 4-pixel grid (window edges are hit
exactly), levels 0-7, 10% of the rows and columns invalid. With
`edge=True` (and q >= 40, n >= 64) it also plants:
  * rows 0-4: NaN and inf in proj_uv (no candidate);
  * rows 5-9: invalid rows (no candidate: best_idx 0, best 256);
  * rows 10-17: a row whose only candidate lies at distance 256, at one
    of the last columns (best_idx 0: the masked fill at column 0 ties
    lower);
  * rows 18-25: two columns with the same descriptor, position and level,
    both the row's nearest (duplicate minima: the lower column wins, and
    second == best);
  * columns 1-3 invalid (all-masked columns: their mutual best is row 0).
With `denormals=True` rows 26-27 also sit at (0, 0) with radius 1e-40
against features at x = 1e-40 (inside) and x = 2e-40 (outside, and the
nearer descriptor): flushing denormals to zero would take the second.
The JAX package's CPU route flushes denormals, so only the card's
comparison with the plain version takes that case.
"""

from __future__ import annotations

import numpy as np

WIDTH, HEIGHT, GRID = 640, 480, 4.0
RADII = (2.0, 4.0, 8.0, 16.0)


def search_case(rng, q: int, n: int, *, pool: int = 48, edge: bool = True,
                denormals: bool = False) -> dict:
    """numpy arrays: desc_q [q,8] u32, valid_q [q] bool, proj_uv [q,2] f32,
    radii [q] f32, pred_level [q] i32, desc_t [n,8] u32, valid_t [n] bool,
    feat_xy [n,2] f32, feat_level [n] i32."""
    base = rng.integers(0, 2 ** 32, size=(pool, 8),
                        dtype=np.uint64).astype(np.uint32)

    def descs(k):
        d = base[rng.integers(0, pool, size=k)]
        flip = np.left_shift(np.uint32(1), rng.integers(
            0, 32, size=d.shape).astype(np.uint32))
        return d ^ np.where(rng.random(d.shape) < 0.25, flip,
                            0).astype(np.uint32)

    gx, gy = int(WIDTH / GRID), int(HEIGHT / GRID)
    c = dict(
        desc_q=descs(q), valid_q=rng.random(q) < 0.9,
        proj_uv=(rng.integers(0, [gx, gy], size=(q, 2)) * GRID
                 + rng.choice([0.0, 0.5, 2.0], size=(q, 2))
                 ).astype(np.float32),
        radii=rng.choice(RADII, size=q).astype(np.float32),
        pred_level=rng.integers(0, 8, size=q).astype(np.int32),
        desc_t=descs(n), valid_t=rng.random(n) < 0.9,
        feat_xy=(rng.integers(0, [gx, gy], size=(n, 2)) * GRID
                 ).astype(np.float32),
        feat_level=rng.integers(0, 8, size=n).astype(np.int32))
    if edge and q >= 40 and n >= 64:
        _plant(c, n, denormals)
    return c


def _plant(c, n, denormals):
    p = c["proj_uv"]
    p[0, 0] = np.nan
    p[1, 1] = np.nan
    p[2] = np.inf
    p[3, 0] = -np.inf
    p[4] = (np.nan, np.inf)
    c["valid_q"][:5] = True
    c["valid_q"][5:10] = False
    for k, row in enumerate(range(10, 18)):        # lone candidate at 256
        j = n - 1 - k
        c["feat_xy"][j] = (-500.0 - 20.0 * k, -500.0)
        c["valid_t"][j] = True
        c["valid_q"][row] = True
        c["proj_uv"][row] = c["feat_xy"][j]
        c["radii"][row] = 1.0
        c["pred_level"][row] = c["feat_level"][j]
        c["desc_q"][row] = ~c["desc_t"][j]
    for k, row in enumerate(range(18, 26)):        # duplicate minima
        j1, j2 = 16 + 2 * k, n // 2 + 2 * k
        for key in ("desc_t", "feat_xy", "feat_level"):
            c[key][j2] = c[key][j1]
        c["valid_t"][[j1, j2]] = True
        c["valid_q"][row] = True
        c["proj_uv"][row] = c["feat_xy"][j1]
        c["pred_level"][row] = c["feat_level"][j1]
        c["desc_q"][row] = c["desc_t"][j1] ^ np.uint32(1 << (k % 32))
    c["valid_t"][1:4] = False                      # all-masked columns
    if denormals:
        inside, outside = n - 9, n - 10
        c["feat_xy"][inside] = (1e-40, 0.0)
        c["feat_xy"][outside] = (2e-40, 0.0)
        c["valid_t"][[inside, outside]] = True
        for row in (26, 27):
            c["valid_q"][row] = True
            c["proj_uv"][row] = (0.0, 0.0)
            c["radii"][row] = 1e-40
            c["pred_level"][row] = 0
            c["feat_level"][[inside, outside]] = 0
            c["desc_q"][row] = c["desc_t"][outside]


def search_args(c: dict, device, level_window: int | None = 1,
                scale_factor: float = 1.2):
    """(desc_q, valid_q, desc_t, valid_t, window) as the searches hand a
    case to `ops.hamming_search.hamming_search`, on `device`: descriptors
    bit-cast to int32; the window's radius scaled as `search_by_projection`
    scales it, or no window when `level_window` is None."""
    import torch

    from .hamming_search import Window

    def t(x):
        x = np.asarray(x)
        return torch.from_numpy(x.view(np.int32) if x.dtype == np.uint32
                                else x.copy()).to(device)

    window = None
    if level_window is not None:
        r = t(c["radii"]) * scale_factor ** t(c["pred_level"]).to(
            torch.float32)
        window = Window(t(c["proj_uv"]), r, t(c["pred_level"]),
                        t(c["feat_xy"]), t(c["feat_level"]), level_window)
    return (t(c["desc_q"]), t(c["valid_q"]), t(c["desc_t"]),
            t(c["valid_t"]), window)
