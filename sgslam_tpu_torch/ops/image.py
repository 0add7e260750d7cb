"""Image primitives: separable Gaussian blur, resize, batched patch gather,
bilinear sampling.

Port of `sgslam_tpu/ops/image.py`.

`resize_bilinear` reproduces `jax.image.resize(method="linear")`, which
antialiases on downscale: each output pixel is a weighted sum over a
triangle kernel stretched by the inverse scale, applied separably (rows,
then columns) as two products with [in, out] weight matrices. The weights
are built once per shape on the host in numpy and follow the arithmetic
that XLA compiles for the reference (the sample position rounded once, as
a fused multiply-add; the kernel width applied as a product with its f32
reciprocal). They come within a few f32 ulps of the reference's weights;
`tests/test_torch_image_fast.py` states the pyramid tolerance that follows.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def gaussian_kernel_1d(ksize: int, sigma: float, dtype=torch.float32,
                       device=None):
    r = (ksize - 1) / 2
    x = torch.arange(ksize, dtype=dtype, device=device) - r
    k = torch.exp(-(x * x) / (2.0 * sigma * sigma))
    return k / torch.sum(k)


def gaussian_blur(img, ksize: int = 7, sigma: float = 2.0):
    """Separable Gaussian blur, replicate padding. img: [H, W] float32.

    The same shift-multiply-accumulate as the reference (its order of
    additions), so the two packages blur to within f32 rounding; no cuDNN
    convolution, whose TF32 default would cost three decimal digits."""
    k = gaussian_kernel_1d(ksize, sigma, img.dtype, img.device)
    r = ksize // 2
    h, w = img.shape

    def conv_axis(x, axis):
        n = x.shape[axis]
        acc = None
        for i in range(ksize):
            idx = torch.clamp(torch.arange(n, device=x.device) + (i - r),
                              0, n - 1)
            term = x.index_select(axis, idx) * k[i]
            acc = term if acc is None else acc + term
        return acc

    return conv_axis(conv_axis(img, 0), 1)


@functools.lru_cache(maxsize=64)
def _resize_weights_np(n_in: int, n_out: int) -> np.ndarray:
    """[n_in, n_out] float32 antialiased triangle-kernel weights, the
    `compute_weight_mat` of `jax.image.resize` for scale n_out/n_in."""
    f32 = np.float32
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = max(inv_scale, 1.0)
    out_idx = np.arange(n_out, dtype=f32)
    # (i + 0.5) * inv_scale - 0.5, rounded once (fused multiply-add)
    sample = ((out_idx.astype(np.float64) + 0.5)
              * np.float64(f32(inv_scale)) - 0.5).astype(f32)
    dist = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None])
    x = dist * (f32(1.0) / f32(kernel_scale))
    w = np.maximum(f32(0.0), f32(1.0) - x)
    total = np.zeros((1, n_out), f32)
    for row in w:      # row-sequential; XLA sums in blocks of 32 (an ulp)
        total = total + row
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(f32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


@functools.lru_cache(maxsize=64)
def _resize_weights(n_in: int, n_out: int, device: torch.device):
    return torch.from_numpy(_resize_weights_np(n_in, n_out)).to(device)


def resize_bilinear(img, h: int, w: int):
    """cv::resize(INTER_LINEAR)-style downscale. img: [H, W] float32."""
    wh = _resize_weights(img.shape[0], h, img.device)   # [H, h]
    ww = _resize_weights(img.shape[1], w, img.device)   # [W, w]
    return (wh.T @ img) @ ww


def pyramid_shapes(h: int, w: int, n_levels: int, scale: float):
    """Static per-level (h, w) like ORBextractor::ComputePyramid
    (ORBextractor.cc:1108-1133)."""
    shapes = []
    for lv in range(n_levels):
        s = 1.0 / (scale ** lv)
        shapes.append((int(round(h * s)), int(round(w * s))))
    return tuple(shapes)


def build_pyramid(img, n_levels: int, scale: float):
    """Tuple of per-level images (level 0 = input)."""
    h, w = img.shape
    shapes = pyramid_shapes(h, w, n_levels, scale)
    levels = [img]
    for lv in range(1, n_levels):
        levels.append(resize_bilinear(levels[-1], *shapes[lv]))
    return tuple(levels)


def gather_patches(img, centers, radius: int):
    """Gather square patches around integer centers.

    img: [H, W]; centers: [N, 2] int (x, y). Returns [N, 2r+1, 2r+1].
    Centers are clamped so the patch stays in bounds, as in the reference.
    """
    h, w = img.shape
    size = 2 * radius + 1
    cx = torch.clamp(centers[:, 0] - radius, 0, w - size)
    cy = torch.clamp(centers[:, 1] - radius, 0, h - size)
    off = torch.arange(size, device=img.device)
    rows = cy[:, None, None] + off[None, :, None]          # [N, size, 1]
    cols = cx[:, None, None] + off[None, None, :]          # [N, 1, size]
    return img.reshape(-1)[(rows * w + cols).reshape(-1)].reshape(
        -1, size, size)


def max_pool_3x3(x):
    """3x3 max filter (same shape) of an [H, W] image, padded with -inf
    (the reference's `reduce_window` with SAME padding)."""
    return torch.nn.functional.max_pool2d(x[None, None], 3, stride=1,
                                          padding=1)[0, 0]


def bilinear_sample(img, xy):
    """Sample img [H,W] at float coords xy [...,2] with bilinear interp.

    Out-of-bounds clamps to border. Used by LK flow."""
    h, w = img.shape
    x = torch.clamp(xy[..., 0], 0.0, w - 1.001)
    y = torch.clamp(xy[..., 1], 0.0, h - 1.001)
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    fx = x - x0
    fy = y - y0
    v00 = img[y0, x0]
    v01 = img[y0, x0 + 1]
    v10 = img[y0 + 1, x0]
    v11 = img[y0 + 1, x0 + 1]
    return ((1 - fy) * ((1 - fx) * v00 + fx * v01)
            + fy * ((1 - fx) * v10 + fx * v11))
