"""ctypes bindings to the native host runtime (`native/`'s C++ sources).

Own copy of `sgslam_tpu/io/native.py` for the port: host I/O, not device
or kernel code. It exposes the repository's native host runtime (the
reference's cv::imread and inter-thread queues in C++):

  * PNG decode/encode (gray8 / rgb8 / rgba8 / gray16) — png_codec.cc
  * NativeTumLoader — multithreaded decode-ahead prefetcher (dataset.cc)
  * ByteQueue — bounded blocking MPMC queue whose pop/push release the GIL
    (runtime.cc)

The library is built on first use with `make` (g++ and zlib, no CUDA)
from `native/`'s sources into the git-ignored `build/native/`, never into
`native/`: each process builds under a name of its own and renames the
result into place, so concurrent first uses do not clash. Without a
compiler the PNG codec falls back to pure Python (zlib and numpy, the
reference's writer and a reader of the same format); the prefetcher and
the queue need the library. This is a host-I/O fallback, not a device
one: nothing here runs on the GPU.
"""

from __future__ import annotations

import ctypes
import os
import struct
import subprocess
import threading
import zlib
from typing import Optional, Sequence

import numpy as np

_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
_NATIVE_DIR = os.path.join(_ROOT, "native")
_LIB_PATH = os.path.join(_ROOT, "build", "native", "libsgslam_native.so")
_lib = None
_lib_failed = False      # a failed build or load is not retried per call
_lib_lock = threading.Lock()
PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _build() -> bool:
    """`make` the library into build/native/ under a per-process name, then
    rename it into place (atomic on one file system)."""
    os.makedirs(os.path.dirname(_LIB_PATH), exist_ok=True)
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    try:
        subprocess.run(["make", "-B", "-C", _NATIVE_DIR, f"OUT={tmp}"],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, _LIB_PATH)
        return True
    except (subprocess.SubprocessError, OSError):
        return False
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_library(build: bool = True) -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None on failure."""
    global _lib, _lib_failed
    with _lib_lock:
        if _lib is not None or _lib_failed:
            return _lib
        if not os.path.exists(_LIB_PATH):
            if not (build and _build()):
                _lib_failed = build
                return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError:
            _lib_failed = True
            return None
        # --- png ---
        lib.png_info.restype = ctypes.c_int
        lib.png_info.argtypes = [ctypes.c_char_p] + [
            ctypes.POINTER(ctypes.c_int)] * 4
        lib.png_decode.restype = ctypes.c_int
        lib.png_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_void_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        lib.png_encode.restype = ctypes.c_int
        lib.png_encode.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                   ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.png_encode_ex.restype = ctypes.c_int
        lib.png_encode_ex.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                      ctypes.c_int, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_int]
        # --- dataset ---
        lib.tum_open.restype = ctypes.c_void_p
        lib.tum_open.argtypes = [ctypes.POINTER(ctypes.c_char_p),
                                 ctypes.c_int, ctypes.c_float, ctypes.c_int,
                                 ctypes.c_int]
        lib.tum_next.restype = ctypes.c_int
        lib.tum_next.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 3
        lib.tum_width.restype = ctypes.c_int
        lib.tum_width.argtypes = [ctypes.c_void_p]
        lib.tum_height.restype = ctypes.c_int
        lib.tum_height.argtypes = [ctypes.c_void_p]
        lib.tum_close.restype = None
        lib.tum_close.argtypes = [ctypes.c_void_p]
        # --- queues ---
        lib.bq_create.restype = ctypes.c_void_p
        lib.bq_create.argtypes = [ctypes.c_int]
        lib.bq_push.restype = ctypes.c_int
        lib.bq_push.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_int64]
        lib.bq_try_push.restype = ctypes.c_int
        lib.bq_try_push.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_int64]
        lib.bq_pop.restype = ctypes.c_int64
        lib.bq_pop.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_int64]
        lib.bq_peek_size.restype = ctypes.c_int64
        lib.bq_peek_size.argtypes = [ctypes.c_void_p]
        lib.bq_len.restype = ctypes.c_int
        lib.bq_len.argtypes = [ctypes.c_void_p]
        lib.bq_close.restype = None
        lib.bq_close.argtypes = [ctypes.c_void_p]
        lib.bq_destroy.restype = None
        lib.bq_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    return load_library() is not None


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

def png_read(path: str) -> np.ndarray:
    """Decode a PNG. Returns [H,W] (gray) or [H,W,C]; dtype u8 or u16.

    Falls back to pure Python when the native library is unavailable.
    """
    lib = load_library()
    if lib is None:
        return _png_read_py(path)
    w = ctypes.c_int()
    h = ctypes.c_int()
    c = ctypes.c_int()
    bd = ctypes.c_int()
    rc = lib.png_info(path.encode(), ctypes.byref(w), ctypes.byref(h),
                      ctypes.byref(c), ctypes.byref(bd))
    if rc != 0:
        raise IOError(f"png_info({path}) failed: rc={rc}")
    dtype = np.uint16 if bd.value == 16 else np.uint8
    out = np.empty(h.value * w.value * c.value, dtype)
    rc = lib.png_decode(path.encode(), out.ctypes.data_as(ctypes.c_void_p),
                        out.nbytes, ctypes.byref(w), ctypes.byref(h),
                        ctypes.byref(c), ctypes.byref(bd))
    if rc != 0:
        raise IOError(f"png_decode({path}) failed: rc={rc}")
    img = out.reshape(h.value, w.value, c.value)
    return img[..., 0] if c.value == 1 else img


def png_write(path: str, img: np.ndarray) -> None:
    """Encode gray8 [H,W], RGB8 [H,W,3], or gray16 [H,W] (uint16, e.g. TUM
    depth maps). Pure-zlib Python fallback."""
    img = np.ascontiguousarray(img)
    if img.dtype == np.uint16:
        bit_depth = 16
        assert img.ndim == 2, "16-bit PNGs are grayscale only"
    else:
        bit_depth = 8
        img = img.astype(np.uint8, copy=False)
    channels = 1 if img.ndim == 2 else img.shape[2]
    lib = load_library()
    if lib is not None:
        rc = lib.png_encode_ex(path.encode(),
                               img.ctypes.data_as(ctypes.c_void_p),
                               img.shape[1], img.shape[0], channels,
                               bit_depth)
        if rc != 0:
            raise IOError(f"png_encode({path}) failed: rc={rc}")
        return
    _png_write_py(path, img, channels, bit_depth)


def _png_write_py(path: str, img: np.ndarray, channels: int,
                  bit_depth: int = 8) -> None:
    h, w = img.shape[:2]
    if bit_depth == 16:
        img = img.astype(">u2")        # PNG samples are big-endian
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data)))

    ihdr = struct.pack(">IIBBBBB", w, h, bit_depth,
                       0 if channels == 1 else 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(PNG_SIGNATURE)
        f.write(chunk(b"IHDR", ihdr))
        f.write(chunk(b"IDAT", zlib.compress(raw, 1)))
        f.write(chunk(b"IEND", b""))


_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}    # PNG colour type -> channels


def _unfilter_row(ftype: int, line, prev, bpp: int):
    """One scanline's PNG filter undone (filters 0-4, RFC 2083 6.3)."""
    if ftype == 0:
        return line
    if ftype == 2:
        return (line + prev) & 255
    cur = line.copy()
    if ftype == 1:
        for k in range(bpp):
            cur[k::bpp] = np.cumsum(line[k::bpp]) & 255
        return cur
    for i in range(len(cur)):
        a = int(cur[i - bpp]) if i >= bpp else 0
        b = int(prev[i])
        if ftype == 3:
            cur[i] = (cur[i] + (a + b) // 2) & 255
            continue
        c = int(prev[i - bpp]) if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 255
    return cur


def _png_read_py(path: str) -> np.ndarray:
    """Decode a non-interlaced 8- or 16-bit gray / gray-alpha / RGB / RGBA
    PNG with zlib and numpy; the same output as `png_read`."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != PNG_SIGNATURE:
        raise IOError(f"{path}: not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos + 8 <= len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if hdr is None:
        raise IOError(f"{path}: no IHDR chunk")
    w, h, bit_depth, ctype, _, _, interlace = hdr
    if (bit_depth not in (8, 16) or ctype not in _CHANNELS
            or interlace != 0):
        raise IOError(f"{path}: unsupported PNG (bit depth {bit_depth}, "
                      f"colour type {ctype}, interlace {interlace})")
    channels = _CHANNELS[ctype]
    bpp = channels * bit_depth // 8
    stride = w * bpp
    rows = np.frombuffer(zlib.decompress(b"".join(idat)),
                         np.uint8)[:h * (stride + 1)].reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.int64)
    for y in range(h):
        prev = _unfilter_row(int(rows[y, 0]), rows[y, 1:].astype(np.int64),
                             prev, bpp)
        out[y] = prev
    img = (out.view(">u2").astype(np.uint16) if bit_depth == 16 else out)
    img = img.reshape(h, w, channels)
    return img[..., 0] if channels == 1 else img


# ---------------------------------------------------------------------------
# Dataset prefetcher
# ---------------------------------------------------------------------------

class NativeTumLoader:
    """Ordered, decode-ahead RGB-D frame stream backed by C++ workers.

    Yields (index, gray f32 [H,W] in 0..1, depth f32 meters [H,W],
    rgb u8 [H,W,3]).
    """

    def __init__(self, rgb_paths: Sequence[str], depth_paths: Sequence[str],
                 depth_factor: float = 5000.0, n_threads: int = 4,
                 window: int = 8):
        lib = load_library()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        n = len(rgb_paths)
        assert len(depth_paths) == n
        arr = (ctypes.c_char_p * (2 * n))()
        self._keep = []  # keep encoded strings alive
        for i in range(n):
            r = rgb_paths[i].encode()
            d = depth_paths[i].encode()
            self._keep += [r, d]
            arr[2 * i] = r
            arr[2 * i + 1] = d
        self._h = lib.tum_open(arr, n, depth_factor, n_threads, window)
        if not self._h:
            raise IOError("tum_open failed (first frame undecodable?)")
        self.width = lib.tum_width(self._h)
        self.height = lib.tum_height(self._h)
        self.n = n

    def __len__(self):
        return self.n

    def __iter__(self):
        while True:
            nxt = self.next()
            if nxt is None:
                return
            yield nxt

    def next(self):
        gray = np.empty((self.height, self.width), np.float32)
        depth = np.empty((self.height, self.width), np.float32)
        rgb = np.empty((self.height, self.width, 3), np.uint8)
        idx = self._lib.tum_next(
            self._h, gray.ctypes.data_as(ctypes.c_void_p),
            depth.ctypes.data_as(ctypes.c_void_p),
            rgb.ctypes.data_as(ctypes.c_void_p))
        if idx == -1:
            return None
        if idx == -2:
            raise IOError("frame decode failed")
        return idx, gray, depth, rgb

    def close(self):
        if self._h:
            self._lib.tum_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


# ---------------------------------------------------------------------------
# Bounded queue
# ---------------------------------------------------------------------------

class ByteQueue:
    """Bounded blocking queue of byte messages (GIL released while waiting).

    The native replacement for the reference's mutex+usleep hand-off between
    pipeline threads (SURVEY.md §2.3 row 2).
    """

    def __init__(self, capacity: int = 8):
        lib = load_library()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self._q = lib.bq_create(capacity)

    def push(self, data: bytes) -> bool:
        """Blocking push; False if the queue is closed."""
        rc = self._lib.bq_push(self._q, data, len(data))
        return rc == 0

    def try_push(self, data: bytes) -> bool:
        """Non-blocking push; False when full or closed."""
        rc = self._lib.bq_try_push(self._q, data, len(data))
        return rc == 0

    def pop(self) -> Optional[bytes]:
        """Blocking; None when the queue is closed and drained."""
        size = self._lib.bq_peek_size(self._q)
        cap = max(int(size), 1 << 16)
        buf = ctypes.create_string_buffer(cap)
        n = self._lib.bq_pop(self._q, buf, cap)
        while n == -3:  # message larger than our buffer: grow and retry
            cap = int(self._lib.bq_peek_size(self._q))
            buf = ctypes.create_string_buffer(cap)
            n = self._lib.bq_pop(self._q, buf, cap)
        if n < 0:
            return None
        return buf.raw[:n]

    def __len__(self):
        return self._lib.bq_len(self._q)

    def close(self):
        self._lib.bq_close(self._q)

    def destroy(self):
        if self._q:
            self._lib.bq_destroy(self._q)
            self._q = None
