"""Octomap-compatible occupancy export: the `.bt` (binary tree) format.

Own copy of `sgslam_tpu/mapping/octomap_io.py` (numpy only), taking the
port's `OccupancyGrid` of tensors on any device. The files it writes are
byte for byte the reference's, header included.

Format (octomap's OcTreeBase::writeBinary / readBinaryNode):
  text header:  "# Octomap OcTree binary file\n id OcTree\n size N\n
                 res R\n data\n"
  binary body:  depth-first pre-order stream, 2 bytes per inner node =
                8 children x 2 bits (child i -> bits 2i..2i+1 of byte
                i//4): 00 unknown, 01 occupied leaf, 10 free leaf,
                11 inner child (recurse).
Keys are 16-bit per axis (tree depth 16, child bit = x->1, y->2, z->4 as
in OcTreeKey::computeChildIdx). The grid is placed centered in key space:
file coordinates = world - grid.origin - (D/2)*res (the .bt container has
no origin field; the translation is returned by write_bt for consumers
that need absolute georeferencing). Uniform full octants are pruned to
coarser leaves exactly as octomap does.
"""

from __future__ import annotations

import numpy as np

TREE_DEPTH = 16
HALF_KEYS = 1 << (TREE_DEPTH - 1)          # 32768


def _emit(out: bytearray, keys: np.ndarray, occ: np.ndarray,
          depth: int) -> int:
    """Serialize one node (pre-order); returns the node count emitted."""
    shift = TREE_DEPTH - 1 - depth         # child-selection bit
    child_idx = (((keys[:, 0] >> shift) & 1)
                 | (((keys[:, 1] >> shift) & 1) << 1)
                 | (((keys[:, 2] >> shift) & 1) << 2))
    byte0 = 0
    byte1 = 0
    recurse = []
    full = (1 << shift) ** 3               # voxels in a FULL child subtree
    for c in range(8):
        sel = child_idx == c
        m = int(sel.sum())
        if m == 0:
            code = 0                        # unknown
        else:
            occ_c = occ[sel]
            if shift == 0:                  # children are max-depth leaves
                code = 1 if occ_c[0] else 2
            elif m == full and (occ_c.all() or not occ_c.any()):
                code = 1 if occ_c[0] else 2  # pruned uniform leaf
            else:
                code = 3                    # inner node
                recurse.append((c, sel))
        if c < 4:
            byte0 |= code << (2 * c)
        else:
            byte1 |= code << (2 * (c - 4))
    out.append(byte0)
    out.append(byte1)
    n = 1
    for c, sel in recurse:
        n += _emit(out, keys[sel], occ[sel], depth + 1)
    return n


def write_bt(path: str, grid) -> np.ndarray:
    """Serialize an OccupancyGrid to octomap .bt. Returns the [3] world
    translation T such that file coordinates = world - T."""
    import sys

    lo = grid.logodds.detach().cpu().numpy()
    D = lo.shape[0]
    res = float(grid.voxel_size)
    known = np.abs(lo) > 1e-6
    idx = np.argwhere(known).astype(np.int64)      # [M,3] grid ijk
    occ = lo[known] > 0.0
    off = HALF_KEYS - D // 2
    keys = idx + off

    body = bytearray()
    if len(idx):
        old_limit = sys.getrecursionlimit()
        sys.setrecursionlimit(max(old_limit, 10000))
        try:
            n_nodes = _emit(body, keys, occ, 0)
        finally:
            sys.setrecursionlimit(old_limit)
    else:
        n_nodes = 0

    header = (b"# Octomap OcTree binary file\n"
              b"# (generated by sgslam_tpu)\n"
              b"id OcTree\n"
              + f"size {n_nodes}\n".encode()
              + f"res {res:.6g}\n".encode()
              + b"data\n")
    with open(path, "wb") as f:
        f.write(header + bytes(body))
    origin = grid.origin.detach().cpu().numpy()
    return origin + (D / 2) * res


def read_bt(path: str):
    """Parse a .bt file back into (occupied_keys [M,3], free_keys [K,3],
    resolution) with all pruned leaves expanded to max depth. Intended for
    round-trip verification (not a full octomap implementation)."""
    with open(path, "rb") as f:
        data = f.read()
    pos = data.index(b"data\n") + 5
    header = data[:pos].decode(errors="replace")
    res = None
    for line in header.splitlines():
        if line.startswith("res "):
            res = float(line.split()[1])
        if line.startswith("id ") and line.split()[1] != "OcTree":
            raise ValueError(f"unsupported octree id: {line}")
    body = data[pos:]

    occ_keys: list[np.ndarray] = []
    free_keys: list[np.ndarray] = []
    cursor = [0]

    def rec(key, depth):
        b0 = body[cursor[0]]
        b1 = body[cursor[0] + 1]
        cursor[0] += 2
        shift = TREE_DEPTH - 1 - depth
        for c in range(8):
            code = ((b0 >> (2 * c)) & 3) if c < 4 \
                else ((b1 >> (2 * (c - 4))) & 3)
            if code == 0:
                continue
            ck = (key[0] | (((c >> 0) & 1) << shift),
                  key[1] | (((c >> 1) & 1) << shift),
                  key[2] | (((c >> 2) & 1) << shift))
            if code == 3:
                rec(ck, depth + 1)
            else:
                # expand the (possibly pruned) leaf to max-depth voxels
                side = 1 << shift
                r = np.arange(side)
                xx, yy, zz = np.meshgrid(ck[0] + r, ck[1] + r, ck[2] + r,
                                         indexing="ij")
                k = np.stack([xx, yy, zz], -1).reshape(-1, 3)
                (occ_keys if code == 1 else free_keys).append(k)

    import sys

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 10000))
    try:
        if body:
            rec((0, 0, 0), 0)
    finally:
        sys.setrecursionlimit(old_limit)
    cat = (lambda ls: np.concatenate(ls, 0) if ls
           else np.zeros((0, 3), np.int64))
    return cat(occ_keys), cat(free_keys), res
