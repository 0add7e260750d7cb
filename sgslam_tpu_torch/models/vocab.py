"""Binary bag-of-words vocabulary tree for place recognition.

Port of `sgslam_tpu/models/vocab.py`: a perfect k-ary tree stored as one
descriptor array per level, so descent is a gather plus a Hamming argmin per
level; BoW vectors are dense L1-normalized tf-idf histograms; the L1 score
runs against the whole keyframe database at once.

Descriptors are int32 [*, 8] (the reference's uint32 words, bit-cast).
`quantize` takes its popcounts with the SWAR popcount of K1's plain version
(`ops/hamming_cuda._popcount32`), so word ids are integer-exact, and its
argmin keeps the first minimum, as `jnp.argmin` does. The shipped
vocabulary, `sgslam_tpu/assets/vocab.npz`, is read by path as a data file.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..ops.hamming_cuda import _popcount32
from ..ops.segment import segment_sum

VOCAB_ASSET = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "sgslam_tpu", "assets", "vocab.npz")


@dataclasses.dataclass
class Vocabulary:
    """Perfect k-ary tree; level l holds k^(l+1) node descriptors."""

    level_desc: tuple      # [k^(l+1), 8] int32 tensors, l = 0..L-1
    word_idf: torch.Tensor  # [k^L] f32

    @property
    def branching(self):
        return self.level_desc[0].shape[0]

    @property
    def depth(self):
        return len(self.level_desc)

    @property
    def n_words(self):
        return self.word_idf.shape[0]

    @property
    def device(self):
        return self.word_idf.device

    def to(self, device) -> "Vocabulary":
        return Vocabulary(tuple(d.to(device) for d in self.level_desc),
                          self.word_idf.to(device))


def _as_int32(x: np.ndarray) -> torch.Tensor:
    x = np.ascontiguousarray(x)
    return torch.from_numpy(x.view(np.int32) if x.dtype == np.uint32
                            else x.astype(np.int32))


def _from_arrays(levels, idf, device) -> Vocabulary:
    return Vocabulary(tuple(_as_int32(np.asarray(l)).to(device)
                            for l in levels),
                      torch.as_tensor(np.asarray(idf, np.float32),
                                      device=device))


def _majority_bits(descs: np.ndarray) -> np.ndarray:
    """Binary 'mean' of packed uint32 descriptors [N, 8] -> [8]."""
    bits = np.unpackbits(np.ascontiguousarray(descs).view(np.uint8), axis=1)
    mean = (bits.mean(0) >= 0.5).astype(np.uint8)
    return np.packbits(mean).view(np.uint32)


def _hamming_np(a, b):
    x = np.bitwise_xor(a[:, None, :], b[None, :, :])
    return np.unpackbits(x.view(np.uint8).reshape(x.shape[0], x.shape[1], -1),
                         axis=2).sum(2)


def _kmeans_binary(descs: np.ndarray, k: int, rng, iters: int = 8):
    """Binary k-means; returns (centroids [k,8], assignment [N])."""
    n = len(descs)
    if n == 0:
        return rng.integers(0, 2 ** 32, size=(k, 8), dtype=np.uint64
                            ).astype(np.uint32), np.zeros(0, int)
    init = descs[rng.choice(n, size=min(k, n), replace=False)]
    cents = np.concatenate([
        init, rng.integers(0, 2 ** 32, size=(k - len(init), 8),
                           dtype=np.uint64).astype(np.uint32)])
    for _ in range(iters):
        assign = _hamming_np(descs, cents).argmin(1)
        for c in range(k):
            sel = descs[assign == c]
            if len(sel):
                cents[c] = _majority_bits(sel)
    return cents, _hamming_np(descs, cents).argmin(1)


def train_vocab(descriptors, branching: int = 10, depth: int = 4,
                seed: int = 0, device="cpu") -> Vocabulary:
    """Hierarchical binary k-means (host numpy, as in the reference).
    descriptors: [N, 8] uint32 words (numpy) or int32 (tensor/numpy)."""
    d = np.ascontiguousarray(descriptors.cpu().numpy()
                             if torch.is_tensor(descriptors)
                             else np.asarray(descriptors))
    d = d.view(np.uint32) if d.dtype == np.int32 else d.astype(np.uint32)
    rng = np.random.default_rng(seed)
    levels, groups = [], [d]
    for _ in range(depth):
        cents_lv, next_groups = [], []
        for g in groups:
            cents, assign = _kmeans_binary(g, branching, rng)
            cents_lv.append(cents)
            for c in range(branching):
                next_groups.append(g[assign == c] if len(g) else g)
        levels.append(np.concatenate(cents_lv))
        groups = next_groups
    counts = np.asarray([len(g) for g in groups], np.float32)
    n_total = max(counts.sum(), 1.0)
    idf = np.log(n_total / np.maximum(counts, 1.0))
    return _from_arrays(levels, idf, device)


def save_vocab(path: str, vocab: Vocabulary) -> None:
    """Persist a vocabulary as npz, in the reference's layout (uint32)."""
    arrays = {f"level_{i}": d.cpu().numpy().view(np.uint32)
              for i, d in enumerate(vocab.level_desc)}
    arrays["word_idf"] = vocab.word_idf.cpu().numpy()
    np.savez_compressed(path, **arrays)


def load_vocab(path: str, device="cpu") -> Vocabulary:
    with np.load(path) as z:
        n_levels = sum(1 for k in z.files if k.startswith("level_"))
        levels = [z[f"level_{i}"] for i in range(n_levels)]
        idf = z["word_idf"]
    return _from_arrays(levels, idf, device)


def default_vocab(device="cpu") -> Vocabulary:
    """The packaged trained vocabulary; an LSH random tree if the asset is
    missing (the reference's behaviour)."""
    if os.path.exists(VOCAB_ASSET):
        return load_vocab(VOCAB_ASSET, device)
    return random_vocab(device=device)


def random_vocab(branching: int = 10, depth: int = 4, seed: int = 0,
                 device="cpu") -> Vocabulary:
    """LSH-style random tree, the same draws as the reference's."""
    rng = np.random.default_rng(seed)
    levels, n = [], 1
    for _ in range(depth):
        n *= branching
        levels.append(rng.integers(0, 2 ** 32, size=(n, 8),
                                   dtype=np.uint64).astype(np.uint32))
    return _from_arrays(levels, np.ones(branching ** depth, np.float32),
                        device)


def quantize(vocab: Vocabulary, desc, valid):
    """Descriptors [N,8] int32 -> word ids [N] int32 (-1 where invalid):
    per level, the Hamming distances to the k children of the current node,
    first minimum."""
    k = vocab.branching
    n = desc.shape[0]
    dev = desc.device
    node = torch.zeros(n, dtype=torch.int64, device=dev)
    child = torch.arange(k, device=dev)
    d64 = desc.to(torch.int64)
    for lv in range(vocab.depth):
        idx = node[:, None] * k + child[None, :]               # [N, k]
        cd = vocab.level_desc[lv].to(torch.int64)[idx]         # [N, k, 8]
        x = (cd ^ d64[:, None, :]) & 0xFFFFFFFF
        d = torch.sum(_popcount32(x), dim=-1)
        node = torch.gather(idx, 1, torch.argmin(d, dim=1)[:, None])[:, 0]
    return torch.where(valid, node, -1).to(torch.int32)


def bow_vector(vocab: Vocabulary, word_ids):
    """Word ids [N] -> L1-normalized tf-idf histogram [n_words]. The counts
    are integers (exact in any order); invalid ids (-1) are dropped."""
    hist = segment_sum(torch.ones(word_ids.shape, device=word_ids.device),
                       word_ids, vocab.n_words) * vocab.word_idf
    return hist / torch.clamp(torch.sum(hist), min=1e-9)


def l1_score(query, db):
    """DBoW2 L1 similarity of query [W] against db rows [K, W] -> [K]:
    1 - 0.5 * sum |q - d| (inputs L1-normalized)."""
    return 1.0 - 0.5 * torch.sum(torch.abs(query[None, :] - db), dim=-1)
