"""Static-shape bucketed batching (copy of `emoasr_tpu/data/batching.py`).

Batches are padded up to a small fixed set of (T, U) buckets, with the
batch size per bucket derived from the reference's frame and token budgets
(`asr/datasets.py:189-245`).  Utterances are grouped in manifest order
(corpora are length-sorted).  Training shuffles the batch order per epoch
(`np.random.default_rng(seed).shuffle`, so a seed gives the JAX package's
order) and skips a bucket's undersized last group; decoding keeps manifest
order and the last group (the collate pads it).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class Bucket:
    max_xlen: int
    max_ylen: int
    batch_size: int


def derive_buckets(
    buckets: Sequence[Tuple[int, int]],
    max_xlens_batch: int,
    max_ylens_batch: int,
    batch_size: int,
) -> List[Bucket]:
    """Turn (T, U) bucket shapes + reference budgets into per-bucket batch
    sizes: B = min(batch_size, frames_budget // T, tokens_budget // U)."""
    out = []
    for T, U in sorted(buckets):
        B = max(1, min(batch_size, max_xlens_batch // T, max_ylens_batch // U))
        out.append(Bucket(T, U, B))
    return out


def pick_bucket(buckets: List[Bucket], xlen: int, ylen: int) -> Optional[int]:
    for i, b in enumerate(buckets):
        if xlen <= b.max_xlen and ylen <= b.max_ylen:
            return i
    return None


class BucketBatcher:
    """Assign examples to buckets and yield fixed-shape index batches."""

    def __init__(
        self,
        xlens: np.ndarray,
        ylens: np.ndarray,
        buckets: List[Bucket],
        shuffle: bool = False,
        seed: int = 0,
        drop_tail: bool = False,
    ):
        self.buckets = buckets
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)
        self.drop_tail = drop_tail

        per_bucket: List[List[int]] = [[] for _ in buckets]
        n_oversize = 0
        for i, (xl, yl) in enumerate(zip(xlens, ylens)):
            bi = pick_bucket(buckets, int(xl), int(yl))
            if bi is None:
                n_oversize += 1
                continue
            per_bucket[bi].append(i)
        if n_oversize:
            logging.warning(
                f"{n_oversize} utterances exceed all buckets and are skipped"
            )

        self.batches: List[Tuple[int, List[int]]] = []
        n_tail_dropped = 0
        for bi, idxs in enumerate(per_bucket):
            B = buckets[bi].batch_size
            for s in range(0, len(idxs), B):
                group = idxs[s : s + B]
                if len(group) < B and drop_tail:
                    n_tail_dropped += len(group)
                    continue
                self.batches.append((bi, group))
        if n_tail_dropped:
            logging.warning(
                f"{n_tail_dropped} tail utterances skipped (undersized "
                f"final groups; cf. min_batch_size skip in the reference)"
            )

    def __len__(self) -> int:
        return len(self.batches)

    def __iter__(self) -> Iterator[Tuple[int, List[int]]]:
        order = np.arange(len(self.batches))
        if self.shuffle:
            self.rng.shuffle(order)  # per-epoch batch shuffling
        for i in order:
            yield self.batches[i]


def pad_to(arr_list: Sequence[np.ndarray], length: int, value) -> np.ndarray:
    """Stack variable-length arrays into (B, length, ...) with padding."""
    B = len(arr_list)
    tail_shape = arr_list[0].shape[1:]
    out = np.full((B, length) + tail_shape, value, dtype=arr_list[0].dtype)
    for b, a in enumerate(arr_list):
        n = min(len(a), length)
        out[b, :n] = a[:n]
    return out
