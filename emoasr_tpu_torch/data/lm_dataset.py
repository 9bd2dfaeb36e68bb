"""LM dataset: causal shift, BERT masking, bucketed static batches.

Copy of the `LMDataset` part of `emoasr_tpu/data/lm_dataset.py` (the port
keeps its own copies of the JAX package's JAX-free modules); parity target
emoASR `lm/datasets.py` (LMDataset:24, LMBatchSampler:247,
create_masked_lm_label:319).  Randomness draws from one
`np.random.default_rng(seed)` in the JAX package's order, so one seed gives
the same masks and batches.

Kept from the reference: rows with NaN token ids are dropped with a
warning; `num_to_mask` xor `mask_proportion`; `random_num_to_mask`
resamples the count in [1, num_to_mask].  Buckets of L/4, L/2 and L tokens
(L = `max_seq_len`), each with min(batch_size, max_ylens_batch // t) rows.
`TextAugment`, the deletable-mask insertion and `P2WDataset` come with slice
6b (ROADMAP.md §1).
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional

import numpy as np
import pandas as pd

from emoasr_tpu_torch.config import ExpConfig
from emoasr_tpu_torch.data.batching import Bucket, BucketBatcher, pad_to
from emoasr_tpu_torch.utils.converters import str2ints

IGNORE = -100


def create_masked_lm_label(
    rng: np.random.Generator,
    y: np.ndarray,
    mask_id: int,
    eos_id: int,
    num_to_mask: int = -1,
    mask_proportion: float = -1,
    random_num_to_mask: bool = False,
):
    """BERT-style masking (datasets.py:319-341): (y with the picked
    positions set to `mask_id`, labels holding their tokens and IGNORE
    elsewhere); eos is never picked."""
    y_masked = y.copy()
    label = np.full(y.shape, IGNORE, np.int32)
    cand = np.flatnonzero(y != eos_id)
    rng.shuffle(cand)
    if mask_proportion > 0:
        num_to_mask = max(int(len(cand) * mask_proportion), 1)
    if random_num_to_mask:
        num_to_mask = int(rng.integers(1, max(num_to_mask, 1) + 1))
    num_to_mask = min(num_to_mask, len(cand))
    idx = np.sort(cand[:num_to_mask])
    label[idx] = y[idx]
    y_masked[idx] = mask_id
    return y_masked, label


class LMDataset:
    def __init__(self, cfg: ExpConfig, data_path: str, phase: str = "train", seed: int = 0):
        if cfg.lm_type not in ("transformer", "bert", "rnn"):
            raise NotImplementedError(
                f"the dataset of lm_type={cfg.lm_type!r} comes with slice 6b (ROADMAP.md §1)"
            )
        self.cfg = cfg
        self.phase = phase
        self.rng = np.random.default_rng(seed)
        data = pd.read_table(data_path, comment="#")
        cols = ["utt_id", "token_id"] + (["ylen"] if "ylen" in data.columns else [])
        data = data[cols]
        n0 = len(data)
        data = data.dropna().reset_index(drop=True)
        if len(data) != n0:
            logging.warning(f"nan rows removed: {n0} -> {len(data)}")
        self.data = data

    def __len__(self) -> int:
        return len(self.data)

    def __getitem__(self, idx: int) -> Dict:
        cfg = self.cfg
        row = self.data.iloc[idx]
        token_id = str2ints(row["token_id"])
        if cfg.add_sos_eos:
            token_id = [cfg.eos_id] + token_id + [cfg.eos_id]
        y = np.asarray(token_id, np.int32)
        ex: Dict = {"utt_id": row["utt_id"]}
        if self.phase == "train" and cfg.lm_type == "bert":
            y_in, label = create_masked_lm_label(
                self.rng, y, cfg.mask_id, cfg.eos_id, num_to_mask=cfg.num_to_mask,
                mask_proportion=cfg.mask_proportion, random_num_to_mask=cfg.random_num_to_mask,
            )
        elif self.phase == "train":  # causal: predict the next token
            y_in, label = y[:-1], y[1:]
        else:
            y_in, label = y, None
        ex["ys_in"] = y_in
        ex["ylen"] = len(y_in)
        if label is not None:
            ex["label"] = label
        return ex

    def lengths(self) -> np.ndarray:
        if "ylen" in self.data.columns:
            base = self.data["ylen"].values.astype(np.int64)
        else:
            base = np.asarray([len(str(t).split()) for t in self.data["token_id"]], np.int64)
        extra = 2 if self.cfg.add_sos_eos else 0
        off = -1 if (self.phase == "train" and self.cfg.lm_type in ("transformer", "rnn")) else 0
        return base + extra + off

    def make_batcher(self, shuffle=None, seed=0, drop_tail=None) -> BucketBatcher:
        cfg = self.cfg
        lens = self.lengths()
        L = cfg.max_seq_len
        buckets = [Bucket(1, t, max(1, min(cfg.batch_size, cfg.max_ylens_batch // t)))
                   for t in sorted({L // 4, L // 2, L})]
        if shuffle is None:
            shuffle = self.phase == "train"
        if drop_tail is None:
            drop_tail = self.phase == "train"
        return BucketBatcher(np.zeros_like(lens), lens, buckets, shuffle=shuffle, seed=seed, drop_tail=drop_tail)

    def collate(self, indices: List[int], max_ylen: int) -> Dict:
        cfg = self.cfg
        exs = [self[i] for i in indices]
        batch = {
            "utt_ids": [e["utt_id"] for e in exs],
            "ys_in": pad_to([e["ys_in"] for e in exs], max_ylen, cfg.eos_id),
            "ylens": np.asarray([e["ylen"] for e in exs], np.int32),
        }
        if "label" in exs[0]:
            batch["labels"] = pad_to([e["label"] for e in exs], max_ylen, IGNORE)
        return batch

    def batches(self, batcher: Optional[BucketBatcher] = None, seed: int = 0):
        if batcher is None:
            batcher = self.make_batcher(seed=seed)
        for bi, indices in batcher:
            yield self.collate(indices, batcher.buckets[bi].max_ylen)
