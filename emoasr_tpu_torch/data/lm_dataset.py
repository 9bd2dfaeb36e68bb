"""LM and P2W datasets: causal shift, BERT masking, deletable-mask insertion,
discriminator error labels, phone TextAugment, bucketed static batches.

Copy of `emoasr_tpu/data/lm_dataset.py` (the port keeps its own copies of
the JAX package's JAX-free modules); parity target emoASR `lm/datasets.py`
(LMDataset:24, P2WDataset:123, LMBatchSampler:247,
create_masked_lm_label:319, _insert:344) and `lm/text_augment.py:12-55`.
Randomness draws from one `np.random.default_rng(seed)` in the JAX
package's order, so one seed gives the same masks and batches.

Kept from the reference: rows with NaN token ids are dropped with a
warning; `num_to_mask` xor `mask_proportion`; `random_num_to_mask`
resamples the count in [1, num_to_mask]; the deletable PC-MLM variant
inserts Poisson-many `<mask>` tokens after each position with label
`pad_id` (labels: -100 = unmasked, pad_id = an inserted mask to delete).
`LMDataset` buckets L/4, L/2 and L tokens (L = `max_seq_len`), each with
min(batch_size, max_ylens_batch // t) rows; `P2WDataset` buckets (L/2
tokens, L phones) and (L, 2L), each with min(batch_size, max_ylens_batch //
t, max_plens_batch // phones) rows.
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


def create_masked_lm_label_insert(
    rng: np.random.Generator,
    y: np.ndarray,
    mask_id: int,
    eos_id: int,
    num_to_mask: int = -1,
    mask_proportion: float = -1,
    random_num_to_mask: bool = False,
    insert_poisson_lam: float = -1,
    pad_id: int = 0,
):
    """Deletable PC-MLM (datasets.py:344-369): `create_masked_lm_label`,
    then Poisson(`insert_poisson_lam`)-many `<mask>` tokens inserted after
    each position, labelled `pad_id`."""
    y_masked, label = create_masked_lm_label(
        rng, y, mask_id, eos_id, num_to_mask, mask_proportion, random_num_to_mask,
    )
    if insert_poisson_lam <= 0:
        return y_masked, label
    num_inserts = rng.poisson(insert_poisson_lam, len(y_masked))
    total = len(y_masked) + int(num_inserts.sum())
    out_y = np.full(total, mask_id, np.int32)
    out_label = np.full(total, pad_id, np.int32)
    index = 0
    for tok, lab, n_ins in zip(y_masked, label, num_inserts):
        out_y[index] = tok
        out_label[index] = lab
        index += 1 + int(n_ins)
    return out_y, out_label


class TextAugment:
    """Random phone masking, then substitution (text_augment.py:12-55): up
    to `max_mask_prob` / `max_replace_prob` of a sequence's length, never
    the phone eos."""

    def __init__(self, cfg: ExpConfig):
        self.max_mask_prob = cfg.textaug_max_mask_prob
        self.max_replace_prob = cfg.textaug_max_replace_prob
        self.phone_vocab_size = cfg.src_vocab_size
        self.eos_id = cfg.phone_eos_id
        self.mask_id = cfg.phone_mask_id

    def __call__(self, rng: np.random.Generator, x: np.ndarray) -> np.ndarray:
        return self._replace(rng, self._mask(rng, x))

    def _mask(self, rng, x):
        out = x.copy()
        if self.max_mask_prob <= 0:
            return out
        n = int(rng.integers(0, int(len(x) * self.max_mask_prob) + 1))
        cand = np.flatnonzero(x != self.eos_id)
        rng.shuffle(cand)
        out[cand[: min(len(cand), n)]] = self.mask_id
        return out

    def _replace(self, rng, x):
        out = x.copy()
        if self.max_replace_prob <= 0:
            return out
        n = int(rng.integers(0, int(len(x) * self.max_replace_prob) + 1))
        cand = np.flatnonzero(x != self.eos_id)
        rng.shuffle(cand)
        pick = cand[: min(len(cand), n)]
        vocab = np.asarray([j for j in range(self.phone_vocab_size) if j != self.eos_id])
        out[pick] = rng.choice(vocab, size=len(pick))
        return out


def _read_rows(data_path: str, cols: List[str], optional: tuple = ()) -> pd.DataFrame:
    data = pd.read_table(data_path, comment="#")
    data = data[cols + [c for c in optional if c in data.columns]]
    n0 = len(data)
    data = data.dropna().reset_index(drop=True)
    if len(data) != n0:
        logging.warning(f"nan rows removed: {n0} -> {len(data)}")
    return data


class LMDataset:
    """The word-only LMs' rows: a causal shift (`transformer`, `rnn`),
    masks (`bert`, `electra`), or the ASR error labels of the `*-disc`
    types (`error_label`: "C" = correct, anything else = an error)."""

    def __init__(self, cfg: ExpConfig, data_path: str, phase: str = "train", seed: int = 0):
        self.cfg = cfg
        self.phase = phase
        self.rng = np.random.default_rng(seed)
        if cfg.lm_type in ("electra-disc", "pelectra-disc"):
            self.data = _read_rows(data_path, ["utt_id", "token_id", "error_label"])
        else:
            self.data = _read_rows(data_path, ["utt_id", "token_id"], ("ylen",))

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
        if "error_label" in self.data.columns:
            ex["error_label"] = np.asarray([e != "C" for e in row["error_label"].split()], np.int32)
        if self.phase == "train" and cfg.lm_type in ("bert", "electra"):
            y_in, label = create_masked_lm_label(
                self.rng, y, cfg.mask_id, cfg.eos_id, num_to_mask=cfg.num_to_mask,
                mask_proportion=cfg.mask_proportion, random_num_to_mask=cfg.random_num_to_mask,
            )
        elif self.phase == "train" and cfg.lm_type in ("transformer", "rnn"):  # the next token
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
        if "error_label" in exs[0]:
            batch["error_labels"] = pad_to([e["error_label"] for e in exs], max_ylen, IGNORE)
        return batch

    def batches(self, batcher: Optional[BucketBatcher] = None, seed: int = 0):
        if batcher is None:
            batcher = self.make_batcher(seed=seed)
        for bi, indices in batcher:
            yield self.collate(indices, batcher.buckets[bi].max_ylen)


class P2WDataset:
    """The phone-conditioned types' rows (`token_id`, `phone_token_id`):
    TextAugment on the phones in training, then masks with the deletable
    insertion (`pbert`, `pelectra`), the causal shift (`ptransformer`) or
    the phones as labels (`pctc`)."""

    def __init__(self, cfg: ExpConfig, data_path: str, phase: str = "train", seed: int = 0):
        self.cfg = cfg
        self.phase = phase
        self.rng = np.random.default_rng(seed)
        self.data = _read_rows(data_path, ["utt_id", "token_id", "phone_token_id"], ("ylen", "plen"))
        self.textaug = TextAugment(cfg) if phase == "train" and cfg.text_augment else None

    def __len__(self) -> int:
        return len(self.data)

    def __getitem__(self, idx: int) -> Dict:
        cfg = self.cfg
        row = self.data.iloc[idx]
        token_id = str2ints(row["token_id"])
        if cfg.add_sos_eos:
            token_id = [cfg.eos_id] + token_id + [cfg.eos_id]
        y = np.asarray(token_id, np.int32)
        p = np.asarray(str2ints(row["phone_token_id"]), np.int32)
        if self.textaug is not None:
            p = self.textaug(self.rng, p)
        if self.phase == "train" and cfg.lm_type in ("pelectra", "pbert"):
            if cfg.mask_insert_poisson_lam > 0:
                y_in, label = create_masked_lm_label_insert(
                    self.rng, y, cfg.mask_id, cfg.eos_id, num_to_mask=cfg.num_to_mask,
                    mask_proportion=cfg.mask_proportion, random_num_to_mask=cfg.random_num_to_mask,
                    insert_poisson_lam=cfg.mask_insert_poisson_lam, pad_id=cfg.blank_id,
                )
            else:
                y_in, label = create_masked_lm_label(
                    self.rng, y, cfg.mask_id, cfg.eos_id, num_to_mask=cfg.num_to_mask,
                    mask_proportion=cfg.mask_proportion, random_num_to_mask=cfg.random_num_to_mask,
                )
        elif self.phase == "train" and cfg.lm_type == "ptransformer":
            y_in, label = y[:-1], y[1:]
        elif self.phase == "train" and cfg.lm_type == "pctc":
            y_in, label = y, p
        else:
            y_in, label = y, None
        ex = {"utt_id": row["utt_id"], "p": p, "plen": len(p), "ys_in": y_in, "ylen": len(y_in)}
        if label is not None:
            ex["label"] = label
        return ex

    def _lengths(self, col: str, tokens: str) -> np.ndarray:
        if col in self.data.columns:
            return self.data[col].values.astype(np.int64)
        return np.asarray([len(str(t).split()) for t in self.data[tokens]], np.int64)

    def make_batcher(self, shuffle=None, seed=0, drop_tail=None) -> BucketBatcher:
        cfg = self.cfg
        ylens = self._lengths("ylen", "token_id") + (2 if cfg.add_sos_eos else 0)
        plens = self._lengths("plen", "phone_token_id")
        if cfg.mask_insert_poisson_lam > 0:
            # inserted masks lengthen sequences; reserve headroom
            ylens = (ylens * (1 + cfg.mask_insert_poisson_lam) + 4).astype(np.int64)
        L = cfg.max_seq_len
        buckets = [
            Bucket(p_cap, t, max(1, min(cfg.batch_size, cfg.max_ylens_batch // t, cfg.max_plens_batch // p_cap)))
            for t, p_cap in sorted({(L // 2, L), (L, 2 * L)})
        ]
        if shuffle is None:
            shuffle = self.phase == "train" and cfg.bucket_shuffle
        if drop_tail is None:
            drop_tail = self.phase == "train"
        return BucketBatcher(plens, ylens, buckets, shuffle=shuffle, seed=seed, drop_tail=drop_tail)

    def collate(self, indices: List[int], max_plen: int, max_ylen: int) -> Dict:
        cfg = self.cfg
        exs = [self[i] for i in indices]
        peos = cfg.phone_eos_id if cfg.phone_eos_id is not None else cfg.eos_id
        batch = {
            "utt_ids": [e["utt_id"] for e in exs],
            "ps": pad_to([e["p"] for e in exs], max_plen, peos),
            "plens": np.asarray([e["plen"] for e in exs], np.int32),
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
            b = batcher.buckets[bi]
            yield self.collate(indices, b.max_xlen, b.max_ylen)
