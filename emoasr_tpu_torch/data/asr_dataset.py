"""ASR dataset: TSV manifests + .npy features -> static-shape numpy batches.

Copy of `emoasr_tpu/data/asr_dataset.py` (the port keeps its own copies of
the JAX package's JAX-free modules).  Same manifest contract (columns
`feat_path, utt_id, token_id, text, xlen, ylen[, phone_token_id,
phone_text]`), <sos>/<eos> framing in collate (ys_in/ys_out padded with
eos), same bucket batching (batching.py), the distillation soft labels.
SpecAugment is not applied here: it runs on the device in the train step.
Collate loads a batch's features with the native multithreaded .npy loader
(`emoasr_tpu_torch/native`, built with g++ at first use; a failed build
raises); `native_loader=False` takes the per-utterance `np.load` path, the
plain version the tests hold the native one against.
"""

from __future__ import annotations

import logging
import pickle
from typing import Dict, Iterator, List, Optional

import numpy as np
import pandas as pd

from emoasr_tpu_torch import native
from emoasr_tpu_torch.config import ExpConfig
from emoasr_tpu_torch.data.batching import (
    BucketBatcher,
    derive_buckets,
    pad_to,
)
from emoasr_tpu_torch.utils.converters import get_utt_id_nosp, str2ints


def create_soft_label(data_kd_utt, ylen: int, vocab_size: int, lsm_prob: float, add_eos: bool,
                      eos_id: int = 2) -> np.ndarray:
    """Expand top-k (v, p) pairs into a dense (ylen[+1], V) soft-label
    matrix (datasets.py:248-263): each row p (1 - lsm_prob) at its top-k
    entries and lsm_prob / (V - k) everywhere else; with `add_eos` a last
    row for <eos>."""
    L = ylen + 1 if add_eos else ylen
    soft = np.zeros((L, vocab_size), np.float32)
    for i, topk in enumerate(data_kd_utt):
        if i >= L:
            break
        soft[i, :] = lsm_prob / (vocab_size - len(topk))
        for v, prob in topk:
            soft[i, int(v)] = float(prob) * (1 - lsm_prob)
    if add_eos:
        soft[-1, :] = lsm_prob / (vocab_size - 1)
        soft[-1, eos_id] = 1.0 * (1 - lsm_prob)
    return soft


class ASRDataset:
    def __init__(self, cfg: ExpConfig, data_path: str, phase: str = "train", decode_phone: bool = False,
                 kd_label_path: Optional[str] = None, native_loader: bool = True):
        """`decode_phone` reads the phone columns at test time too (the
        eval CLI's `--decode_phone`, error correction with phones).
        `kd_label_path`: the soft labels' pickle, read in the train phase
        when `kd_weight` or `inter_kd_weight` is set; each example then
        carries `soft_label` and each batch `soft_labels`.  `native_loader`
        picks collate's feature loader (see the module's docstring)."""
        self.cfg = cfg
        self.native_loader = native_loader
        self.phase = phase
        self.use_phone = (phase == "train" and cfg.mtl_phone_ctc_weight > 0) or decode_phone
        cols = ["feat_path", "utt_id", "token_id", "text", "xlen", "ylen"]
        if self.use_phone:
            cols += ["phone_token_id", "phone_text"]
        self.data = pd.read_table(data_path)[cols]
        self.data_kd = None
        if phase == "train" and (cfg.kd_weight > 0 or cfg.inter_kd_weight > 0) and kd_label_path:
            with open(kd_label_path, "rb") as f:
                self.data_kd = pickle.load(f)
            logging.info(f"kd labels: {kd_label_path}")
        self.add_eos = cfg.decoder_type in ("transformer", "las")

    def __len__(self) -> int:
        return len(self.data)

    def __getitem__(self, idx: int, load_x: bool = True) -> Dict:
        cfg = self.cfg
        row = self.data.iloc[idx]
        y = np.asarray(str2ints(row["token_id"]), np.int32)
        ex = {"utt_id": row["utt_id"], "text": row["text"], "y": y, "ylen": len(y)}
        if load_x:
            # frame stacking happens after collate (train/step.py::preprocess)
            ex["x"] = np.load(row["feat_path"])[:, : cfg.feat_dim].astype(np.float32)
            ex["xlen"] = ex["x"].shape[0]
        if self.use_phone:
            p = np.asarray(str2ints(row["phone_token_id"]), np.int32)
            ex["p"] = p
            ex["plen"] = len(p)
            ex["ptext"] = row["phone_text"]
        if self.data_kd is not None:
            utt_nosp = get_utt_id_nosp(row["utt_id"])
            kd_utt = self.data_kd.get(utt_nosp, [])
            if not kd_utt:
                logging.warning(f"soft label: {utt_nosp} not found")
            ex["soft_label"] = create_soft_label(kd_utt, len(y), cfg.vocab_size, cfg.lsm_prob,
                                                 add_eos=self.add_eos, eos_id=cfg.eos_id)
        return ex

    # ---- batching ----

    def make_batcher(self, shuffle: Optional[bool] = None, seed: int = 0,
                     drop_tail: Optional[bool] = None) -> BucketBatcher:
        """By default the train phase shuffles (`cfg.train_data_shuffle`)
        and drops undersized tail groups; other phases do neither."""
        cfg = self.cfg
        n = cfg.num_framestacks
        # manifest xlen is the RAW frame count; bucket caps are converted
        # to raw frames (t * n)
        buckets = derive_buckets(
            [(t * n, u) for t, u in cfg.buckets],
            cfg.max_xlens_batch * n,
            cfg.max_ylens_batch,
            cfg.batch_size,
        )
        if shuffle is None:
            shuffle = self.phase == "train" and cfg.train_data_shuffle
        if drop_tail is None:
            drop_tail = self.phase == "train"
        return BucketBatcher(
            self.data["xlen"].values, self.data["ylen"].values, buckets,
            shuffle=shuffle, seed=seed, drop_tail=drop_tail,
        )

    def collate(
        self,
        indices: List[int],
        max_xlen: int,
        max_ylen: int,
        pad_to_batch: Optional[int] = None,
    ) -> Dict:
        """Build one fixed-shape batch.

        With `pad_to_batch=B`, an undersized tail group is padded to B rows
        by repeating the first utterance, so every batch of a bucket has
        one shape.  `utt_ids`/`texts` keep the true length (`n_valid`
        rows): row b of the batch belongs to `utt_ids[b]` for
        b < n_valid, and the rows after that are padding."""
        n_valid = len(indices)
        if pad_to_batch is not None and n_valid < pad_to_batch:
            indices = list(indices) + [indices[0]] * (pad_to_batch - n_valid)
        cfg = self.cfg
        exs = [self.__getitem__(i, load_x=not self.native_loader) for i in indices]
        if self.native_loader:
            xs, xlens = native.load_feat_batch_native(
                [self.data.iloc[i]["feat_path"] for i in indices], max_xlen, cfg.feat_dim)
        else:
            xs = pad_to([e["x"] for e in exs], max_xlen, 0.0)
            xlens = [e["xlen"] for e in exs]
        B, eos = len(exs), cfg.eos_id
        # <sos>/<eos> framing (datasets.py:158-176)
        ys_in = np.full((B, max_ylen + 1), eos, np.int32)
        ys_out = np.full((B, max_ylen + 1), eos, np.int32)
        for b, e in enumerate(exs):
            n = e["ylen"]
            ys_in[b, 1 : 1 + n] = e["y"][:n]
            ys_out[b, :n] = e["y"][:n]
        batch = {
            "utt_ids": [e["utt_id"] for e in exs[:n_valid]],
            "texts": [e["text"] for e in exs[:n_valid]],
            "n_valid": n_valid,
            "xs": xs,
            "xlens": np.asarray(xlens, np.int32),
            "ys": pad_to([e["y"] for e in exs], max_ylen, eos).astype(np.int32),
            "ylens": np.asarray([e["ylen"] for e in exs], np.int32),
            "ys_in": ys_in,
            "ys_out": ys_out,
        }
        if self.use_phone:
            peos = cfg.phone_eos_id if cfg.phone_eos_id is not None else eos
            # phone sequences are much longer than token sequences: pad to
            # the batch's own phone length rounded up to a multiple of 32
            max_plen = ((max(int(e["plen"]) for e in exs) + 31) // 32) * 32
            batch["ps"] = pad_to([e["p"] for e in exs], max_plen, peos).astype(np.int32)
            batch["plens"] = np.asarray([e["plen"] for e in exs], np.int32)
            batch["ptexts"] = [e["ptext"] for e in exs]
        if self.data_kd is not None:
            batch["soft_labels"] = pad_to([e["soft_label"] for e in exs], max_ylen + 1 if self.add_eos else max_ylen,
                                          0.0)
        return batch

    def batches(self, batcher: Optional[BucketBatcher] = None, seed: int = 0) -> Iterator[Dict]:
        if batcher is None:
            batcher = self.make_batcher(seed=seed)
        for bi, indices in batcher:
            b = batcher.buckets[bi]
            yield self.collate(
                indices, b.max_xlen, b.max_ylen, pad_to_batch=b.batch_size
            )
