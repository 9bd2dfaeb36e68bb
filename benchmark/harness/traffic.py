"""The one traffic generator: a mix file's parameters -> a pool of
utterances (durations, frames, labels) and its files.

The durations of a mix are drawn once from the mix's own `base_seed`, so
every run measures the same set of sizes; `--seed` decides their order,
the features and the labels.  Durations come from a mixture of parts, each
`{"share", "kind": "normal" | "uniform" | "lognormal", ...}` clipped to
`[min_s, max_s]`; `cap_s` (optional) then cuts longer ones to the cap.
Frames are `round(duration * frames_per_s)`; a label sequence has
`round(duration * tokens_per_s[vocab] * U(1 - jitter, 1 + jitter))`
tokens (at least one), ids uniform over `[first_token_id, vocab)`.

The pool is written as the port reads a corpus: one float32 `.npy` of
(frames, feat_dim) a utterance, a TSV manifest (`feat_path, utt_id,
token_id, text, xlen, ylen`) and a `vocab.txt` whose tokens are one word
each (`▁w<id>`), so a hypothesis' text maps back to its ids.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List

import numpy as np


@dataclass
class Pool:
    utt_ids: List[str]
    frames: np.ndarray  # (N,) int
    labels: List[np.ndarray]  # int32 ids
    frames_per_s: float
    feat_dim: int
    skipped_share: float  # of the drawn utterances, those no bucket holds

    @property
    def seconds(self) -> np.ndarray:
        return self.frames / self.frames_per_s


def draw_durations(mix: dict) -> np.ndarray:
    """The mix's `pool_utterances` durations in seconds, from `base_seed`."""
    rng = np.random.default_rng(int(mix["base_seed"]))
    n = int(mix["pool_utterances"])
    parts = mix["durations"]["parts"]
    shares = np.array([p["share"] for p in parts], float)
    which = rng.choice(len(parts), size=n, p=shares / shares.sum())
    out = np.empty(n)
    for i, p in enumerate(parts):
        m = which == i
        k = int(m.sum())
        if p["kind"] == "normal":
            out[m] = rng.normal(p["mean"], p["std"], k)
        elif p["kind"] == "uniform":
            out[m] = rng.uniform(p["low"], p["high"], k)
        elif p["kind"] == "lognormal":
            out[m] = rng.lognormal(np.log(p["median"]), p["sigma"], k)
        else:
            raise ValueError(f"duration part kind {p['kind']!r}")
        if "low" in p and p["kind"] != "uniform":
            out[m] = np.maximum(out[m], p["low"])
        if "high" in p and p["kind"] != "uniform":
            out[m] = np.minimum(out[m], p["high"])
    d = mix["durations"]
    out = np.clip(out, d["min_s"], d["max_s"])
    if "cap_s" in d:
        out = np.minimum(out, d["cap_s"])
    return out


def fits(frames: np.ndarray, ylens: np.ndarray, buckets) -> np.ndarray:
    """Utterances that some (frames, tokens) bucket holds (the port's
    batcher skips the others)."""
    ok = np.zeros(len(frames), bool)
    for T, U in buckets:
        ok |= (frames <= T) & (ylens <= U)
    return ok


def make_pool(mix: dict, vocab_size: int, buckets, seed: int, feat_dim: int) -> Pool:
    """The pool of run `seed`: the mix's durations in a seeded order, with
    seeded labels.  Utterances that no bucket holds are dropped from the
    pool (and their share reported), as the port's batcher would skip them."""
    dur = draw_durations(mix)
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 1]))
    dur = dur[rng.permutation(len(dur))]
    fps = float(mix["frames_per_s"])
    frames = np.maximum(np.round(dur * fps).astype(np.int64), int(mix.get("min_frames", 1)))
    rate = float(mix["tokens_per_s"][str(vocab_size)])
    jit = float(mix.get("token_jitter", 0.0))
    ylens = np.maximum(np.round(dur * rate * rng.uniform(1 - jit, 1 + jit, len(dur))).astype(np.int64), 1)
    first = int(mix.get("first_token_id", 3))
    ok = fits(frames, ylens, buckets)
    labels = [rng.integers(first, vocab_size, int(n)).astype(np.int32) for n in ylens]
    keep = np.flatnonzero(ok)
    return Pool(
        utt_ids=[f"u{i:06d}" for i in range(len(keep))],
        frames=frames[keep],
        labels=[labels[i] for i in keep],
        frames_per_s=fps,
        feat_dim=feat_dim,
        skipped_share=float(1.0 - ok.mean()),
    )


def features(pool: Pool, seed: int) -> np.ndarray:
    """All utterances' features, concatenated (sum frames, feat_dim) float32,
    standard normal (the statistics of mean- and variance-normalised
    filterbanks)."""
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 2]))
    return rng.standard_normal((int(pool.frames.sum()), pool.feat_dim), dtype=np.float32)


def write_pool(pool: Pool, seed: int, vocab_size: int, out_dir: str) -> str:
    """Write the features, the manifest and the vocabulary under `out_dir`;
    returns the manifest's path."""
    os.makedirs(out_dir, exist_ok=True)
    feats = features(pool, seed)
    offsets = np.concatenate([[0], np.cumsum(pool.frames)])
    lines = ["feat_path\tutt_id\ttoken_id\ttext\txlen\tylen"]
    for i, uid in enumerate(pool.utt_ids):
        path = os.path.join(out_dir, uid + ".npy")
        np.save(path, feats[offsets[i]:offsets[i + 1]])
        ids = pool.labels[i]
        lines.append(f"{path}\t{uid}\t{' '.join(map(str, ids))}\t{' '.join(f'w{t}' for t in ids)}"
                     f"\t{pool.frames[i]}\t{len(ids)}")
    manifest = os.path.join(out_dir, "pool.tsv")
    with open(manifest, "w") as f:
        f.write("\n".join(lines) + "\n")
    with open(os.path.join(out_dir, "vocab.txt"), "w", encoding="utf-8") as f:
        f.write("<blank> 0\n<unk> 1\n<eos> 2\n")
        f.write("".join(f"▁w{i} {i}\n" for i in range(3, vocab_size)))
    return manifest


def load_features(pool: Pool, out_dir: str, index: int) -> np.ndarray:
    """One utterance's features as written (the raw file both sides read)."""
    return np.load(os.path.join(out_dir, pool.utt_ids[index] + ".npy"))
