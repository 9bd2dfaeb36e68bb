"""Offline corpus preparation toolkit (CLI with subcommands), the port of
`emoasr_tpu/corpora/prep.py` with the same 16 subcommands, arguments and
outputs:

    python -m emoasr_tpu_torch.corpora.prep <cmd> ... [wav_to_feats: --cpu]

Parity targets (emoASR `corpora/utils/`):
- `wav_to_feats.py:21-43`: wav -> 80-dim log-mel .npy + accumulated CMVN
  stats pickle (here through the port's front end
  `emoasr_tpu_torch.frontend.fbank`, on the card unless `--cpu` is given,
  instead of the torchaudio C++ kernel)
- `norm_feats.py:16-42`: global CMVN from (possibly multiple) train stats
- `sort_bylen.py:13-24`: length-sort manifests (ASR by xlen, P2W by plen)
- `split_tsv.py:7-34`: shard a manifest into part{i}of{n}.tsv
- `concat_text.py`: concatenate utterances into LM blocks (LM: exact
  max_len blocks; LMall: sliding repetitions; P2W: budgeted concat)
- `get_cols.py` / `rm_utt.py`: column selection / utterance filtering
- `map2phone.py`: lexicon-based phone mapping columns
- `spm_train.py` / `spm_encode.py`: sentencepiece BPE (offline CPU;
  gated on the `sentencepiece` package being installed)

Corpus pipelines (TED-LIUM2 `corpora/ted2/prep.sh`, EuroParl-ASR
`corpora/epasr/prep.sh`) chain: download -> segment (stm/json) -> speed
perturb -> fbank -> CMVN -> BPE -> manifest columns -> length sort; the
shell/sox/ffmpeg stages are documented in corpora/README.md and the
Python stages live here.

Two workarounds of the JAX package are not carried, as outputs do not
depend on them: the re-application of `JAX_PLATFORMS` in `main`, and the
1 s padding buckets of `wav_to_feats`, which bounded XLA's compiled shapes
(the frames past a wav's length are dropped either way).
"""

from __future__ import annotations

import argparse
import os
import pickle
import re
from typing import List

import numpy as np
import pandas as pd
import torch

from emoasr_tpu_torch.frontend.fbank import load_wav, log_mel_fbank
from emoasr_tpu_torch.utils.converters import ints2str, str2ints
from emoasr_tpu_torch.utils.device import resolve_device
from emoasr_tpu_torch.utils.vocab import Vocab


# ---------------------------------------------------------------------------
# features
# ---------------------------------------------------------------------------


def wav_to_feats(data_path: str, num_bins: int = 80, device=None) -> None:
    """wav (or tsv of wavs) -> .npy log-mel + CMVN stats pickle, the fbank
    on `device` (the card when None; "cpu" must be asked for)."""
    dev = resolve_device(device)

    def one(wav_path):
        wav = torch.from_numpy(load_wav(wav_path)).to(dev)
        feats, flens = log_mel_fbank(wav[None], num_bins=num_bins)
        lmfb = feats[0, : int(flens[0])].cpu().numpy()
        np.save(wav_path.replace(".wav", ".npy"), lmfb)
        return lmfb.sum(0), (lmfb * lmfb).sum(0), lmfb.shape[0]

    if data_path.endswith(".tsv"):
        df = pd.read_table(data_path)
        s = sq = None
        n = 0
        for row in df.itertuples():
            fs, fsq, fn = one(row.wav_path)
            s = fs if s is None else s + fs
            sq = fsq if sq is None else sq + fsq
            n += fn
        norm_info = {"lmfb_sum": s, "lmfb_sqsum": sq, "num_frames": n}
        with open(data_path.replace(".tsv", "_norm.pkl"), "wb") as f:
            pickle.dump(norm_info, f)
    else:
        one(data_path)


def norm_feats(data_path: str, norm_path: str, norm_suffix: str = "norm") -> None:
    """Apply global CMVN computed from stats pickles (norm_feats.py:16-42)."""
    s = sq = None
    n = 0
    for p in norm_path.split(","):
        with open(p, "rb") as f:
            info = pickle.load(f)
        s = info["lmfb_sum"] if s is None else s + info["lmfb_sum"]
        sq = info["lmfb_sqsum"] if sq is None else sq + info["lmfb_sqsum"]
        n += info["num_frames"]
    mean = s / n
    # float rounding can drive the variance of a constant dim slightly
    # negative; floor it (the reference would emit NaN here)
    std = np.sqrt(np.maximum(sq / n - mean * mean, 1e-8))

    def one(npy_path):
        x = np.load(npy_path)
        np.save(npy_path.replace(".npy", f"_{norm_suffix}.npy"), (x - mean) / std)

    if data_path.endswith(".tsv"):
        for row in pd.read_table(data_path).itertuples():
            one(row.wav_path.replace(".wav", ".npy"))
    else:
        one(data_path)


# ---------------------------------------------------------------------------
# manifest tools
# ---------------------------------------------------------------------------


def sort_bylen(tsv_path: str, task: str = "ASR") -> str:
    df = pd.read_table(tsv_path)
    if task == "ASR":
        if "xlen" not in df:
            df["xlen"] = df["feat_path"].map(lambda p: len(np.load(p)))
        df = df.sort_values(["xlen"])
    else:  # P2W
        if "plen" not in df:
            df["plen"] = df["phone_token_id"].str.split().str.len()
        df = df.sort_values(["plen"])
    out = f"{os.path.splitext(tsv_path)[0]}_sorted.tsv"
    df.to_csv(out, sep="\t", index=False)
    return out


def split_tsv(tsv_path: str, n_splits: int, shuffle: bool = False) -> str:
    df = pd.read_table(tsv_path)
    if shuffle:
        df = df.sample(frac=1, random_state=0).reset_index(drop=True)
    out_dir = os.path.splitext(tsv_path)[0]
    os.makedirs(out_dir, exist_ok=True)
    bounds = [int(i / n_splits * len(df)) for i in range(n_splits)] + [len(df)]
    for i in range(n_splits):
        part = df.iloc[bounds[i] : bounds[i + 1]]
        part.to_csv(
            os.path.join(out_dir, f"part{i + 1}of{n_splits}.tsv"),
            sep="\t", index=False,
        )
    return out_dir


def concat_text_lm(
    tsv_path: str, max_len: int = 256, eos_id: int = 2, shuffle: bool = False,
    out: str = None,
) -> str:
    """Concatenate utterances into exact `max_len` LM blocks
    (concat_text.py task=LM)."""
    df = pd.read_table(tsv_path)
    if shuffle:
        df = df.sample(frac=1, random_state=0).reset_index(drop=True)
    outs = []
    concat: List[int] = [eos_id]
    start = end = ""
    for row in df.itertuples():
        token_id = str2ints(row.token_id) + [eos_id]
        if start == "":
            start = row.utt_id
        end = row.utt_id
        if len(token_id) > max_len:
            continue
        if len(concat) + len(token_id) < max_len:
            concat += token_id
        else:
            rem = max_len - len(concat)
            concat += token_id[:rem]
            outs.append((f"{start}-{end}", ints2str(concat)))
            start = end = ""
            concat = token_id[rem:]
    data = pd.DataFrame(outs, columns=["utt_id", "token_id"])
    out = out or f"{os.path.splitext(tsv_path)[0]}_concat.tsv"
    data.to_csv(out, sep="\t", index=False)
    return out


def get_cols(tsv_path: str, cols: List[str], out: str = None,
             no_header: bool = False) -> str:
    """Extract columns (get_cols.py); `no_header` emits raw lines (the
    reference's --no_header, used to feed spm_train)."""
    df = pd.read_table(tsv_path)[cols]
    out = out or f"{os.path.splitext(tsv_path)[0]}_cols.tsv"
    df.to_csv(out, sep="\t", index=False, header=not no_header)
    return out


def rm_utt(tsv_path: str, utt_ids: List[str] = (), texts: List[str] = (),
           out: str = None) -> str:
    """Filter rows by utt_id or by exact text (the reference\'s rm_utt.py
    removes `ignore_time_segment_in_scoring` rows by TEXT, in place)."""
    df = pd.read_table(tsv_path)
    if utt_ids:
        df = df[~df["utt_id"].isin(set(utt_ids))]
    if texts:
        df = df[~df["text"].isin(set(texts))]
    out = out or f"{os.path.splitext(tsv_path)[0]}_rm.tsv"
    df.to_csv(out, sep="\t", index=False)
    return out


def map2phone(tsv_path: str, lexicon: str, phone_vocab: str, unk: str = "NSN",
              out: str = None) -> str:
    """Add `phone_token_id`/`phone_text`/`plen` columns via a lexicon
    (map2phone.py)."""
    word2phone = {}
    with open(lexicon, encoding="utf-8") as f:
        for line in f:
            line = re.sub(r"[\s]+", " ", line.strip())
            if not line:
                continue
            word = line.split(" ")[0].split("+")[0].lower()
            word2phone[word] = " ".join(line.split(" ")[1:])
    vocab = Vocab(phone_vocab)

    df = pd.read_table(tsv_path).dropna(subset=["utt_id", "token_id", "text"])
    ptexts, pids, plens = [], [], []
    for row in df.itertuples():
        phones = []
        for w in str(row.text).split(" "):
            phones += word2phone.get(w, unk).split() if w in word2phone else [unk]
        ptexts.append(" ".join(phones))
        pids.append(ints2str(vocab.tokens2ids(phones)))
        plens.append(len(phones))
    df["phone_token_id"] = pids
    df["phone_text"] = ptexts
    df["plen"] = plens
    out = out or f"{os.path.splitext(tsv_path)[0]}_p2w.tsv"
    df.to_csv(out, sep="\t", index=False)
    return out


# ---------------------------------------------------------------------------
# corpus segmentation (offline, needs sox; ted2/epasr prep stages)
# ---------------------------------------------------------------------------


def _trim_wav(in_path: str, out_path: str, start_s: float, end_s: float):
    """Cut [start_s, end_s) out of a PCM16 wav.

    Uses sox when available (reference parity: `sox in out trim s =e`,
    ted2/make_utts.py); otherwise an exact stdlib sample cut — trim is
    pure sample slicing, so the two are bit-identical for PCM16 input.
    """
    import shutil
    import subprocess
    import wave

    if shutil.which("sox"):
        cp = subprocess.run(
            ["sox", in_path, out_path, "trim", f"{start_s:.2f}", f"={end_s:.2f}"]
        )
        assert cp.returncode == 0, f"sox failed for {in_path}"
        return
    with wave.open(in_path, "rb") as w:
        rate = w.getframerate()
        n = w.getnframes()
        # match sox's 2-decimal rounding of the CLI args above
        s = min(n, int(round(round(start_s, 2) * rate)))
        e = min(n, int(round(round(end_s, 2) * rate)))
        w.setpos(s)
        frames = w.readframes(max(0, e - s))
        params = w.getparams()
    with wave.open(out_path, "wb") as w:
        w.setparams(params)
        w.writeframes(frames)


def make_utts_stm(
    stm_dir: str,
    wav_dir: str,
    out_wav_dir: str,
    tsv_path: str,
    extend_time: bool = False,
    speed_perturb: bool = False,
) -> str:
    """Segment talk-level wavs by .stm into per-utterance wavs + manifest.

    Semantics of `corpora/ted2/make_utts.py:9-95`: utt ids embed start/end
    centiseconds (zero-padded to 7), optional segment extension (-0.15 s
    head / +0.1 s tail), 0.9/1.0/1.1 speed-perturbed variants read
    `sp{speed}-{talk}.wav` inputs with times scaled by 1/speed.  Uses sox
    when on PATH, else an exact stdlib PCM16 cut (_trim_wav).
    """
    rows = []
    for stm_file in sorted(os.listdir(stm_dir)):
        if not stm_file.endswith(".stm"):
            continue
        with open(stm_dir + "/" + stm_file) as f:
            for line in f:
                sec = line.strip().split()
                if len(sec) < 7:
                    continue
                utt_prefix = sec[0]
                start_time, end_time = float(sec[3]), float(sec[4])
                text = " ".join(sec[6:])
                utt_id = (
                    f"{utt_prefix}-{str(int(start_time * 100)).zfill(7)}"
                    f"-{str(int(end_time * 100)).zfill(7)}"
                )
                odir = os.path.join(out_wav_dir, utt_prefix)
                os.makedirs(odir, exist_ok=True)
                if extend_time:
                    s_fix, e_fix = max(0, start_time - 0.15), end_time + 0.1
                else:
                    s_fix, e_fix = start_time, end_time
                speeds = ["0.9", "1.0", "1.1"] if speed_perturb else [None]
                for speed in speeds:
                    if speed is None:
                        wav = os.path.join(wav_dir, f"{utt_prefix}.wav")
                        sp_id, s, e = utt_id, s_fix, e_fix
                    else:
                        wav = os.path.join(wav_dir, f"sp{speed}-{utt_prefix}.wav")
                        sp_id = f"sp{speed}-{utt_id}"
                        s, e = s_fix / float(speed), e_fix / float(speed)
                    out_wav = os.path.join(odir, f"{sp_id}.wav")
                    _trim_wav(wav, out_wav, s, e)
                    rows.append((sp_id, out_wav, text))
    pd.DataFrame(rows, columns=["utt_id", "wav_path", "text"]).to_csv(
        tsv_path, sep="\t", index=False
    )
    return tsv_path


def make_utts_json(
    data_dir: str, out_wav_dir: str, tsv_path: str, json_ext: str = ".json"
) -> str:
    """EuroParl-ASR segmentation from released json files
    (`corpora/epasr/make_utts_json.py`): sessions organized as
    data_dir/tN/date/id/{*.wav, *.json}; each json holds segments with
    fields b/e (times) and wl (word list, field w).
    """
    import json as _json

    rows = []
    for d1 in sorted(os.listdir(data_dir)):
        p1 = os.path.join(data_dir, d1)
        if not os.path.isdir(p1):
            continue
        for d2 in sorted(os.listdir(p1)):
            p2 = os.path.join(p1, d2)
            for d3 in sorted(os.listdir(p2)):
                p3 = os.path.join(p2, d3)
                wav_path = json_path = ""
                for f in os.listdir(p3):
                    if f.endswith(".wav"):
                        wav_path = os.path.join(p3, f)
                    if f.endswith(json_ext):
                        json_path = os.path.join(p3, f)
                assert wav_path and json_path, p3
                utt_prefix = os.path.basename(wav_path).replace(
                    "ep-asr.en.orig.", ""
                ).replace(".wav", "")
                odir = os.path.join(out_wav_dir, utt_prefix)
                os.makedirs(odir, exist_ok=True)
                with open(json_path) as f:
                    sections = _json.load(f)
                for sec in sections:
                    s, e = float(sec["b"]), float(sec["e"])
                    text = " ".join(w["w"] for w in sec["wl"])
                    utt_id = (
                        f"{utt_prefix}-{str(int(s * 100)).zfill(7)}"
                        f"-{str(int(e * 100)).zfill(7)}"
                    )
                    out_wav = os.path.join(odir, f"{utt_id}.wav")
                    _trim_wav(wav_path, out_wav, s, e)
                    rows.append((utt_id, out_wav, text))
    pd.DataFrame(rows, columns=["utt_id", "wav_path", "text"]).to_csv(
        tsv_path, sep="\t", index=False
    )
    return tsv_path


def join_suffix(tsv_path: str) -> str:
    """Join clitic suffixes: "it 's" -> "it's" (ted2/join_suffix.py:6-25)."""

    def process(text):
        tokens = str(text).split()
        out, i = [], 0
        while i < len(tokens):
            if i < len(tokens) - 1 and tokens[i + 1][0] == "'":
                out.append(tokens[i] + tokens[i + 1])
                i += 1
            else:
                out.append(tokens[i])
            i += 1
        return " ".join(out)

    df = pd.read_table(tsv_path)
    df["text"] = df["text"].map(process)
    df.to_csv(tsv_path, sep="\t", index=False)
    return tsv_path


def prep_tsv(tsv_path: str, norm_suffix: str = "norm", out: str = None) -> str:
    """Finalize manifest columns: wav_path -> feat_path (normed npy), add
    xlen/ylen (ted2/prep_tsv.py:22-34)."""
    df = pd.read_table(tsv_path)
    if "wav_path" in df:
        df["feat_path"] = df["wav_path"].str.replace(
            ".wav", f"_{norm_suffix}.npy", regex=False
        )
        df = df.drop(columns=["wav_path"])
    if "xlen" not in df:
        df["xlen"] = df["feat_path"].map(lambda p: len(np.load(p)))
    if "ylen" not in df and "token_id" in df:
        df["ylen"] = df["token_id"].map(lambda t: len(str2ints(str(t))))
    out = out or tsv_path
    df.to_csv(out, sep="\t", index=False)
    return out


def map2phone_g2p(tsv_path: str, phone_vocab: str, out: str = None) -> str:
    """Japanese g2p phone mapping via pyopenjtalk (map2phone_g2p.py);
    gated on the package being installed (offline CPU tooling)."""
    try:
        import pyopenjtalk  # noqa: F401
    except ImportError as e:  # pragma: no cover
        raise RuntimeError(
            "pyopenjtalk is not installed in this environment; run g2p "
            "phone mapping offline where it is available"
        ) from e
    vocab = Vocab(phone_vocab)
    df = pd.read_table(tsv_path).dropna(subset=["utt_id", "text"])
    ptexts, pids, plens = [], [], []
    for row in df.itertuples():
        phones = pyopenjtalk.g2p(str(row.text).replace(" ", "")).split()
        ptexts.append(" ".join(phones))
        pids.append(ints2str(vocab.tokens2ids(phones)))
        plens.append(len(phones))
    df["phone_token_id"] = pids
    df["phone_text"] = ptexts
    df["plen"] = plens
    out = out or f"{os.path.splitext(tsv_path)[0]}_p2w.tsv"
    df.to_csv(out, sep="\t", index=False)
    return out


# ---------------------------------------------------------------------------
# sentencepiece (offline CPU tooling, gated)
# ---------------------------------------------------------------------------


def spm_train(text_path: str, model_prefix: str, vocab_size: int):
    """BPE training (spm_train.py:7-27); vocab file format: token id."""
    try:
        import sentencepiece as spm
    except ImportError as e:  # pragma: no cover
        raise RuntimeError(
            "sentencepiece is not installed in this environment; run spm "
            "tooling offline where it is available"
        ) from e
    spm.SentencePieceTrainer.train(
        input=text_path, model_prefix=model_prefix, vocab_size=vocab_size,
        model_type="bpe", character_coverage=1.0,
        pad_id=0, unk_id=1, bos_id=-1, eos_id=2,
        pad_piece="<blank>", unk_piece="<unk>", eos_piece="<eos>",
    )
    sp = spm.SentencePieceProcessor(model_file=f"{model_prefix}.model")
    with open(f"{model_prefix}_vocab.txt", "w", encoding="utf-8") as f:
        for i in range(sp.get_piece_size()):
            f.write(f"{sp.id_to_piece(i)} {i}\n")


def spm_encode(model_path: str, tsv_path: str, out: str = None) -> str:
    """Add token_id/ylen columns by encoding `text` (spm_encode.py:17-36)."""
    try:
        import sentencepiece as spm
    except ImportError as e:  # pragma: no cover
        raise RuntimeError("sentencepiece is not installed") from e
    sp = spm.SentencePieceProcessor(model_file=model_path)
    df = pd.read_table(tsv_path)
    df["token_id"] = [
        ints2str(sp.encode(str(t))) for t in df["text"]
    ]
    df["ylen"] = df["token_id"].str.split().str.len()
    out = out or f"{os.path.splitext(tsv_path)[0]}_bpe.tsv"
    df.to_csv(out, sep="\t", index=False)
    return out


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def main(argv=None):
    p = argparse.ArgumentParser(prog="emoasr_tpu_torch.corpora.prep")
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("wav_to_feats"); s.add_argument("data_path")
    s.add_argument("--cpu", action="store_true", help="run the fbank on the CPU (the default is the GPU)")
    s = sub.add_parser("norm_feats"); s.add_argument("data_path")
    s.add_argument("norm_path"); s.add_argument("--norm_suffix", default="norm")
    s = sub.add_parser("sort_bylen"); s.add_argument("tsv_path")
    s.add_argument("--task", choices=["ASR", "P2W"], default="ASR")
    s = sub.add_parser("split_tsv"); s.add_argument("tsv_path")
    s.add_argument("-n_splits", type=int, required=True)
    s.add_argument("--shuffle", action="store_true")
    s = sub.add_parser("concat_text"); s.add_argument("tsv_path")
    s.add_argument("--max_len", type=int, default=256)
    s.add_argument("--eos_id", type=int, default=2)
    s.add_argument("--shuffle", action="store_true")
    s = sub.add_parser("map2phone"); s.add_argument("tsv_path")
    s.add_argument("-lexicon", required=True); s.add_argument("-vocab", required=True)
    s = sub.add_parser("map2phone_g2p"); s.add_argument("tsv_path")
    s.add_argument("-vocab", required=True)
    s = sub.add_parser("make_utts_stm")
    s.add_argument("stm_dir"); s.add_argument("wav_dir")
    s.add_argument("out_wav_dir"); s.add_argument("tsv_path")
    s.add_argument("--extend_time", action="store_true")
    s.add_argument("--speed_perturb", action="store_true")
    s = sub.add_parser("make_utts_json")
    s.add_argument("data_dir"); s.add_argument("out_wav_dir")
    s.add_argument("tsv_path"); s.add_argument("--json_ext", default=".json")
    s = sub.add_parser("join_suffix"); s.add_argument("tsv_path")
    s = sub.add_parser("prep_tsv"); s.add_argument("tsv_path")
    s.add_argument("--norm_suffix", default="norm")
    s = sub.add_parser("get_cols"); s.add_argument("tsv_path")
    s.add_argument("-cols", nargs="+", required=True)
    s.add_argument("-out", default=None)
    s.add_argument("--no_header", action="store_true")
    s = sub.add_parser("rm_utt"); s.add_argument("tsv_path")
    s.add_argument("-utt_ids", nargs="*", default=[])
    s.add_argument(
        "-texts", nargs="*", default=["ignore_time_segment_in_scoring"],
        help="drop rows with these exact texts (reference rm_utt.py default)",
    )
    s = sub.add_parser("spm_train"); s.add_argument("text_path")
    s.add_argument("-model_prefix", required=True)
    s.add_argument("-vocab_size", type=int, required=True)
    s = sub.add_parser("spm_encode"); s.add_argument("tsv_path")
    s.add_argument("-model", required=True)
    s.add_argument("-out", default=None)

    args = p.parse_args(argv)
    if args.cmd == "wav_to_feats":
        wav_to_feats(args.data_path, device="cpu" if args.cpu else None)
    elif args.cmd == "norm_feats":
        norm_feats(args.data_path, args.norm_path, args.norm_suffix)
    elif args.cmd == "sort_bylen":
        print(sort_bylen(args.tsv_path, args.task))
    elif args.cmd == "split_tsv":
        print(split_tsv(args.tsv_path, args.n_splits, args.shuffle))
    elif args.cmd == "concat_text":
        print(concat_text_lm(args.tsv_path, args.max_len, args.eos_id, args.shuffle))
    elif args.cmd == "map2phone":
        print(map2phone(args.tsv_path, args.lexicon, args.vocab))
    elif args.cmd == "map2phone_g2p":
        print(map2phone_g2p(args.tsv_path, args.vocab))
    elif args.cmd == "make_utts_stm":
        print(make_utts_stm(args.stm_dir, args.wav_dir, args.out_wav_dir,
                            args.tsv_path, args.extend_time, args.speed_perturb))
    elif args.cmd == "make_utts_json":
        print(make_utts_json(args.data_dir, args.out_wav_dir, args.tsv_path,
                             args.json_ext))
    elif args.cmd == "join_suffix":
        print(join_suffix(args.tsv_path))
    elif args.cmd == "prep_tsv":
        print(prep_tsv(args.tsv_path, args.norm_suffix))
    elif args.cmd == "get_cols":
        print(get_cols(args.tsv_path, args.cols, args.out, args.no_header))
    elif args.cmd == "rm_utt":
        print(rm_utt(args.tsv_path, args.utt_ids, args.texts))
    elif args.cmd == "spm_train":
        spm_train(args.text_path, args.model_prefix, args.vocab_size)
    elif args.cmd == "spm_encode":
        print(spm_encode(args.model, args.tsv_path, args.out))


if __name__ == "__main__":
    main()
