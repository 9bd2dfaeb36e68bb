"""ctypes bindings for the port's native host components (C++), the port's
own copy of `emoasr_tpu/native`.

- `edit_distance_native`: batched Levenshtein with the reference's S/I/D
  backtrace priorities (corpus scoring in `eval/wer.py::compute_wers`).
- `load_feat_batch_native`: multithreaded .npy -> padded (B, T, F) float32
  batch assembly (the collate of `data/asr_dataset.py`).

The library is built from `edit_distance.cpp` and `batch_loader.cpp` with
the host's `g++` at first use, into `build/native/` at the repository root,
named by a hash of the sources, the flags and the compiler's version and
target (an edited source, or another machine's compiler, builds anew);
it is built to a name of the process's own and renamed into place, so
several processes may build at once.  A failed build or load raises with
g++'s output: there is no silent fallback to the Python paths, which the
callers reach only by an explicit argument.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import List, Sequence, Tuple

import numpy as np

SRC_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCES = ("edit_distance.cpp", "batch_loader.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(SRC_DIR)), "build", "native")
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]

_lib = None
_lock = threading.Lock()


def _compiler() -> str:
    out = subprocess.run(["g++", "-dumpfullversion", "-dumpmachine"], stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"g++ is not usable (exit {out.returncode}):\n{out.stdout}")
    return out.stdout


def lib_path() -> str:
    h = hashlib.sha1(" ".join(CXX_FLAGS + [_compiler()]).encode())
    for src in SOURCES:
        with open(os.path.join(SRC_DIR, src), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libemoasr_native-{h.hexdigest()[:12]}.so")


def build() -> str:
    """Build the library if it is not built yet; -> its path."""
    out = lib_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    proc = subprocess.run(["g++", *CXX_FLAGS, *(os.path.join(SRC_DIR, s) for s in SOURCES), "-o", tmp],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {', '.join(SOURCES)} (exit {proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, out)  # atomic: a concurrent reader sees all or nothing
    return out


def _load():
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                lib = ctypes.CDLL(build())
                lib.batch_edit_distance.argtypes = [
                    ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
                    ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
                    ctypes.c_int64, ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
                ]
                lib.load_feat_batch.argtypes = [
                    ctypes.c_char_p, ctypes.c_int64,
                    ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
                    ctypes.POINTER(ctypes.c_int64), ctypes.c_int32,
                ]
                _lib = lib
    return _lib


def _threads(num_threads: int) -> int:
    return num_threads if num_threads > 0 else min(os.cpu_count() or 1, 16)


def _pack(seqs: Sequence[Sequence[int]]):
    offsets = np.zeros(len(seqs) + 1, np.int64)
    offsets[1:] = np.cumsum([len(s) for s in seqs])
    flat = np.zeros(int(offsets[-1]), np.int32)
    for i, s in enumerate(seqs):
        flat[offsets[i]:offsets[i + 1]] = s
    return flat, offsets


def edit_distance_native(hyps: Sequence[Sequence[int]], refs: Sequence[Sequence[int]],
                         num_threads: int = 0) -> np.ndarray:
    """(n, 4) int32 rows [n_sub, n_ins, n_del, n_ref] per (hyp, ref) pair
    of int token ids."""
    lib = _load()
    rflat, roff = _pack(refs)
    hflat, hoff = _pack(hyps)
    out = np.zeros((len(refs), 4), np.int32)
    i32, i64 = ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64)
    lib.batch_edit_distance(rflat.ctypes.data_as(i32), roff.ctypes.data_as(i64), hflat.ctypes.data_as(i32),
                            hoff.ctypes.data_as(i64), len(refs), out.ctypes.data_as(i32), _threads(num_threads))
    return out


def load_feat_batch_native(paths: List[str], max_rows: int, cols: int,
                           num_threads: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Padded (B, max_rows, cols) float32 (the first `cols` columns of each
    file, float32 or float64) + per-file row counts; raises `IOError` naming
    the files it could not read."""
    lib = _load()
    B = len(paths)
    blob = b"".join(os.fsencode(p) + b"\0" for p in paths)
    out = np.zeros((B, max_rows, cols), np.float32)
    lens = np.zeros(B, np.int64)
    lib.load_feat_batch(blob, B, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), max_rows, cols,
                        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), _threads(num_threads))
    if (lens < 0).any():
        bad = [paths[i] for i in np.flatnonzero(lens < 0)]
        raise IOError(f"native loader failed for: {bad[:3]}")
    return out, lens
