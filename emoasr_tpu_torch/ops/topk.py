"""Exact small-k top-k over the last axis: CUDA kernel and plain version.

Port of `emoasr_tpu/ops/topk_pallas.py::topk_pallas`.  Both versions hold
`lax.top_k`'s semantics: values descending, equal values to the lowest
index, and rows whose remaining entries are all -inf give fresh indices in
ascending order.  `torch.topk` promises no tie order, so neither uses it.

`topk_lastdim_kernel` launches `csrc/topk.cu` for a CUDA tensor and takes
`topk_plain` for a CPU tensor; it never falls back from one to the other.
A call is one launch of one grid: `parts` blocks a row (a thread-block
cluster when more than one), laid out by `launch_geometry`.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, Tuple

import torch

from emoasr_tpu_torch.ops.cuda_lib import I, P, CudaKernel, aligned16

KERNEL = CudaKernel(
    "topk.cu",
    {
        "emo_topk_f32": [P, P, P, I, I, I, I, I, P],
        "emo_topk_bf16": [P, P, P, I, I, I, I, I, P],
    },
)

MAX_K = 32
# the largest row the kernels took when a row lived in one block's shared
# memory (4-byte key + 1-byte flag an entry in 227 KB); kept as the limit
MAX_V = (232448 - 1024) // 5

# mirrored from csrc/topk.cu
THREADS = 256
MAX_PARTS = 8          # blocks a row: a portable cluster
MAX_KEYS = 32          # keys a thread (f32: 8 words of 4, bf16: 4 words of 8)
SMS = 132              # H100 SXM
# split a row while the grid has fewer blocks than this, keeping at least
# MIN_CHUNK entries a block
TARGET_BLOCKS = 2 * SMS
MIN_CHUNK = 2048

# launches by shape class ((V, k, dtype) of the call), for the reports;
# `KERNEL.launches` counts the same calls
SHAPE_LAUNCHES: Counter = Counter()

_LAUNCHERS = {torch.float32: "emo_topk_f32", torch.bfloat16: "emo_topk_bf16"}


def slice_words(chunk: int, per_word: int) -> int:
    """16-byte words that `chunk` consecutive entries starting anywhere touch."""
    return (chunk - 1) // per_word + 2


def launch_geometry(rows: int, V: int, k: int, dtype: torch.dtype) -> Dict[str, int]:
    """How a call lays out: `parts` blocks a row (1, 2, 4 or 8: as few as
    hold a slice in MAX_KEYS keys a thread, then more while the grid is
    under TARGET_BLOCKS and a slice keeps MIN_CHUNK entries), `chunk`
    entries a slice, `wpt` 16-byte words a thread, `keys` a thread,
    `blocks`, and `candidates`: the most entries a block ranks (the keys of
    k threads a warp where those fit the kernel's buffer, else of k
    threads: the kernel's two thresholds)."""
    per_word = 16 // torch.tensor([], dtype=dtype).element_size()
    max_wpt = MAX_KEYS // per_word
    if not 1 <= k <= min(MAX_K, V) or V > MAX_V:
        raise ValueError(f"topk kernel: k={k}, V={V} outside 1 <= k <= min({MAX_K}, V), V <= {MAX_V}")

    def wpt_of(parts: int) -> int:
        return -(-slice_words(-(-V // parts), per_word) // THREADS)

    parts = 1
    while parts < MAX_PARTS and (wpt_of(parts) > max_wpt or (
            rows * parts < TARGET_BLOCKS and -(-V // (2 * parts)) >= MIN_CHUNK)):
        parts *= 2
    wpt = wpt_of(parts)
    if wpt > max_wpt:
        raise ValueError(f"topk kernel: V={V} does not fit {MAX_PARTS} blocks of {THREADS} x {MAX_KEYS} keys")
    keys = wpt * per_word
    return {"parts": parts, "chunk": -(-V // parts), "wpt": wpt, "keys": keys, "blocks": rows * parts,
            "threads": THREADS, "candidates": (8 if 8 * k * keys <= MAX_K * MAX_KEYS else 1) * k * keys}


def topk_plain(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable descending sort, first k: ties keep ascending index order."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k].to(torch.int32)


def topk_lastdim_kernel(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values (..., k) in x.dtype, indices (..., k) int32)."""
    if x.device.type == "cpu":
        return topk_plain(x, k)
    if x.device.type != "cuda":
        raise ValueError(f"topk kernel: unsupported device {x.device}")
    if x.dtype not in _LAUNCHERS:
        raise TypeError(f"topk kernel takes float32 or bfloat16, not {x.dtype}")
    V = x.shape[-1]
    if not 1 <= k <= min(MAX_K, V):
        raise ValueError(f"topk kernel: k={k} outside 1..min({MAX_K}, V={V})")
    if V > MAX_V:
        raise ValueError(f"topk kernel: V={V} is above the kernel's limit {MAX_V}")
    if not x.is_contiguous():
        raise ValueError("topk kernel: input must be contiguous")
    lead = x.shape[:-1]
    rows = x.numel() // V
    vals = torch.empty(lead + (k,), dtype=x.dtype, device=x.device)
    idx = torch.empty(lead + (k,), dtype=torch.int32, device=x.device)
    if rows == 0:
        return vals, idx
    geo = launch_geometry(rows, V, k, x.dtype)
    x = aligned16(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        KERNEL.launch(
            _LAUNCHERS[x.dtype], x.data_ptr(), vals.data_ptr(), idx.data_ptr(),
            rows, V, k, geo["parts"], geo["wpt"], stream,
        )
    SHAPE_LAUNCHES[(V, k, str(x.dtype).replace("torch.", ""))] += 1
    return vals, idx
