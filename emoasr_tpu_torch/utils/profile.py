"""The CLIs' `--profile DIR` (the JAX package's `jax.profiler` windows,
`train/loop.py:233-242` and `eval/test_asr.py:561-570`): a
`torch.profiler` trace of the host (and of the card's kernels, CUDA
activity, on the card), written as a Chrome trace
`DIR/<name>.pt.trace.json` (chrome://tracing, Perfetto, TensorBoard's
PyTorch plugin).  Under torchrun only rank 0 traces.
"""

from __future__ import annotations

import logging
import os
from contextlib import contextmanager

import torch

TRAIN_FIRST, TRAIN_LAST = 8, 12  # the train CLI's window: batches 8..12 of the first epoch


class Trace:
    """One profiler window on `device`, started by `start` and written by
    `stop` once the device's work is done."""

    def __init__(self, out_dir: str, name: str, device: torch.device):
        self.path = os.path.join(out_dir, f"{name}.pt.trace.json")
        self.device = device
        self._prof = None

    def start(self) -> "Trace":
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        return self

    def stop(self) -> str:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._prof.__exit__(None, None, None)
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        self._prof.export_chrome_trace(self.path)
        logging.info(f"profiler trace written to {self.path}")
        return self.path


@contextmanager
def trace(out_dir: str, name: str, device: torch.device):
    """A profiler window around the block."""
    t = Trace(out_dir, name, device).start()
    try:
        yield t
    finally:
        t.stop()
