"""Shared numeric constants and helpers for the lattice ops (copy of what
the port needs from `emoasr_tpu/ops/common.py`)."""

import torch

# Finite stand-in for log(0): avoids -inf NaN propagation.
# Matches the reference's convention (`asr/modeling/decoders/ctc.py:23`).
LOG_0 = -1e10


def logaddexp3(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Numerically stable elementwise logsumexp of three tensors; three
    `LOG_0`s give about `LOG_0 + log 3`, never -inf."""
    m = torch.maximum(torch.maximum(a, b), c).detach()
    return m + torch.log(torch.exp(a - m) + torch.exp(b - m) + torch.exp(c - m))


def flip_by_length(x: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Reverse the valid prefix of axis 1 per batch element (mod wrap);
    entries at t >= len land in arbitrary positions and must be masked by
    the caller."""
    L = x.shape[1]
    idx = (lens[:, None] - 1 - torch.arange(L, device=x.device)[None, :]) % L
    idx = idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(x.shape)
    return torch.gather(x, 1, idx.long())
