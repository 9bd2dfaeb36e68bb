"""SpecAugment as a batched op on the device (PyTorch port of
`emoasr_tpu/ops/specaug.py`).

Parity target: emoASR `asr/spec_augment.py:10-95`: frequency and time
masks, adaptive variant (`max_mask_time_ratio`/`num_masks_time_ratio`, caps
of 20), zero or mean fill.  One call masks the whole padded (B, T, F) batch
with plain tensor operations on the batch's device.

Drawing the (start, width) pairs (`draw_masks`, from an explicit
`torch.Generator`) is split from applying them (`apply_masks`), so the two
frameworks can be fed the same pairs: the generators' bits differ, the
distribution is the JAX package's (width w ~ U[0, max), start ~ U[0, dim - w)
by the same modulo construction).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

MAX_MASKS = 20  # adaptive cap (spec_augment.py:71-72)


class MaskDraws(NamedTuple):
    """Per-sample mask parameters, each (B, MAX_MASKS) int64 except the
    counts (B,): frequency starts/widths, time starts/widths, and how many
    of each are active."""

    f_starts: torch.Tensor
    f_widths: torch.Tensor
    f_count: torch.Tensor
    t_starts: torch.Tensor
    t_widths: torch.Tensor
    t_count: torch.Tensor


def _hit(starts, widths, num_active, axis_len: int, valid=None) -> torch.Tensor:
    """(B, axis_len) bool: positions covered by an active mask."""
    pos = torch.arange(axis_len, device=starts.device)[None, None, :]
    s = starts[:, :, None]
    e = (starts + widths)[:, :, None]
    active = torch.arange(MAX_MASKS, device=starts.device)[None, :, None] < num_active[:, None, None]
    if valid is not None:
        active = active & valid[:, :, None]
    return ((pos >= s) & (pos < e) & active).any(dim=1)


def draw_masks(
    generator: Optional[torch.Generator],
    xlens: torch.Tensor,
    num_freq: int,
    max_mask_freq: int = 30,
    num_masks_freq: int = 2,
    max_mask_time: int = 40,
    num_masks_time: int = 2,
    max_mask_time_ratio: Optional[float] = None,
    num_masks_time_ratio: Optional[float] = None,
    rows: Optional[Tuple[int, int]] = None,
) -> MaskDraws:
    """Draw every sample's mask parameters on `xlens`'s device.  `rows =
    (first, total)`: the B samples are rows first.. of a batch of `total`
    (a rank's share, `parallel/mesh.py::rows_block`); the whole batch's
    bits are drawn and the rows' kept."""
    dev = xlens.device
    B = xlens.shape[0]
    xlens = xlens.long()
    first, total = rows or (0, B)

    def bits(high: int) -> torch.Tensor:
        return torch.randint(0, high, (total, MAX_MASKS), generator=generator, device=dev)[first:first + B]

    fw = bits(max(max_mask_freq, 1))
    fs = bits(2 ** 30) % torch.clamp(num_freq - fw, min=1)
    # time masks (adaptive caps per spec_augment.py:71-76)
    if max_mask_time_ratio is not None:
        mmt = torch.clamp(torch.round(xlens * max_mask_time_ratio), max=20).long()
        nmt = torch.clamp(torch.round(xlens * num_masks_time_ratio), max=20).long()
    else:
        mmt = torch.full((B,), max_mask_time, dtype=torch.long, device=dev)
        nmt = torch.full((B,), num_masks_time, dtype=torch.long, device=dev)
    tw = bits(2 ** 30) % torch.clamp(mmt[:, None], min=1)
    ts = bits(2 ** 30) % torch.clamp(xlens[:, None] - tw, min=1)
    nmf = torch.full((B,), num_masks_freq, dtype=torch.long, device=dev)
    return MaskDraws(fs, fw, nmf, ts, tw, nmt)


def apply_masks(xs: torch.Tensor, xlens: torch.Tensor, draws: MaskDraws,
                replace_with_zero: bool = True) -> torch.Tensor:
    """Masked copy of xs (B, T, F).  Time masks that do not fit their
    utterance (width >= xlen) are skipped, like the reference's
    `if xlen - t <= 0: continue` (spec_augment.py:80-81)."""
    B, T, F = xs.shape
    fmask = _hit(draws.f_starts, draws.f_widths, draws.f_count, F)[:, None, :]
    fits = draws.t_widths < xlens[:, None]
    tmask = _hit(draws.t_starts, draws.t_widths, draws.t_count, T, valid=fits)[:, :, None]
    mask = fmask | tmask
    if replace_with_zero:
        fill = xs.new_zeros(())
    else:
        # per-sample mean over valid frames (the reference's .mean() runs on
        # the unpadded per-sample array)
        valid = (torch.arange(T, device=xs.device)[None, :] < xlens[:, None])[:, :, None]
        total = torch.where(valid, xs, torch.zeros_like(xs)).sum(dim=(1, 2))
        fill = (total / torch.clamp(valid.sum(dim=(1, 2)) * F, min=1))[:, None, None]
    return torch.where(mask, fill.to(xs.dtype), xs)


def spec_augment(
    generator: Optional[torch.Generator],
    xs: torch.Tensor,
    xlens: torch.Tensor,
    max_mask_freq: int = 30,
    num_masks_freq: int = 2,
    max_mask_time: int = 40,
    num_masks_time: int = 2,
    max_mask_time_ratio: Optional[float] = None,
    num_masks_time_ratio: Optional[float] = None,
    replace_with_zero: bool = True,
    rows: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """Masked copy of xs (B, T, F).  Time masks never start beyond xlens.
    `rows` as in `draw_masks`."""
    draws = draw_masks(
        generator, xlens, xs.shape[2], max_mask_freq, num_masks_freq, max_mask_time,
        num_masks_time, max_mask_time_ratio, num_masks_time_ratio, rows,
    )
    return apply_masks(xs, xlens, draws, replace_with_zero)
