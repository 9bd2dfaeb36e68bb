"""The whole training steptrain's share of the chip's dense peak: model operations of
the real frames and labels (harness/flops.py, 3x the forward) over the traced
stretch's seconds and 989e12 operations a second."""

from harness import readers

UNIT, LAYER, MOVES = "%", "whole step on the device", "train_audio_s_per_s"


def read(ctx):
    return readers.mfu(ctx)
