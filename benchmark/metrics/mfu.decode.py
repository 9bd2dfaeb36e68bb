"""The whole decodedecoding pass's share of the chip's dense peak: model operations of
the real frames and labels (harness/flops.py) over the traced
stretch's seconds and 989e12 operations a second."""

from harness import readers

UNIT, LAYER, MOVES = "%", "whole step on the device", "decode_audio_s_per_s"


def read(ctx):
    return readers.mfu(ctx)
