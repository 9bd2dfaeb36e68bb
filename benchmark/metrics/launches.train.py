"""Kernels launched (from any thread) inside the program's
`train.micro_step` spans, per micro-step, over the traced stretch."""

from harness import program_spans

UNIT, LAYER, MOVES = "launches", "train step and optimizer", "train_audio_s_per_s"


def read(ctx):
    return program_spans.launches(ctx, "train.micro_step")
