"""Time inside the program's `train.micro_step` spans that no kernel, copy
or fill on the device covers, per micro-step, over the traced stretch."""

from harness import program_spans

UNIT, LAYER, MOVES = "ms", "device", "train_audio_s_per_s"


def read(ctx):
    return program_spans.idle_ms(ctx, "train.micro_step", per="train.micro_step")
