"""Device time of the kernels launched inside the program's `train.forward`
spans (preprocess, SpecAugment, the forward and the loss), per micro-step,
over the traced stretch."""

from harness import program_spans

UNIT, LAYER, MOVES = "ms", "train step and optimizer", "train_audio_s_per_s"


def read(ctx):
    return program_spans.device_ms(ctx, "train.forward")
