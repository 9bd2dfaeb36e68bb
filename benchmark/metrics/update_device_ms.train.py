"""Device time of the kernels launched inside the program's `train.update`
spans (the average, the clip and Adam of every `accum_grad`-th micro-step),
per update, over the traced stretch."""

from harness import program_spans

UNIT, LAYER, MOVES = "ms", "train step and optimizer", "train_step_p90_ms"


def read(ctx):
    return program_spans.device_ms(ctx, "train.update")
