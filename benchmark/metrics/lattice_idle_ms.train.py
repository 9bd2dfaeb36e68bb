"""Time inside the program's `rnnt.lattice` spans (the RNN-T lattice's
forward rows, `ops/rnnt.py::rnnt_alpha_rowscan`) that no kernel, copy or
fill on the device covers, per micro-step, over the traced stretch."""

from harness import program_spans

UNIT, LAYER, MOVES = "ms", "RNN-T joint", "train_audio_s_per_s"


def read(ctx):
    return program_spans.idle_ms(ctx, "rnnt.lattice", per="train.micro_step")
