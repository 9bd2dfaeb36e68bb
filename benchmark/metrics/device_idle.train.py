"""Share of the traced stretch that no kernel, copy or fill on the device
covers (the union of the device's intervals)."""

from harness import readers

UNIT, LAYER, MOVES = "%", "device", "train_audio_s_per_s"


def read(ctx):
    return readers.idle(ctx)
