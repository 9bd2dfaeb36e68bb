"""K7's share of its roofline over the traced stretch: one forward launch a
micro-step (kernels/k7.py, real lengths) over the device time of its
kernels."""

from harness import readers
from harness.spec import kernel_counts

UNIT, LAYER, MOVES = "%", "RNN-T joint", "train_audio_s_per_s"


def read(ctx):
    cfg = ctx["cfg"]
    k7 = kernel_counts("k7")
    J, V = cfg["joint_hidden_size"], cfg["vocab_size"]

    def launches(xl, yl):
        yield k7.fwd(readers.elens(xl), yl, J, V)

    return readers.roofline(ctx, "k7", launches)
