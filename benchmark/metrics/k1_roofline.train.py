"""K1's share of its roofline over the traced stretch: its forward, grad-e
and grad-w launches a micro-step (kernels/k1.py, real lengths) over the
device time of its kernels."""

from harness import readers
from harness.spec import kernel_counts

UNIT, LAYER, MOVES = "%", "CTC head", "train_audio_s_per_s"


def read(ctx):
    cfg = ctx["cfg"]
    k1 = kernel_counts("k1")
    D, V = cfg["enc_hidden_size"], cfg["vocab_size"]

    def launches(xl, yl):
        e = readers.elens(xl)
        yield k1.fwd(e, yl, D, V)
        yield k1.grad_e(e, yl, D, V)
        yield k1.grad_w(e, yl, D, V)

    return readers.roofline(ctx, "k1", launches)
