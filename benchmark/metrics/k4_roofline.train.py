"""K4's share of its roofline over the traced stretch: the sum of its
launches' least times (kernels/k4.py, real lengths) over its device time,
one forward and one backward a layer a micro-steptrain."""

from harness import readers
from harness.spec import kernel_counts

UNIT, LAYER, MOVES = "%", "encoder attention", "train_audio_s_per_s"
TRAIN = True


def read(ctx):
    cfg = ctx["cfg"]
    k4 = kernel_counts("k4")
    H = cfg["enc_num_attention_heads"]
    D = cfg["enc_hidden_size"] // H
    bias = cfg["encoder_type"] == "conformer" and cfg.get("pos_encode_type") == "rel"

    def launches(xl, yl):
        lens = readers.elens(xl)
        for _ in range(cfg["enc_num_layers"]):
            yield k4.fwd(lens, H, D, bias)
            if TRAIN:
                yield k4.bwd(lens, H, D, bias)

    return readers.roofline(ctx, "k4", launches)
