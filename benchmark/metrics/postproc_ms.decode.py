"""Host time of the program's `decode.postproc` spans (`_postproc_batch`:
hypotheses to rows), per batch decoded, over the traced stretch."""

from harness import program_spans

UNIT, LAYER, MOVES = "ms", "decoding loop", "decode_audio_s_per_s"


def read(ctx):
    return program_spans.host_ms(ctx, "decode.postproc", per="decode.postproc")
