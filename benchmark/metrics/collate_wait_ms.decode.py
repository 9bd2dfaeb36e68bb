"""Host time of the program's `decode.wait` spans (the decoding loop's wait
for its collate thread's next batch, the wait for a pass's end included),
per batch decoded, over the traced stretch."""

from harness import program_spans

UNIT, LAYER, MOVES = "ms", "decoding loop", "decode_audio_s_per_s"


def read(ctx):
    return program_spans.host_ms(ctx, "decode.wait", per="decode.postproc")
