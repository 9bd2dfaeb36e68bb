"""Host time of the program's `feed.wait` spans (the consumer's wait for a
batch of `prefetch_to_device` and the wait on its copy), per micro-step,
over the traced stretch."""

from harness import program_spans

UNIT, LAYER, MOVES = "ms", "input pipeline", "train_audio_s_per_s"


def read(ctx):
    return program_spans.host_ms(ctx, "feed.wait", per="feed.wait")
