"""Share of the padded frames of the batches collated in the program's
`feed.collate` spans that no utterance fills: 100 * (1 - real / padded),
over the traced stretch."""

from harness import program_spans

UNIT, LAYER, MOVES = "%", "input pipeline", "train_audio_s_per_s"


def read(ctx):
    return program_spans.pad_share(ctx, "feed.collate")
