"""Mean wait of a micro-step for its batch: the harness's clock around each
`next()` of the prefetch iterator over the window."""

UNIT, LAYER, MOVES = "ms", "input pipeline", "train_audio_s_per_s"


def read(ctx):
    waits = ctx.get("waits") or []
    return 1e3 * sum(waits) / len(waits) if waits else None
