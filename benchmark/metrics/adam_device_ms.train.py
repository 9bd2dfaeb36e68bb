"""Device time of the operations launched inside the optimizer's `step`
(the harness's `adam.step` span around it), per update, over the traced
stretch."""

UNIT, LAYER, MOVES = "ms", "train step and optimizer", "train_step_p90_ms"


def read(ctx):
    tr = ctx.get("trace")
    if tr is None:
        return None
    secs, n = tr.device_seconds_inside("adam.step")
    return 1e3 * secs / n if n and secs > 0 else None
