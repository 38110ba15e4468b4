"""The share of the traced window in which no operation ran on the device,
in %."""


def read(ctx):
    tr = ctx["trace"]
    if tr["busy_s"] <= 0.0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
