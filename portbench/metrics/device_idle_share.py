"""The share of the traced window in which nothing ran on the card."""
from portbench.metrics._share import complete_trace


def read(ctx):
    tr = complete_trace(ctx)
    if tr is None or tr.window_s <= 0.0:
        return None
    return 100.0 * max(0.0, 1.0 - tr.busy_s() / tr.window_s)
