"""Device operations (kernels, copies, sets) in the traced calls over the
rounds in them: what the host dispatches a round."""
from portbench.metrics._share import complete_trace


def read(ctx):
    tr = complete_trace(ctx)
    if tr is None:
        return None
    return len(tr.device) / (tr.calls * tr.rounds)
