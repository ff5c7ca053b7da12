"""Device milliseconds a round outside the port's named kernels: the
round physics, the mix, the gateway step, the fault layer and the
evaluation's products, in the traced calls."""
from portbench.metrics._share import complete_trace
from portbench.trace import kernel_of


def read(ctx):
    tr = complete_trace(ctx)
    if tr is None:
        return None
    glue = sum(e - s for name, s, e in tr.device if kernel_of(name) is None)
    return 1e3 * glue / (tr.calls * tr.rounds)
