"""``fused_agg``'s share of its roofline: ``agg_work``'s bound over the
device time of one call (its select and sum launches).  Under the robust
reduce it compresses each client into a fog of its own (identity fogs)."""
from portbench.metrics._share import complete_trace, roofline
from portbench.work import agg_work, bound_from


def read(ctx):
    tr = complete_trace(ctx)
    if tr is None:
        return None
    select_s, calls = tr.kernel_seconds("select_kernel")
    sum_s, _ = tr.kernel_seconds("sum_kernel")
    if calls == 0:
        return None
    cell, dp = ctx.cell, ctx.cell.cfg["deployment"]
    n = cell.trials * dp["n_sensors"]
    n_fog = n if cell.mix["fog_reduce"] != "mean" else cell.trials * dp["n_fog"]
    d = sum(a * b + b for a, b in zip(cell.dims[:-1], cell.dims[1:]))
    bound, _ = bound_from(*agg_work(n, d, n_fog))
    return roofline(bound, (select_s + sum_s) / calls)
