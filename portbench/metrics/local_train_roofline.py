"""``local_train_f32``'s share of its roofline: ``train_work``'s bound at
the cell's B * N clients over the measured device time per launch."""
from portbench.metrics._share import complete_trace, roofline
from portbench.work import bound_from, train_work


def read(ctx):
    tr = complete_trace(ctx)
    if tr is None:
        return None
    secs, launches = tr.kernel_seconds("local_train_kernel")
    if launches == 0:
        return None
    cfg, cell = ctx.cell.cfg, ctx.cell
    window, batch = cfg["data"]["train_len"], cfg["training"]["batch_size"]
    steps = cfg["training"]["local_epochs"] * (window // batch)
    clients = cell.trials * cfg["deployment"]["n_sensors"]
    bound, _ = bound_from(*train_work(cell.dims, clients, window, steps, batch, False))
    return roofline(bound, secs / launches)
