"""The window's client training as a share of the card's f32 peak:
``train_work``'s operations for one client-round, times the client-rounds
the window completed, over the window's seconds times 67 TFLOP/s."""
from portbench.work import PEAK_F32_FLOP_S, train_work


def read(ctx):
    if ctx.window_s <= 0.0:
        return None
    cfg = ctx.cell.cfg
    window, batch = cfg["data"]["train_len"], cfg["training"]["batch_size"]
    steps = cfg["training"]["local_epochs"] * (window // batch)
    _, ops = train_work(ctx.cell.dims, 1, window, steps, batch, False)
    return 100.0 * ops * ctx.client_rounds / (ctx.window_s * PEAK_F32_FLOP_S)
