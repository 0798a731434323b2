"""idle_share: the share of the traced window (the first traced batch's
start to the last one's end) in which no device operation ran: 1 - the
union of their intervals over the window, in % (torch.profiler)."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.ops:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
