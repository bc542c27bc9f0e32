"""Share of the traced window in which no device operation ran:
1 - (union of the device operations' intervals) / window, in %. Each cell
kind has a name of its own (``idle_share.fit``, ``idle_share.serve``, ...),
which ``<name>.json`` points here, since each moves its cell's rate."""


def read(ctx):
    t = ctx["trace"]
    if t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
