"""device_idle_pct: 100 x (1 - the union of the card's kernel and copy
intervals in the traced slice / the slice's wall time)."""


def read(ctx):
    tr = ctx.get("trace")
    if not tr or tr["window_s"] <= 0 or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
