"""iter_s: the window's length over the L-BFGS iterations completed in it
(host clock; the window ends where the next iteration's gradient is due)."""


def read(rec):
    return rec["window_s"] / rec["iterations"] if rec["iterations"] else None
