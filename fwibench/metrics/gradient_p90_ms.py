"""gradient_p90_ms: the nearest-rank 90th percentile of the host-clock
times of all the window's gradient calls."""
from fwibench.lib import calls, nearest_rank


def read(rec):
    c = calls(rec, True)
    return 1e3 * nearest_rank([x["t1"] - x["t0"] for x in c], 0.9) if c \
        else None
