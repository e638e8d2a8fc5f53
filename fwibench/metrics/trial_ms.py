"""trial_ms: the mean host-clock time of the window's misfit-only
(line-search) calls."""
import numpy as np

from fwibench.lib import calls


def read(rec):
    c = calls(rec, False)
    return 1e3 * float(np.mean([x["t1"] - x["t0"] for x in c])) if c \
        else None
