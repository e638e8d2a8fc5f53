"""gradient_ms: the mean host-clock time of the window's gradient calls
(each ends with its gradient on the host)."""
import numpy as np

from fwibench.lib import calls


def read(rec):
    c = calls(rec, True)
    return 1e3 * float(np.mean([x["t1"] - x["t0"] for x in c])) if c \
        else None
