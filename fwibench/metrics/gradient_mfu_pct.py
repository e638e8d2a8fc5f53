"""gradient_mfu_pct: layer whole gradient. The gradient's least time on
the card (the family's count at the card's published float32 and memory
peaks) over the mean host-clock gradient call, of the calls the profiler
did not watch. Moves gradient_ms."""
import numpy as np

from fwibench.lib import calls, least_seconds


def read(rec):
    c = calls(rec, True, profiled=False)
    least = least_seconds(rec, "gradient")
    if not c or least is None:
        return None
    return 100.0 * least / float(np.mean([x["t1"] - x["t0"] for x in c]))
