"""legendre_ms.trial: layer misfit. Per traced trial call, the device time
of the kernels that start inside its ``fwi.bfm.legendre`` spans (the
BFM's 2-D Legendre transforms, four a step). Moves trial_ms."""
from fwibench.lib import inside
from fwibench.spans import starts_in


def read(rec):
    tr = rec.get("trace")
    if tr is None:
        return None
    calls = [s for s in tr["spans"] if s["name"] == "objective.trial"]
    hits = [s for s in tr["spans"] if s["name"] == "fwi.bfm.legendre"
            and any(starts_in(s, c) for c in calls)]
    if not calls or not hits:
        return None
    kernels = [d["dur"] for s in hits for d in inside(tr["device"], s)
               if d.get("cat") == "kernel"]
    return 1e-3 * sum(kernels) / len(calls)
