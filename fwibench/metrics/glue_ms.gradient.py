"""glue_ms.gradient: layer objective. Per traced gradient call, its host
time less the device time of the cell's sweep kernels (the role
<family>_gradient) inside it. Moves gradient_ms."""
import numpy as np

from fwibench.lib import inside, kernel_matches


def read(rec):
    tr = rec.get("trace")
    if tr is None:
        return None
    kernels = rec["bench"].role(rec["family"] + "_gradient")["kernels"]
    out = []
    for s in tr["spans"]:
        if s["name"] != "objective.gradient":
            continue
        sweeps = sum(d["dur"] for d in inside(tr["device"], s)
                     if kernel_matches(d["name"], kernels))
        out.append((s["dur"] - sweeps) * 1e-3)
    return float(np.mean(out)) if out else None
