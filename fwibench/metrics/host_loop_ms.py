"""host_loop_ms: layer driver + optimizer. Per iteration, the host-clock
time outside objective calls (L-BFGS, the line search's logic, the misfit
log, the dumps, the checkpoint), over the iterations the profiler did not
watch. Moves iter_s."""
import numpy as np


def read(rec):
    grads = [i for i, c in enumerate(rec["calls"]) if c["grad"]]
    bounds = grads + [len(rec["calls"])]
    out = []
    for k in range(len(grads)):
        cs = rec["calls"][bounds[k]:bounds[k + 1]]
        if any(c["profiled"] for c in cs):
            continue
        end = rec["calls"][bounds[k + 1]]["t0"] \
            if k + 1 < len(grads) else rec["t_end"]
        out.append(end - cs[0]["t0"] - sum(c["t1"] - c["t0"] for c in cs))
    return 1e3 * float(np.mean(out)) if out else None
