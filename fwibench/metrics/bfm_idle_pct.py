"""bfm_idle_pct: layer misfit. 100 x the device's idle time inside the
program's ``fwi.bfm`` spans of the traced stretch over their length: the
card waiting on the host inside the W2-2d solves, chiefly the syncs of
the host's reads of the certificate and pushforward predicates. Moves
trial_ms."""
from fwibench.lib import union
from fwibench.spans import idle_in


def read(rec):
    tr = rec.get("trace")
    if tr is None:
        return None
    a, b = tr["stretch"]
    solves = [(max(s["ts"], a), min(s["ts"] + s["dur"], b))
              for s in tr["spans"] if s["name"] == "fwi.bfm"
              and s["ts"] + s["dur"] > a and s["ts"] < b]
    length = sum(y - x for x, y in union(solves))
    if length <= 0:
        return None
    return 100.0 * idle_in(solves, tr["busy"]) / length
