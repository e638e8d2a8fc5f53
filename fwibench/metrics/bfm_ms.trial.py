"""bfm_ms.trial: layer misfit. Per traced trial call, the host duration
of the program's ``fwi.bfm`` spans inside it (the W2-2d back-and-forth
solves, each ending with its results on the device), summed. Moves
trial_ms."""
from fwibench.spans import starts_in


def read(rec):
    tr = rec.get("trace")
    if tr is None:
        return None
    calls = [s for s in tr["spans"] if s["name"] == "objective.trial"]
    hits = [s["dur"] for s in tr["spans"] if s["name"] == "fwi.bfm"
            and any(starts_in(s, c) for c in calls)]
    if not calls or not hits:
        return None
    return 1e-3 * sum(hits) / len(calls)
