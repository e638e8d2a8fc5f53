"""The arithmetic of the readers of the program's own spans: the
objective's ``fwi.*`` (``fwi.py``, ``elastic_fwi.py``) and the inversion
loop's ``loop.*`` (``optimize/``), recorded by ``profiling.span`` into the
traced run's trace beside the harness's ``iteration`` and ``objective.*``.
All spans nest by containment on the one host thread. Times in the
trace's microseconds; the readers return milliseconds or a share.
``owners`` names each stretch of the host's time by its innermost span,
for the run's breakdown of the device's idle time."""
from __future__ import annotations

from bisect import bisect_right

from fwibench.lib import union

# the prefixes of the program's span names
PROGRAM = ("fwi.", "loop.")
# the prefix of the harness's spans around each objective call
CALL = "objective."


def _end(s):
    return s["ts"] + s["dur"]


def self_times(spans):
    """Each span's duration less the part its direct children cover (the
    innermost enclosing span is a span's parent; ties go to the longer,
    then the earlier in the list)."""
    order = sorted(range(len(spans)),
                   key=lambda i: (spans[i]["ts"], -spans[i]["dur"]))
    own = [s["dur"] for s in spans]
    stack = []
    for i in order:
        s = spans[i]
        while stack and _end(spans[stack[-1]]) <= s["ts"]:
            stack.pop()
        if stack:
            p = stack[-1]
            own[p] -= min(_end(s), _end(spans[p])) - s["ts"]
        stack.append(i)
    return own


def starts_in(s, outer):
    return outer["ts"] <= s["ts"] < _end(outer)


def idle_in(intervals, busy):
    """The device's idle time inside the union of ``intervals``: their
    length less what the merged, sorted intervals ``busy`` cover."""
    starts = [x for x, _ in busy]
    out = 0.0
    for a, b in union(intervals):
        out += b - a
        k = max(bisect_right(starts, a) - 1, 0)
        while k < len(busy) and busy[k][0] < b:
            out -= max(0.0, min(b, busy[k][1]) - max(a, busy[k][0]))
            k += 1
    return out


def self_ms_per_call(rec, name, call):
    """Mean self time of the spans ``name`` inside one traced call
    (``objective.<call>``), over those calls; None without both."""
    tr = rec.get("trace")
    if tr is None:
        return None
    spans = tr["spans"]
    calls = [s for s in spans if s["name"] == "objective." + call]
    hits = [i for i, s in enumerate(spans) if s["name"] == name
            and any(starts_in(s, c) for c in calls)]
    if not calls or not hits:
        return None
    own = self_times(spans)
    return 1e-3 * sum(own[i] for i in hits) / len(calls)


def idle_ms_per_call(rec, name, call):
    """Mean idle time of the device inside the spans ``name`` of one traced
    call (``objective.<call>``), over those calls; None without both."""
    tr = rec.get("trace")
    if tr is None:
        return None
    spans = tr["spans"]
    calls = [s for s in spans if s["name"] == "objective." + call]
    hits = [s for s in spans if s["name"] == name
            and any(starts_in(s, c) for c in calls)]
    if not calls or not hits:
        return None
    return 1e-3 * idle_in([(s["ts"], _end(s)) for s in hits],
                          tr["busy"]) / len(calls)


def self_ms_per_iteration(rec, names):
    """Self time of the spans named in ``names`` in the traced stretch, per
    traced iteration; None without them."""
    tr = rec.get("trace")
    if tr is None:
        return None
    spans = tr["spans"]
    a, b = tr["stretch"]
    its = [s for s in spans if s["name"] == "iteration"]
    hits = [i for i, s in enumerate(spans) if s["name"] in names
            and a <= s["ts"] < b]
    if not its or not hits:
        return None
    own = self_times(spans)
    return 1e-3 * sum(own[i] for i in hits) / len(its)


def owners(spans, a, b):
    """[(start, end, name)] pieces that cover [a, b] in order, each named
    by the span the host was in there: the innermost program span, else
    the innermost objective call, else ``driver`` (innermost: the latest
    start, then the shorter)."""
    ranked = sorted((s for s in spans if s["name"].startswith(
        PROGRAM + (CALL,)) and _end(s) > a and s["ts"] < b),
        key=lambda s: s["ts"])
    cuts = sorted({a, b} | {min(max(x, a), b) for s in ranked
                            for x in (s["ts"], _end(s))})
    out, active, k = [], [], 0
    for t0, t1 in zip(cuts, cuts[1:]):
        while k < len(ranked) and ranked[k]["ts"] <= t0:
            active.append(ranked[k])
            k += 1
        active = [s for s in active if _end(s) > t0]
        name = "driver"
        if active:
            name = max(active, key=lambda s: (s["name"].startswith(PROGRAM),
                                              s["ts"], -s["dur"]))["name"]
        out.append((t0, t1, name))
    return out


def unattributed_idle_pct(rec):
    """100 x the device's idle time in the traced stretch while the host is
    in no program span, over its idle time in the stretch; None without
    program spans or idle time."""
    tr = rec.get("trace")
    if tr is None:
        return None
    a, b = tr["stretch"]
    prog = [(max(s["ts"], a), min(_end(s), b)) for s in tr["spans"]
            if s["name"].startswith(PROGRAM) and _end(s) > a and s["ts"] < b]
    idle = (b - a) - sum(y - x for x, y in tr["busy"])
    if not prog or idle <= 0:
        return None
    return 100.0 * (idle - idle_in(prog, tr["busy"])) / idle
