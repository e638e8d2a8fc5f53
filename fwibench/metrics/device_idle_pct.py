"""device_idle_pct: layer device. The share of the traced stretch (whole
iterations) in which nothing runs on the card: one less the union of the
kernel, copy and set intervals over the stretch. Moves iter_s."""


def read(rec):
    tr = rec.get("trace")
    if tr is None or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
