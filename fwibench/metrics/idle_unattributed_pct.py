"""idle_unattributed_pct: layer device. 100 x the device's idle time in
the traced stretch while the host is in none of the program's spans
(``fwi.*``, ``loop.*``), over the device's idle time in the stretch. Moves
iter_s."""
from fwibench.spans import unattributed_idle_pct


def read(rec):
    return unattributed_idle_pct(rec)
