"""prepare_ms.trial: layer objective. Per traced trial call, the self time
of the program's ``fwi.prepare`` spans inside it (as
``prepare_ms.gradient``). Moves trial_ms."""
from fwibench.spans import self_ms_per_call


def read(rec):
    return self_ms_per_call(rec, "fwi.prepare", "trial")
