"""finish_ms.gradient: layer objective. Per traced gradient call, the
device's idle time inside the program's ``fwi.finish`` spans: the host's
tail after the last kernel (precondition, mask, the copy to the host,
float64). Moves gradient_ms."""
from fwibench.spans import idle_ms_per_call


def read(rec):
    return idle_ms_per_call(rec, "fwi.finish", "gradient")
