"""prepare_ms.gradient: layer objective. Per traced gradient call, the
self time of the program's ``fwi.prepare`` spans inside it: the model
update, the call's tables and operands, the memory budget and route, the
illumination factors, the observed and direct-wave stacks. Moves
gradient_ms."""
from fwibench.spans import self_ms_per_call


def read(rec):
    return self_ms_per_call(rec, "fwi.prepare", "gradient")
