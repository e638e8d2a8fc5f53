"""w2_push_roofline: layer ops/cuda_bfm.py. The slab kernel's share of its
roofline, the least time of the traced trial calls' pushforwards (the
count counts/bfm_push.py) over the device time of the role's kernel
(roles/w2_push_trial.json) inside them. Moves trial_ms."""
from fwibench.lib import role_share


def read(rec):
    return role_share(rec, "w2_push_trial")
