"""elastic_trial_roofline: the kernels' share of their roofline, the least
time of the traced trial calls over the device time of the role's
kernels (roles/elastic_trial.json) inside them. Moves trial_ms."""
from fwibench.lib import role_share


def read(rec):
    return role_share(rec, "elastic_trial")
