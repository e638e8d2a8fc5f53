"""elastic_gradient_roofline: the kernels' share of their roofline, the least
time of the traced gradient calls over the device time of the role's
kernels (roles/elastic_gradient.json) inside them. Moves gradient_ms."""
from fwibench.lib import role_share


def read(rec):
    return role_share(rec, "elastic_gradient")
