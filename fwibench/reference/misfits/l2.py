"""L2 (``--misfit 0``, devito-fwi ``least_square``) of the direct-wave-free
traces: 0.5 sum r^2 in float64, r = (syn - dw) - (obs - dw)."""
import torch


def misfit(syn, obs, dw):
    res = (syn - dw) - (obs - dw)
    return float(0.5 * torch.sum(res.double() ** 2)), res
