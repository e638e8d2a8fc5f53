"""Work of one elastic velocity-stress objective call on the padded grid.

Per cell-step, with r = space_order / 2 and a first derivative of 2r taps
costing 4r operations: the forward's eight derivatives and the velocity
and stress updates, 32r + 31; the gradient's reverse sweep twelve
derivatives, the adjoint updates and the images, 48r + 52, on top of the
forward. Steps: nt - 1. Point work is not counted.

Bytes: every input read once and every output written once, float32: the
parameters lam, mu, b and the mask profile, the wavelet, the observed and
the direct-wave traces; a trial writes the residual traces, a gradient also
the gradient of the physical grid. No forward history is counted.
"""


def work(kind, sizes):
    r = sizes["space_order"] // 2
    cells = sizes["shots"] * sizes["padded_cells"]
    steps = sizes["nt"] - 1
    per_step = 32 * r + 31
    if kind == "gradient":
        per_step += 48 * r + 52
    traces = sizes["shots"] * sizes["nt"] * sizes["nrec"]
    nbytes = 4 * (4 * sizes["padded_cells"] + sizes["nt"] + 3 * traces)
    if kind == "gradient":
        nbytes += 4 * sizes["cells"]
    return cells * steps * per_step, nbytes
