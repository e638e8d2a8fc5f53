"""Work of one acoustic OT2 objective call on the padded grid.

Per cell-step, with r = space_order / 2: the update is a Laplacian of two
axes of (1 + 3r) operations each and their two scales, 6r + 5, and the
leapfrog update with the damping, 7: 6r + 12 (the forward). The gradient
adds the illumination u^2 summed, 2, the adjoint sweep, 6r + 12, and the
imaging condition -u.dt2 v summed, 6 (second difference 3, its scale 1,
product and sum 2). Steps: nt - 2 each way. Point work (sources,
receivers) is below a thousandth of the grid's and is not counted.

Bytes: every input read once and every output written once, float32: the
model and the damping profile, the wavelet, the observed and the
direct-wave traces; a trial writes the residual traces, a gradient also
the gradient of the physical grid. No forward history is counted: where
the sweeps keep one is a choice of the implementation.
"""


def work(kind, sizes):
    r = sizes["space_order"] // 2
    cells = sizes["shots"] * sizes["padded_cells"]
    steps = sizes["nt"] - 2
    fwd = 6 * r + 12
    per_step = fwd if kind == "trial" else fwd + 2 + (6 * r + 12) + 6
    traces = sizes["shots"] * sizes["nt"] * sizes["nrec"]
    nbytes = 4 * (2 * sizes["padded_cells"] + sizes["nt"] + 3 * traces)
    if kind == "gradient":
        nbytes += 4 * sizes["cells"]
    return cells * steps * per_step, nbytes
