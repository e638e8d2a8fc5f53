"""Work of one objective call's W2-2d pushforwards, the part of the
misfit layer (``misfit/bfm.py``) that the slab kernel does.

A call solves the back-and-forth method once on every shot's (nt x nrec)
gather, n = nt nrec cells, and each of its ``w2_num_steps`` steps pushes
one density through one potential's gradient map twice: 2 x
``w2_num_steps`` pushforwards of every shot, the same in a trial and in a
gradient. The W2 misfit solves with 2 x 2 samples a cell (``NSUB``, what
``qWasserstein`` leaves to ``bfm_batch``), Q = 4.

Operations of one pushforward of one gather:

* the map: at each of the (nt + 1)(nrec + 1) cell corners, each of its two
  components is a four-point difference of two-point sums and its scale,
  one new sum, three additions and a product: 10 a corner;
* the spread, for each of a cell's Q samples: its position, a bilinear
  blend of the four corners on each axis (4 products, 3 sums) put on the
  grid (a product and a sum), 18; its cell and fractions, a floor and a
  difference on each axis, 4; the complements of the fractions, 2; the
  four bilinear weights times the mass, 8; their four additions into the
  target cells, 4: 36 a sample.

Point work of the kept-cell test, the normalisation and the index clamps
is not counted. Bytes: the density and the potential read once and the
pushed density written once, float32: 12 n.
"""

NSUB = 2


def work(kind, sizes):
    nt, nrec = sizes["nt"], sizes["nrec"]
    pushes = 2 * sizes["w2_num_steps"] * sizes["shots"]
    ops = 10 * (nt + 1) * (nrec + 1) + 36 * NSUB * NSUB * nt * nrec
    return pushes * ops, pushes * 12 * nt * nrec
