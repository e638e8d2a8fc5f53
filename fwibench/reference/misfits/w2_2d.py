"""W2-2d (``--misfit 2``, devito-fwi ``qWasserstein(gamma=1.01,
method="2d")``, ``misfit/misfit.py:69-79``): the quadratic-Wasserstein
distance of each shot's direct-wave-free gather to the observed one, solved
by the back-and-forth method of the QW2D C solver (``fot2d.c``,
``fotGradient2d`` at ``fot2d.c:606-656``), summed over the shots.

Per gather f = syn - dw, g = obs - dw (time rows y, receiver columns x):

* the linear positivity shift: c = gamma max(0, -min(f, g)), mu = f + c,
  nu = g + c (``misfit.py:20-45``; its chain-rule factor is 1);
* the unit-mean normalisation mu / mean(mu), nu / mean(nu) on the grid of
  cell centres x_i = (i + 1/2) / n1, y_k = (k + 1/2) / n2;
* ``NUM_STEPS`` back-and-forth steps from phi = psi = |x|^2 / 2 with the
  step sigma = ``STEP_SCALE`` / max(mu, nu) (``fot2d.c:606-656``). Each
  half step takes an H^-1 ascent step on one potential, a DCT Poisson
  solve of its density gap (``fot2d.c:459-482``, the negative-Laplace
  kernel of ``fot2d.c:4-17``); convexifies it by two c-transforms
  (``fot2d.c:50-178``); pushes the other density through the gradient map
  of the new potential (``fot2d.c:294-457``); and moves sigma by 1/0.8 or
  0.8 where the dual's gain is more than 3/4 or less than 1/4 of its
  predicted h1 sigma (``fot2d.c:484-496``);
* the value: the dual <|x|^2/2, mu + nu> - <nu, phi> - <mu, psi>, mean over
  the grid, at the last half step;
* the gradient of the value with respect to f: (|x|^2/2 - psi - <mu,
  |x|^2/2 - psi>) / mean(mu), divided once more by mean(mu) as
  ``misfit.py:73`` divides it, and carried back to the traces by the
  shift's factor 1.

Everything is computed in float64 whatever the traces' dtype, and the
residual handed back in theirs: the BFM's thresholds (the cells the
pushforward keeps, the step's moves, which sample a point lands in) make
float32 solves of the same gathers disagree by 3e-4 to 1e-2 of the value
with the order of their sums, so a float32 reference would be as far from
the truth as the program it judges. ``misfit``'s ``dtype`` lowers the
solve's precision for the control of the comparison
(``fwibench/control_misfit.py``); the runs leave it at float64.

Where this departs from ``fot2d.c`` it computes the same numbers by a
plainer method, or follows the batch solvers the devito-fwi drivers run:

* the c-transform max_j (s_i s_j - u_j) by brute force on every line, in
  blocks of at most ``BLOCK_ELEMS`` candidates, where ``fot2d.c`` scans
  the lower convex hull in O(n): the same maxima;
* the DCT-II and DCT-III as products with the orthonormal cosine matrix,
  where ``fot2d.c`` calls FFTW's REDFT10/REDFT01 and scales: the same
  Poisson solution;
* the pushforward supersamples every cell 2 x 2 (the C solver's least
  sampling; it raises it per cell with the map's stretch) and scatters
  each sample's mass bilinearly with ``index_add_``; cells that stretch
  past (1/n)^(1/3) on either axis are dropped, as ``fot2d.c:419-423``
  drops them;
* the map is the central difference of the edge-replicated potential at
  the cell corners (``fot2d.c:294-325``).

``NUM_STEPS``, ``STEP_SCALE`` and ``GAMMA`` are ``marmousi_fwi.py``'s
``--misfit 2`` settings, which the configuration ``smarmn-w2``
states as ``w2_num_steps`` and ``w2_step_scale``."""
import math

import torch

NUM_STEPS = 15
STEP_SCALE = 1.0
GAMMA = 1.01
NSUB = 2
BLOCK_ELEMS = 1 << 26


def misfit(syn, obs, dw, dtype=torch.float64):
    """(the sum of the shots' W2-2d values as a float, its cotangent of
    ``syn`` in ``syn``'s dtype) of (shots, time, receivers) traces, solved
    in ``dtype``."""
    f = syn.to(dtype) - dw.to(dtype)
    g = obs.to(dtype) - dw.to(dtype)
    low = torch.minimum(f.amin(dim=(1, 2)), g.amin(dim=(1, 2)))
    shift = (GAMMA * torch.clamp(-low, min=0.0))[:, None, None]
    mu, nu = f + shift, g + shift
    values, grads = solve(mu, nu, NUM_STEPS, STEP_SCALE)
    mass = mu.mean(dim=(1, 2))
    mass = torch.where(mass > 0, mass, torch.ones_like(mass))
    res = grads / mass[:, None, None]
    return float(values.sum()), res.to(syn.dtype)


def c_transform(u, s):
    """out[..., i] = max_j (s_i s_j - u[..., j]) along the last axis, by
    brute force in blocks of outputs."""
    n = s.shape[0]
    rows = u.numel() // n
    blk = max(1, min(n, BLOCK_ELEMS // (rows * n)))
    out = torch.empty_like(u)
    for i in range(0, n, blk):
        cand = s[i:i + blk, None] * s[None, :] - u[..., None, :]
        out[..., i:i + blk] = cand.amax(dim=-1)
    return out


def c_transform_2d(u, xs, ys):
    """out[..., k, i] = max_{l, j} (x_i x_j + y_k y_l - u[..., l, j]): over
    the receivers' axis, then over time."""
    a = c_transform(u, xs)
    return c_transform(-a.transpose(-1, -2), ys).transpose(-1, -2)


def dct_matrix(n, dtype, dev):
    """The orthonormal DCT-II matrix C[k, i] (its transpose is the
    DCT-III), built in float64."""
    k = torch.arange(n, dtype=torch.float64, device=dev)[:, None]
    i = torch.arange(n, dtype=torch.float64, device=dev)[None, :]
    c = math.sqrt(2.0 / n) * torch.cos(math.pi * (i + 0.5) * k / n)
    c[0] /= math.sqrt(2.0)
    return c.to(dtype)


def gradient_map(psi):
    """(x, y) of the map grad(psi) at the (n2 + 1, n1 + 1) cell corners:
    the difference of the two cell pairs either side of a corner, each
    summed over the two cells across it, over their distance 2 / n; rows
    and columns outside the grid repeat the edge."""
    B, n2, n1 = psi.shape
    dev = psi.device
    r = torch.arange(n2 + 1, device=dev)
    c = torch.arange(n1 + 1, device=dev)

    def at(dr, dc):
        rows = torch.clamp(r + dr, 0, n2 - 1)[:, None]
        cols = torch.clamp(c + dc, 0, n1 - 1)[None, :]
        return psi[:, rows, cols]

    across = (-1, 0)
    x = sum(at(d, 0) + at(d, 1) - at(d, -2) - at(d, -1) for d in across)
    y = sum(at(0, d) + at(1, d) - at(-2, d) - at(-1, d) for d in across)
    return n1 / 8.0 * x, n2 / 8.0 * y


def pushforward(dens, psi):
    """The density ``dens`` pushed through grad(psi), normalised to unit
    mean: each kept cell's mass split over NSUB x NSUB samples at the
    bilinear image of their positions in the cell, each sample's mass
    spread bilinearly over the four cells around where it lands (indices
    clamped to the grid)."""
    B, n2, n1 = dens.shape
    mx, my = gradient_map(psi)
    corners_x = (mx[:, :-1, :-1], mx[:, :-1, 1:], mx[:, 1:, :-1],
                 mx[:, 1:, 1:])
    corners_y = (my[:, :-1, :-1], my[:, :-1, 1:], my[:, 1:, :-1],
                 my[:, 1:, 1:])
    sx = torch.maximum((corners_x[1] - corners_x[0]).abs(),
                       (corners_x[3] - corners_x[2]).abs())
    sy = torch.maximum((corners_y[2] - corners_y[0]).abs(),
                       (corners_y[3] - corners_y[1]).abs())
    keep = (dens > 0) & (sx < (1.0 / n1) ** (1.0 / 3)) \
        & (sy < (1.0 / n2) ** (1.0 / 3))
    mass = torch.where(keep, dens, torch.zeros_like(dens)) / NSUB ** 2
    rho = dens.new_zeros(B * n2 * n1)
    base = (torch.arange(B, device=dens.device) * n2 * n1)[:, None, None]
    for l in range(NSUB):
        for k in range(NSUB):
            a, b = (k + 0.5) / NSUB, (l + 0.5) / NSUB
            w = ((1 - b) * (1 - a), (1 - b) * a, b * (1 - a), a * b)
            px = sum(wi * ci for wi, ci in zip(w, corners_x))
            py = sum(wi * ci for wi, ci in zip(w, corners_y))
            X, Y = px * n1 - 0.5, py * n2 - 0.5
            i0, k0 = torch.floor(X), torch.floor(Y)
            fx, fy = X - i0, Y - k0
            i0, k0 = i0.long(), k0.long()
            for dy, wy in ((0, 1 - fy), (1, fy)):
                for dx, wx in ((0, 1 - fx), (1, fx)):
                    cell = base + torch.clamp(k0 + dy, 0, n2 - 1) * n1 \
                        + torch.clamp(i0 + dx, 0, n1 - 1)
                    rho.index_add_(0, cell.reshape(-1),
                                   (wy * wx * mass).reshape(-1))
    rho = rho.reshape(B, n2, n1)
    total = rho.mean(dim=(1, 2), keepdim=True)
    return rho / torch.where(total > 0, total, torch.ones_like(total))


def solve(f, g, num_steps, step_scale):
    """(values (B,), d value / d f (B, n2, n1)) of two positive stacks of
    gathers (B, n2, n1), in ``f``'s dtype; a shot with no mass reads 0 and
    0."""
    B, n2, n1 = f.shape
    dtype, dev = f.dtype, f.device
    zero = f.new_zeros(())
    mean_f = f.mean(dim=(1, 2))[:, None, None]
    mean_g = g.mean(dim=(1, 2))[:, None, None]
    mu = torch.where(mean_f > 0, f / mean_f, zero)
    nu = torch.where(mean_g > 0, g / mean_g, zero)
    peak = torch.maximum(mu.amax(dim=(1, 2)), nu.amax(dim=(1, 2)))
    live = peak > 0
    sigma = torch.where(live, step_scale / torch.where(live, peak, 1.0),
                        1.0)

    xs = ((torch.arange(n1, dtype=torch.float64) + 0.5) / n1).to(dev, dtype)
    ys = ((torch.arange(n2, dtype=torch.float64) + 0.5) / n2).to(dev, dtype)
    half_sq = 0.5 * (xs[None, :] ** 2 + ys[:, None] ** 2)
    f64 = torch.float64
    lap = (2.0 * n1 * n1 * (1 - torch.cos(math.pi * torch.arange(
        n1, dtype=f64, device=dev) / n1)))[None, :] \
        + (2.0 * n2 * n2 * (1 - torch.cos(math.pi * torch.arange(
            n2, dtype=f64, device=dev) / n2)))[:, None]
    lap[0, 0] = 1.0
    lap = lap.to(dtype)
    c1, c2 = dct_matrix(n1, dtype, dev), dct_matrix(n2, dtype, dev)

    def ascend(pot, pushed, target, sigma):
        gap = pushed - target
        w = c2 @ gap @ c1.T / lap
        w[:, 0, 0] = 0.0
        w = c2.T @ w @ c1
        return pot + sigma[:, None, None] * w, (w * gap).mean(dim=(1, 2))

    def dual_value(phi, psi):
        return (half_sq * (mu + nu) - nu * phi - mu * psi).mean(dim=(1, 2))

    def new_sigma(sigma, value, old, h1):
        gain = value - old
        return torch.where(gain > 0.75 * h1 * sigma, sigma / 0.8,
                           torch.where(gain < 0.25 * h1 * sigma,
                                       sigma * 0.8, sigma))

    phi = psi = half_sq.expand(B, n2, n1)
    pushed = mu
    old = dual_value(phi, psi)
    for _ in range(num_steps):
        phi, h1 = ascend(phi, pushed, nu, sigma)
        psi = c_transform_2d(phi, xs, ys)
        phi = c_transform_2d(psi, xs, ys)
        value = dual_value(phi, psi)
        sigma, old = new_sigma(sigma, value, old, h1), value
        pushed = pushforward(nu, phi)
        psi, h1 = ascend(psi, pushed, mu, sigma)
        phi = c_transform_2d(psi, xs, ys)
        psi = c_transform_2d(phi, xs, ys)
        pushed = pushforward(mu, psi)
        value = dual_value(phi, psi)
        sigma, old = new_sigma(sigma, value, old, h1), value

    dpsi = half_sq - psi
    grad = (dpsi - (mu * dpsi).mean(dim=(1, 2))[:, None, None]) / mean_f
    grad = torch.where(mean_f > 0, grad, zero)
    return torch.where(live, old, zero), grad
