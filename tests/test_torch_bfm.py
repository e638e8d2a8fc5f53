"""The port's batch BFM (devito_fwi_tpu_torch.misfit.bfm) and its slab
kernel's plain twin (ops.cuda_bfm) against the JAX package, on the CPU:

* Legendre transforms, full and anchored, output and certificate, for
  n < 512 and n >= 512 and for a state whose certificate fails: 1e-6 of
  the max (the JAX transform may contract s_i*s_j - u_j into a
  multiply-add; the port does not);
* the banded Legendre kernel's twin (``cuda_bfm.legendre_banded``) against
  the Pallas kernel in interpret mode, for both bands, in band and
  displaced: the flag identical, the output within 1e-6 of the max
  (measured 1.2e-7: the interpreter contracts the product and the
  subtraction into one multiply-add, the twin rounds twice as the card
  kernel does), and bitwise the full transform where the flag holds; the
  banded route (``_legendre_last_fast``) against the JAX one; ``bfm_batch``
  on it bitwise the anchored route; the card kernel's certificate (region
  maxima, the pad lanes added once) replayed in numpy: the twin's flag on
  every row, NaN, +-inf and rows at or below -big included; its launch
  helper against a block's shared memory;
* the anchored kernel (``cuda_bfm.legendre_anchored``): its certificate
  (the banded kernel's walk at the anchors' regions) replayed in numpy
  against its twin's flag row by row; its launch helper at the W2 cell's
  two pass shapes; the wrapper on the CPU running the twin, the torch
  evaluation, bitwise, and raising for what the kernel does not take; the
  anchored route off the card taking the torch evaluation, its kernel
  counter at 0;
* the map, the subsamples and the adaptive mask: the integer planes equal,
  the float planes to 1e-6 of their max;
* the slab twins (natural and blocked layouts) against the Pallas kernels
  in interpret mode on the same planes and against a direct loop over the
  contributions, and the whole slab pushforward against the JAX
  ``_pallas_push`` at row shifts 0 and 40: 1e-6 of the max (the same sums
  in the same order; the interpreter may round a multiply-add
  differently);
* the card slab kernel's order (csrc/bfm_push.cu: each output's non-zero
  products sorted by (g, e, q), then v over q, acc over e, slab over g)
  replayed in numpy on seeded planes and on a pile-up: bitwise the twin in
  both layouts; its launch helper against a block's shared memory;
* the banded-product tier and the scatter against their JAX counterparts
  (1e-5 of the max, the products summing in another order), the tier
  choice against the JAX predicates on the same states, and the adaptive
  two-pass pushforward (nsub = 0) at float64 (1e-12) and float32 (1e-5);
* the two regressions of tests/test_pallas_bfm.py (an active dy equal to
  the fill value; n1 a multiple of 128);
* ``bfm_batch`` against ``bfm_jax_batch`` on the two-blob fixture: loss
  rtol 1e-4 and gradient 1e-4 of its max at float32 (the JAX side on its
  XLA pushforward tier, the port on the slab tier), and at float64 through
  the scatter tier on both sides to 1e-10.
"""
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from devito_fwi_tpu_torch.ops import cuda_bfm as cb

# the module: the package exports the class ``bfm`` under the same name
T = importlib.import_module("devito_fwi_tpu_torch.misfit.bfm")
JB = importlib.import_module("devito_fwi_tpu.misfit.bfm")
PB = importlib.import_module("devito_fwi_tpu.ops.pallas_bfm")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch CPU thread while this module runs: the suite runs several
    pytest workers on one machine, and torch's thread pool in each of them
    (as many threads as cores) oversubscribes the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _np(a):
    return a.numpy() if torch.is_tensor(a) else np.asarray(a)


def _close(got, want, rtol):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got.astype(np.float64) - want).max()
    assert err <= rtol * scale, (err, scale)


# ---------------------------------------------------------------------------
# Legendre transforms
# ---------------------------------------------------------------------------

def _legendre_input(n, shift, seed=0):
    rng = np.random.RandomState(seed)
    s = ((np.arange(n) + 0.5) / n).astype(np.float32)
    u = (0.5 * s[None, None, :] ** 2
         + 5e-4 * rng.rand(2, 9, n)).astype(np.float32)
    return s, np.roll(u, shift, axis=-1)


@pytest.mark.parametrize("n,shift,ok", [(300, 0, True), (700, 0, True),
                                        (700, 250, False)])
def test_legendre_transforms_match_jax(n, shift, ok):
    s, u = _legendre_input(n, shift)
    full_j = JB._legendre_last(jnp.asarray(u), jnp.asarray(s), 32_000_000)
    _close(T._legendre_last(torch.tensor(u), torch.tensor(s)), full_j, 1e-6)
    A, W = (32, 64) if n >= 512 else (8, 32)
    out_j, ok_j = JB._legendre_last_anchored(jnp.asarray(u), jnp.asarray(s),
                                             A, W)
    out_t, ok_t = T._legendre_last_anchored(torch.tensor(u), torch.tensor(s),
                                            A, W)
    assert bool(ok_t) == bool(ok_j) == ok
    if ok:
        _close(out_t, out_j, 1e-6)
    # the certificate-guarded transform falls back to the full one
    T.reset_counts()
    fast = T._legendre_last_anchor_fast(torch.tensor(u), torch.tensor(s))
    _close(fast, full_j, 1e-6)
    assert T.COUNTS["legendre_reads"] == 1
    assert T.COUNTS["legendre_fallbacks"] == (0 if ok else 1)


def test_legendre_2d_matches_jax():
    rng = np.random.RandomState(1)
    n2, n1 = 120, 140
    xs = ((np.arange(n1) + 0.5) / n1).astype(np.float32)
    ys = ((np.arange(n2) + 0.5) / n2).astype(np.float32)
    u = (0.5 * (xs[None, :] ** 2 + ys[:, None] ** 2)
         + 1e-3 * rng.rand(2, n2, n1)).astype(np.float32)
    want = JB._legendre_2d(jnp.asarray(u), jnp.asarray(xs), jnp.asarray(ys),
                           32_000_000, banded="anchor")
    got = T._legendre_2d(torch.tensor(u), torch.tensor(xs), torch.tensor(ys),
                         32_000_000, "anchor")
    _close(got, want, 1e-6)


def _f32_grid(n):
    """s_i = (i + 0.5)/n formed in float32, as the banded kernel's table."""
    return (np.arange(n, dtype=np.float32) + np.float32(0.5)) / np.float32(n)


@pytest.mark.parametrize("shift", [0, 30], ids=["in_band", "displaced"])
@pytest.mark.parametrize("W,K,n,rows", [(24, 8, 300, 37), (48, 16, 600, 45)],
                         ids=["W24K8", "W48K16"])
def test_legendre_banded_twin_matches_pallas_interpret(W, K, n, rows,
                                                       shift):
    rng = np.random.RandomState(0)
    u = (0.5 * _f32_grid(n)[None, :].astype(np.float64) ** 2
         + 5e-4 * rng.rand(rows, n)).astype(np.float32)
    u = np.roll(u, shift, axis=-1)
    out_j, ok_j = PB.legendre_banded(jnp.asarray(u), W, K, interpret=True)
    cb.reset_counters()
    out_t, ok_t = cb.legendre_banded(torch.tensor(u), W, K)
    assert cb.TWIN_CALLS["legendre_banded"] == 1
    assert sum(cb.LAUNCHES.values()) == 0
    assert ok_t.dtype == torch.bool and ok_t.dim() == 0
    assert bool(ok_t) == bool(ok_j) == (shift == 0)
    _close(out_t, out_j, 1e-6)
    if shift == 0:
        full = T._legendre_last(torch.tensor(u), torch.tensor(_f32_grid(n)))
        assert torch.equal(out_t, full)


def _region_flags(u, s, K, nsamp, npad, limits):
    """A numpy replay, in float32, of the card kernels' certificate
    (csrc/bfm_legendre.cu): per row and sample i_m = min(m K, n-1) the
    maxima of A = [0, a), of B and of C = [c1, npad), (a, c1) =
    ``limits(m, i)`` (banded: i_{m+1} - W and i_{m-1} + W + 1; anchored:
    i_m - Wside and i_{m-1} + W - Wside), the real lanes as the walk
    switches at a and c1 (maxima that propagate NaN, as max.NaN does), the
    npad - n pad lanes added as -big to the regions they fall in; a sample
    passes iff its max is NaN (no lane is a hit), or A is empty or max A <
    max, and C is empty or max C < max. Returns the flag of each row."""
    rows, n = u.shape
    big = np.float32(np.finfo(np.float32).max / 8)
    inf = np.float32(np.inf)

    def sample(m):
        return min(m * K, n - 1)

    def rmax(v):
        return np.maximum.reduce(v, axis=1, initial=-inf)

    ok = np.ones(rows, bool)
    for m in range(nsamp):
        v = s[sample(m)] * s[None, :] - u
        al, c1 = limits(m, sample)
        al = al if m + 1 < nsamp else -2 ** 31
        c1 = c1 if m >= 1 else 2 ** 31 - 1
        a = max(al, 0)
        mA = rmax(v[:, :a])
        if c1 < n:
            mB, mC = rmax(v[:, a:c1]), rmax(v[:, c1:])
        else:
            mB, mC = rmax(v[:, a:]), np.full(rows, -inf)
        if npad > n:
            if c1 <= n:
                mC = np.maximum(mC, -big)
            else:
                mB = np.maximum(mB, -big)
                if c1 < npad:
                    mC = np.maximum(mC, -big)
        M = np.maximum(np.maximum(mA, mB), mC)
        ok &= np.isnan(M) | (((al <= 0) | (mA < M))
                             & ((c1 >= npad) | (mC < M)))
    return ok


def _banded_flags(u, W, K):
    """``_region_flags`` at the banded kernel's geometry."""
    n = u.shape[1]
    return _region_flags(u, _f32_grid(n), K, -(-(n - 1) // K) + 1,
                         -(-n // 128) * 128,
                         lambda m, i: (i(m + 1) - W, i(m - 1) + W + 1))


def _anchored_flags(u, s, A, Wside):
    """``_region_flags`` at the anchored kernel's geometry: the anchors
    min(m A, n-1), m = 0 .. ceil(n/A), no pad lanes."""
    n = u.shape[1]
    W = -(-(2 * Wside + A) // A) * A
    return _region_flags(u, s, A, -(-n // A) + 1, n,
                         lambda m, i: (i(m) - Wside, i(m - 1) + W - Wside))


def _certificate_rows(n, rows=12, seed=1):
    """Seeded rows near 0.5 s^2 in band, rolled past the band, holding a
    NaN, at big, past big, +inf (every real lane at or below -big, so the
    pad lanes hold the max when n is no multiple of 128), -inf at one lane,
    and one with a spike that moves one sample's argmax."""
    rng = np.random.default_rng(seed)
    s = _f32_grid(n).astype(np.float64)
    base = (0.5 * s[None, :] ** 2 + 5e-4 * rng.uniform(size=(rows, n)))
    u = base.astype(np.float32)
    big = np.float32(np.finfo(np.float32).max / 8)
    u[1] = np.roll(u[1], 40)
    u[2, n // 3] = np.nan
    u[3] = big
    u[4] = np.float32(2) * big
    u[5] = np.inf
    u[6, n // 2] = -np.inf
    u[7, n // 4] -= np.float32(0.2)
    u[8] = np.roll(u[8], -40)
    return u


@pytest.mark.parametrize("W,K,n", [(24, 8, 300), (48, 16, 1357),
                                   (24, 8, 256), (48, 16, 640)],
                         ids=["n300", "n1357", "n256_no_pad", "n640"])
def test_legendre_region_certificate_equals_twin(W, K, n):
    """The card kernel's certificate (maxima of the regions left of
    i_{m+1} - W and right of i_{m-1} + W against the row's max, the pad
    lanes added once) gives the twin's first/last flag row by row, on rows
    in band and displaced, with NaN, at and past -big, at +-inf."""
    u = _certificate_rows(n)
    got = _banded_flags(u, W, K)
    want = np.array([bool(cb.legendre_banded_plain(
        torch.tensor(u[r:r + 1]), W, K)[1]) for r in range(u.shape[0])])
    assert got.tolist() == want.tolist()
    assert want[0] and want[2] and not want[1] and not want[3]
    assert not want.all()


def test_legendre_launch_fits_shared_memory():
    """The banded kernel's launch at both bands of the 29-shot SMARMN state
    (39,353 rows of 300 at W/K 24/8, 8,700 rows of 1357 at 48/16), at the
    longest rows and at the widest band it takes fits a block's 232,448
    bytes; K > W, short or over-long rows, grids past 2^31 blocks and
    wider bands raise."""
    a = cb.legendre_launch(39353, 300, 24, 8)
    assert (a.threads, a.tile, a.tiles, a.samples, a.passes) == \
        (256, 304, 1, 5, 1)
    assert (a.band_blocks, a.cert_blocks, a.grid) == (1230, 1230, 2460)
    assert (a.band_smem, a.cert_smem, a.smem) == (56_864, 40_256, 56_864)
    b = cb.legendre_launch(8700, 1357, 48, 16)
    assert (b.tile, b.tiles, b.samples, b.passes) == (344, 4, 6, 2)
    assert (b.band_blocks, b.cert_blocks, b.grid) == (1088, 544, 1632)
    assert (b.band_smem, b.cert_smem, b.smem) == (68_480, 45_536, 68_480)
    for x, n, K in ((a, 300, 8), (b, 1357, 16)):
        assert x.rows_a_block == 32 and 3 * x.smem <= 232_448
        assert x.passes * 8 * x.samples >= -(-(n - 1) // K) + 1
    # the longest rows: 2^30 lanes
    big = cb.legendre_launch(1, 2 ** 30, 48, 16)
    assert big.tile == 384 and big.tiles * 384 >= 2 ** 30
    assert big.samples == 8 and big.passes * 64 >= 2 ** 26 + 1
    assert big.smem <= 232_448
    # the widest band: W = 651, ND = 8 ceil((2W+1)/8) = 1304 lanes of halo
    assert cb.legendre_launch(1, 3840, 651, 1).smem == 232_160
    for args in ((1, 3840, 652, 1), (1, 300, 8, 16), (1, 300, 0, 1),
                 (1, 300, 24, 0), (0, 300, 24, 8), (4, 1, 24, 8),
                 (1, 2 ** 30 + 1, 48, 16), (2 ** 31, 10 ** 4, 48, 16)):
        with pytest.raises(ValueError):
            cb.legendre_launch(*args)


@pytest.mark.parametrize("n", [300, 1357, 301])
def test_legendre_anchored_region_certificate_equals_twin(n):
    """The anchored kernel's certificate (the banded kernel's walk, with
    the regions left of i_m - Wside and right of i_{m-1} + W - Wside - 1 at
    the anchors min(m A, n-1), no pad lanes) gives the twin's flag row by
    row, on rows in band and displaced, with NaN, at and past -big, at
    +-inf."""
    u = _certificate_rows(n)
    s = _f32_grid(n)
    A, Wside = (32, 64) if n >= 512 else (8, 32)
    got = _anchored_flags(u, s, A, Wside)
    want = np.array([bool(cb.legendre_anchored_plain(
        torch.tensor(u[r:r + 1]), torch.tensor(s), A, Wside)[1])
        for r in range(u.shape[0])])
    assert got.tolist() == want.tolist()
    assert want[0] and want[2] and not want[3] and not want[7]


def test_legendre_anchored_launch_fits_shared_memory():
    """The anchored kernel's launch at both pass shapes of the 29-shot
    SMARMN state (39,353 rows of 300 at A/Wside 8/32, a window of 72;
    8,700 rows of 1357 at 32/64, a window of 160) fits three blocks in an
    SM's shared memory, its u pitch an odd number of 16-byte words and its
    sample groups covering the anchors; at the longest rows and the widest
    window it takes it fits a block's 232,448 bytes; A off a positive
    multiple of 8 or past a tile, Wside < 0, short or over-long rows, grids
    past 2^31 blocks and wider windows raise."""
    a = cb.legendre_anchored_launch(39353, 300, 8, 32)
    assert (a.threads, a.tile, a.tiles, a.window, a.anchors, a.samples,
            a.passes) == (256, 304, 1, 72, 39, 5, 1)
    assert (a.band_blocks, a.cert_blocks, a.grid) == (1230, 1230, 2460)
    assert (a.band_smem, a.cert_smem, a.smem) == (58_304, 40_256, 58_304)
    b = cb.legendre_anchored_launch(8700, 1357, 32, 64)
    assert (b.tile, b.tiles, b.window, b.anchors, b.samples, b.passes) == \
        (352, 4, 160, 44, 6, 1)
    assert (b.band_blocks, b.cert_blocks, b.grid) == (1088, 272, 1360)
    assert (b.band_smem, b.cert_smem, b.smem) == (73_088, 46_592, 73_088)
    for x, n, A in ((a, 300, 8), (b, 1357, 32)):
        assert x.rows_a_block == 32 and 3 * x.smem <= 232_448
        assert x.tile % A == 0 and (x.tiles - 1) * x.tile < n <= \
            x.tiles * x.tile
        assert (x.tile + x.window - A + 4) % 8 == 4
        assert x.passes * 8 * x.samples >= x.anchors == -(-n // A) + 1
    big = cb.legendre_anchored_launch(1, 2 ** 30, 32, 64)
    assert big.tile == 384 and big.tiles * 384 >= 2 ** 30
    assert big.samples == 8 and big.passes * 64 >= big.anchors
    assert big.smem <= 232_448
    # the widest window at A = 8: Wside 648, W = 1304
    assert cb.legendre_anchored_launch(1, 3840, 8, 648).smem == 231_488
    for args in ((1, 3840, 8, 649), (1, 300, 12, 32), (1, 300, 4, 32),
                 (1, 3000, 392, 8), (1, 300, 8, -1), (0, 300, 8, 32),
                 (4, 1, 8, 32), (1, 2 ** 30 + 1, 32, 64),
                 (2 ** 31, 10 ** 4, 8, 32)):
        with pytest.raises(ValueError):
            cb.legendre_anchored_launch(*args)


def test_legendre_anchored_twin_is_the_torch_evaluation():
    """On the CPU the wrapper runs its twin, the torch evaluation
    ``_legendre_last_anchored``, bitwise, and counts a twin call; it
    raises, counting nothing, for another device, another type, a strided
    view, slopes of another length or on another device, and A off a
    multiple of 8."""
    s, u = _legendre_input(700, 0)
    u2 = torch.tensor(u).reshape(-1, 700)
    st = torch.tensor(s)
    cb.reset_counters()
    out, ok = cb.legendre_anchored(u2, st, 32, 64)
    assert cb.TWIN_CALLS["legendre_anchored"] == 1
    assert sum(cb.LAUNCHES.values()) == 0
    want, ok_want = T._legendre_last_anchored(u2, st, 32, 64)
    assert ok.dtype == torch.bool and bool(ok) == bool(ok_want)
    assert torch.equal(out, want)
    cb.reset_counters()
    meta = torch.zeros((4, 700), device="meta")
    for args, err in (((meta, st), ValueError),
                      ((u2.double(), st.double()), TypeError),
                      ((u2[:, ::2], st[::2]), ValueError),
                      ((u2, st[:699]), ValueError),
                      ((u2, st.to("meta")), ValueError)):
        with pytest.raises(err):
            cb.legendre_anchored(*args, 32, 64)
    with pytest.raises(ValueError):
        cb.legendre_anchored(u2, st, 12, 64)
    assert sum(cb.TWIN_CALLS.values()) == sum(cb.LAUNCHES.values()) == 0


def test_anchor_fast_takes_the_torch_evaluation_off_the_card(monkeypatch):
    """Off the card, and for float64, ``_legendre_last_anchor_fast`` takes
    the torch evaluation (the kernel's twin) and reads its flag once: no
    launch, no wrapper call, ``COUNTS["legendre_kernel"]`` stays 0; and
    ``reset_counts`` clears that counter."""
    calls = []
    evaluate = T._legendre_last_anchored

    def spy(*a, **k):
        calls.append(a[2:4])
        return evaluate(*a, **k)

    monkeypatch.setattr(T, "_legendre_last_anchored", spy)
    s, u = _legendre_input(700, 0)
    cb.reset_counters()
    T.reset_counts()
    for dtype in (torch.float32, torch.float64):
        out = T._legendre_last_anchor_fast(torch.tensor(u, dtype=dtype),
                                           torch.tensor(s, dtype=dtype))
        assert out.dtype == dtype and out.shape == u.shape
    assert calls == [(32, 64), (32, 64)]
    assert T.COUNTS["legendre_kernel"] == 0
    assert T.COUNTS["legendre_reads"] == 2
    assert sum(cb.LAUNCHES.values()) == sum(cb.TWIN_CALLS.values()) == 0
    T.COUNTS["legendre_kernel"] = 3
    T.reset_counts()
    assert T.COUNTS["legendre_kernel"] == 0


@pytest.mark.parametrize("n,shift", [(300, 0), (640, 0), (640, 300),
                                     (50, 0)])
def test_legendre_last_fast_matches_jax(n, shift, monkeypatch):
    """The banded route: the certificate read once, the full transform
    where it fails, and below 2W+1+n//K samples the full transform
    without a read, as the JAX route (its kernel in interpret mode)."""
    monkeypatch.setenv("DEVITO_FWI_TPU_PALLAS_INTERPRET", "1")
    s, u = _legendre_input(n, shift)
    want = JB._legendre_last_fast(jnp.asarray(u), jnp.asarray(s),
                                  32_000_000)
    T.reset_counts()
    got = T._legendre_last_fast(torch.tensor(u), torch.tensor(s),
                                32_000_000)
    _close(got, want, 1e-6)
    reads = 0 if n == 50 else 1
    assert T.COUNTS["legendre_reads"] == reads
    assert T.COUNTS["legendre_fallbacks"] == (1 if shift else 0)
    # slopes off the kernel's grid fail the endpoint check
    T.reset_counts()
    s2 = torch.tensor(s) * 1.01
    _close(T._legendre_last_fast(torch.tensor(u), s2),
           T._legendre_last(torch.tensor(u), s2), 0)
    assert T.COUNTS["legendre_fallbacks"] == reads


def test_bfm_batch_banded_equals_anchor():
    """The banded route (its twin here) gives the anchored route's loss and
    gradient bitwise: both are exact where their certificates hold."""
    mu, nu = _blobs(np.float32)
    out = {}
    for leg in ("anchor", "banded"):
        T.reset_counts()
        cb.reset_counters()
        out[leg] = T.bfm_batch(torch.tensor(mu), torch.tensor(nu),
                               num_steps=6, step_scale=1.0, legendre=leg)
        assert T.COUNTS["legendre_fallbacks"] == 0
    assert T.COUNTS["legendre_reads"] == \
        cb.TWIN_CALLS["legendre_banded"] > 0
    assert torch.equal(out["banded"][0], out["anchor"][0])
    assert torch.equal(out["banded"][1], out["anchor"][1])


# ---------------------------------------------------------------------------
# map and subsamples
# ---------------------------------------------------------------------------

def _potential(Bb=3, n1=24, n2=90, seed=3):
    from scipy.ndimage import gaussian_filter
    rng = np.random.default_rng(seed)
    mu = rng.uniform(0.2, 2.0, size=(Bb, n2, n1)).astype(np.float32)
    pot = rng.normal(size=(Bb, n2, n1)) * 1e-3
    pot = np.stack([gaussian_filter(p, 4) for p in pot])
    xs = (np.arange(n1) + 0.5) / n1
    ys = (np.arange(n2) + 0.5) / n2
    quad = 0.5 * (xs[None, :] ** 2 + ys[:, None] ** 2)
    return mu, (pot + quad).astype(np.float32)


def _jax_subs(mu, pot, shift_rows, nsub=2, level=None):
    Bb, n2, n1 = mu.shape
    xMap, yMap = jax.vmap(lambda p: JB._pushforward_map(p, n1, n2))(
        jnp.asarray(pot))
    lm = None if level is None else jnp.asarray(level)
    out = jax.vmap(lambda m, xm, ym, *h: JB._pushforward_subsamples(
        m, xm, ym, n1, n2, nsub, level_mask=h[0] if h else None))(
        jnp.asarray(mu), xMap, yMap + shift_rows / n2,
        *([] if lm is None else [lm]))
    return (xMap, yMap), out


def _subs(shift_rows=0, nsub=2, **kw):
    """The same subsamples on both sides (the JAX package's fixture)."""
    mu, pot = _potential(**kw)
    _, out = _jax_subs(mu, pot, shift_rows, nsub)
    jsubs = tuple(jnp.asarray(a, jnp.float32) if a.dtype.kind == "f" else a
                  for a in out[:7])
    tsubs = tuple(torch.tensor(np.asarray(a)) for a in jsubs)
    return jsubs, tsubs, mu.shape[2], mu.shape[1]


@pytest.mark.parametrize("shift", [0, 40])
def test_map_and_subsamples_match_jax(shift):
    mu, pot = _potential()
    Bb, n2, n1 = mu.shape
    (xj, yj), out_j = _jax_subs(mu, pot, shift)
    xt, yt = T._pushforward_map(torch.tensor(pot), n1, n2)
    _close(xt, xj, 1e-6)
    _close(yt, yj, 1e-6)
    out_t = T._pushforward_subsamples(torch.tensor(mu), xt, yt + shift / n2,
                                      n1, n2, 2)
    for a, b in zip(out_t, out_j):
        if b.dtype.kind in "ib":
            assert np.array_equal(_np(a), np.asarray(b))
        else:
            _close(a, b, 1e-6)
    hi_j = jax.vmap(lambda x, y: JB._adaptive_hi_mask(x, y, n1, n2))(xj, yj)
    assert np.array_equal(_np(T._adaptive_hi_mask(xt, yt, n1, n2)),
                          np.asarray(hi_j))


# ---------------------------------------------------------------------------
# the slab kernel's twins and the pushforward tiers
# ---------------------------------------------------------------------------

def _planes(blocked, Q, B=2, nblk=3, R=16, lanes=128, G=24, dxmax=7):
    """Seeded planes over every offset the kernel takes: rel in [-1, G-1],
    dxr in [0, 2*dxmax+1], weights in [0, 1], a fifth of the cells
    empty."""
    rng = np.random.default_rng(2)
    shape = (B, nblk, Q, R, lanes) if blocked else (B, Q, nblk * R, lanes)
    mass = rng.uniform(0, 1, shape) * (rng.uniform(0, 1, shape) > 0.2)
    ints = [torch.tensor(rng.integers(lo, hi, shape), dtype=torch.int32)
            for lo, hi in ((-1, G), (0, 2 * dxmax + 2))]
    return ints + [torch.tensor(a, dtype=torch.float32) for a in (
        mass * rng.uniform(0, 1, shape), mass, rng.uniform(0, 1, shape))]


def _direct_slabs(planes, blocked, G=24, dxmax=7):
    """The slabs as a plain loop over the cells' four contributions."""
    rel, dxr, wy0, mass, wx0 = [_np(p).astype(np.float64) for p in planes]
    if not blocked:
        B, Q, n2p, L = rel.shape
        rel, dxr, wy0, mass, wx0 = [
            a.reshape(B, Q, n2p // 16, 16, L).swapaxes(1, 2)
            for a in (rel, dxr, wy0, mass, wx0)]
    B, nblk, Q, R, L = rel.shape
    out = np.zeros((B, nblk, R + G, L))
    for idx in np.ndindex(B, nblk, Q, R, L):
        b, j, _, i, l = idx
        r, d = int(rel[idx]), int(dxr[idx])
        for g, wy in ((r, wy0[idx]), (r + 1, mass[idx] - wy0[idx])):
            for e, wx in ((d, wx0[idx]), (d + 1, 1 - wx0[idx])):
                if 0 <= g < G and 0 <= e < 2 * dxmax + 2 and l + e < L:
                    out[b, j, i + g, l + e] += wx * wy
    return out


@pytest.mark.parametrize("prep", ["nat", "blocked"])
def test_slab_twin_matches_pallas_interpret(prep):
    """The twin on seeded planes against the Pallas kernel (Q = 1: its
    interpret-mode build grows with the unrolled G*DX*Q sums) and, at
    Q = 4, against a direct loop over the contributions (f64, 1e-6)."""
    blocked = prep == "blocked"
    twin = cb.pushforward_slabs if blocked else cb.pushforward_slabs_nat
    kernel = PB.pushforward_slabs if blocked else PB.pushforward_slabs_nat
    planes = _planes(blocked, Q=1)
    cb.reset_counters()
    got = twin(*planes, G=24, dxmax=7, R=16)
    assert sum(cb.TWIN_CALLS.values()) == 1 and sum(cb.LAUNCHES.values()) == 0
    _close(got, kernel(*[jnp.asarray(_np(p)) for p in planes], G=24,
                       dxmax=7, R=16, interpret=True), 1e-6)
    planes = _planes(blocked, Q=4, B=1, nblk=2)
    _close(twin(*planes, G=24, dxmax=7, R=16),
           _direct_slabs(planes, blocked), 1e-6)


def _pile_planes(blocked, Q, B=1, nblk=2, R=16, lanes=128, G=24, dxmax=7):
    """Planes whose cells pile up: every cell of block row i has
    rel = G - 2 - i, so that the whole block lands on slab rows G - 2 and
    G - 1, and lanes 26..40 all have dxr = 40 - l (lanes 40 and 41): the
    longest lists, 16 rows x 15 lanes x Q cells an output."""
    planes = _planes(blocked, Q, B=B, nblk=nblk, R=R, lanes=lanes, G=G,
                     dxmax=dxmax)
    shape = tuple(planes[0].shape)
    l = np.arange(lanes)
    dxr = np.broadcast_to(np.clip(40 - l, 0, 2 * dxmax), shape)
    i = (np.arange(R).reshape(1, 1, 1, R, 1) if blocked
         else (np.arange(shape[2]) % R).reshape(1, 1, -1, 1))
    rel = np.broadcast_to(G - 2 - i, shape)
    return [torch.tensor(rel, dtype=torch.int32),
            torch.tensor(dxr, dtype=torch.int32)] + planes[2:]


def _list_order_slabs(planes, blocked, G=24, dxmax=7, R=16):
    """A numpy replay of csrc/bfm_push.cu's order, in float32: every
    cell's non-zero products wx * wy as entries (output, key (g, e, q)),
    sorted by key within each output, then summed as the kernel sums them:
    v over q, acc over e, slab over g."""
    rel, dxr, wy0, mass, wx0 = [_np(p) for p in planes]
    if not blocked:
        B, Q, n2p, L = rel.shape
        rel, dxr, wy0, mass, wx0 = [
            a.reshape(B, Q, n2p // R, R, L).swapaxes(1, 2)
            for a in (rel, dxr, wy0, mass, wx0)]
    B, nblk, Q, R, L = rel.shape
    DX, S = 2 * dxmax + 2, R + G
    b, j, q, i, l = np.indices(rel.shape)
    outs, keys, vals = [], [], []
    for gs, wy in ((0, wy0), (1, mass - wy0)):
        for es, wx in ((0, wx0), (1, np.float32(1) - wx0)):
            g, e, v = rel + gs, dxr + es, wx * wy
            ok = (g >= 0) & (g < G) & (e >= 0) & (e < DX) & (l + e < L) \
                & (v != 0)
            outs.append((((b * nblk + j) * S + i + g) * L + l + e)[ok])
            keys.append(((g * DX + e) * Q + q)[ok])
            vals.append(v[ok])
    out, key, val = (np.concatenate(a) for a in (outs, keys, vals))
    order = np.lexsort((key, out))
    out, key, val = out[order], key[order], val[order]
    uniq, first, inv = np.unique(out, return_index=True, return_inverse=True)
    rank = np.arange(out.size) - first[inv]
    K = np.full((uniq.size, rank.max() + 1), -1)
    V = np.zeros(K.shape, np.float32)
    K[inv, rank], V[inv, rank] = key, val
    zero = np.float32(0)
    s, acc, v = (np.zeros(uniq.size, np.float32) for _ in range(3))
    cg = ce = np.full(uniq.size, -1)
    for c in range(K.shape[1]):
        k = K[:, c]
        has = k >= 0
        g, e = k // (DX * Q), (k // Q) % DX
        newg = has & (g != cg)
        newe = has & ~newg & (e != ce)
        flush = newg & (cg >= 0)
        acc = np.where(flush, acc + v, acc)
        s = np.where(flush, s + acc, s)
        acc = np.where(newg, zero, acc)
        v = np.where(newg, zero, v)
        acc = np.where(newe, acc + v, acc)
        v = np.where(newe, zero, v)
        cg, ce = np.where(newg, g, cg), np.where(newg | newe, e, ce)
        v = np.where(has, v + V[:, c], v)
    acc = acc + v
    s = np.where(cg >= 0, s + acc, s)
    slabs = np.zeros(B * nblk * S * L, np.float32)
    slabs[uniq] = s
    return slabs.reshape(B, nblk, S, L)


@pytest.mark.parametrize("prep", ["nat", "blocked"])
@pytest.mark.parametrize("case", ["Q4", "Q8", "pile-up"])
def test_slab_list_order_equals_twin_bitwise(prep, case):
    """The redesigned card kernel's order (the entries of each output sorted
    by (g, e, q), zero products skipped, nested sums) gives the plain twin's
    slabs bit for bit, on seeded planes over every offset and on a pile-up
    of 240 Q cells onto one output."""
    blocked = prep == "blocked"
    if case == "pile-up":
        planes = _pile_planes(blocked, Q=4)
    else:
        planes = _planes(blocked, Q=int(case[1:]), B=2, nblk=2)
    twin = cb.pushforward_slabs_plain if blocked \
        else cb.pushforward_slabs_nat_plain
    want = twin(*planes, G=24, dxmax=7, R=16).numpy()
    got = _list_order_slabs(planes, blocked)
    assert got.shape == want.shape
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    if case == "pile-up":
        assert np.count_nonzero(want[:, :, 22:24, 40:42]) == 8


def test_push_launch_fits_shared_memory():
    """The slab kernel's launch at the main path's shapes (29 SMARMN shots,
    Q = 4, R = 16, G = 24, DX = 16, 384 lanes) and at its limits fits a
    block's 232,448 bytes; beyond them the helper refuses."""
    main = cb.push_launch(29, 85, 4, 16, 24, 16, 384)
    assert main.smem == 101_440 and main.grid == (2465, 12)
    assert main.threads == 512 and 2 * main.smem <= 232_448
    assert cb.push_launch(29, 85, 8, 16, 24, 16, 384).smem == 197_696
    assert cb.push_launch(1, 1, 8, 18, 24, 16, 128).smem <= 232_448
    for args in ((1, 1, 8, 19, 24, 16, 128), (1, 1, 9, 16, 24, 16, 128),
                 (1, 1, 0, 16, 24, 16, 128), (1, 1, 4, 16, 0, 16, 128)):
        with pytest.raises(ValueError):
            cb.push_launch(*args)


@pytest.mark.parametrize("prep", ["nat", "blocked"])
@pytest.mark.parametrize("shift", [0, 40])
def test_slab_push_matches_jax(shift, prep, monkeypatch):
    """The slab pushforward (prep, twin, overlap-add) against the JAX
    ``_pallas_push`` in interpret mode, on nsub = 1 subsamples (Q = 1, for
    the interpreter's build time)."""
    monkeypatch.setenv("DEVITO_FWI_TPU_PALLAS_INTERPRET", "1")
    jsubs, tsubs, n1, n2 = _subs(shift, nsub=1)
    want = JB._pallas_push(jsubs, n1, n2, G=24, dxmax=7, margin=128, R=16,
                           fold="loop", prep_mode=prep)
    got = T._slab_push(tsubs, n1, n2, G=24, dxmax=7, margin=128, R=16,
                       prep=prep)
    _close(got, want, 1e-6)
    _close(got, JB._scatter_pushforward_batch(jsubs, n1, n2), 1e-5)


@pytest.mark.parametrize("shift", [0, 40])
def test_banded_tier_and_scatter_match_jax(shift):
    jsubs, tsubs, n1, n2 = _subs(shift)
    want = JB._local_banded_pushforward_batch(jsubs, n1, n2, G_local=32,
                                              dxmax=7, margin=128)
    got = T._local_banded_pushforward_batch(tsubs, n1, n2, G_local=32,
                                            dxmax=7, margin=128)
    _close(got, want, 1e-5)
    # the scatters add the same terms in another order; at shift 40 up to
    # ~100 of them pile onto the clamped last row
    _close(T._scatter_pushforward_batch(tsubs, n1, n2),
           JB._scatter_pushforward_batch(jsubs, n1, n2), 1e-5)


def _tier_states():
    """(name, JAX subs, torch subs, n1, n2): a state for each tier. The
    wide one stretches dy over 28 rows within a block (past the slab's
    G = 24, inside the banded product's 32); the far one moves a cell's dx
    past dxmax."""
    states = []
    for name in ("slab", "wide", "far"):
        jsubs, tsubs, n1, n2 = _subs(40)
        xI, xO, xf, yI, yO, yf, mass = [np.asarray(a).copy() for a in jsubs]
        if name == "wide":
            yI[:, :, 5, :] = np.minimum(yI[:, :, 5, :] + 27, n2 - 2)
            yO[:, :, 5, :] = yI[:, :, 5, :] + 1
        if name == "far":
            xI[0, 0, 10, 3] = 20
            xO[0, 0, 10, 3] = 21
        arrs = (xI, xO, xf, yI, yO, yf, mass)
        states.append((name, tuple(jnp.asarray(a) for a in arrs),
                       tuple(torch.tensor(a) for a in arrs), n1, n2))
    return states


@pytest.mark.parametrize("state", _tier_states(), ids=lambda s: s[0])
def test_tier_choice_matches_jax(state):
    name, jsubs, tsubs, n1, n2 = state
    dx_j = bool(JB._dx_inband_predicate(jsubs, 7))
    slab_j = dx_j and bool(JB._local_band_ok(jsubs, G_local=24, margin=128,
                                             row_block=16))
    band_j = dx_j and bool(JB._local_band_ok(jsubs, G_local=32, margin=128))
    assert bool(T._dx_inband_predicate(tsubs, 7)) == dx_j
    assert bool(T._local_band_ok(tsubs, G_local=24, margin=128,
                                 row_block=16)) == bool(JB._local_band_ok(
                                     jsubs, G_local=24, margin=128,
                                     row_block=16))
    want = "push_slab" if slab_j else "push_banded" if band_j \
        else "push_scatter"
    assert want == {"slab": "push_slab", "wide": "push_banded",
                    "far": "push_scatter"}[name]
    T.reset_counts()
    rho = T._dispatch_push(tsubs, n1, n2, 127)
    assert T.COUNTS[want] == 1 and T.COUNTS["predicate_reads"] >= 1
    _close(rho, JB._scatter_pushforward_batch(jsubs, n1, n2), 1e-5)


@pytest.mark.parametrize("dtype,tiers,tol", [
    (np.float64, dict(push_banded=2), 1e-12),
    (np.float32, dict(push_slab=1, push_banded=1), 1e-5)])
def test_adaptive_pushforward_matches_jax(dtype, tiers, tol):
    """nsub = 0: the low-stretch cells 2x2, the high-stretch ones (here a
    quarter) 4x4 in a second pass of Q = 16 subsamples, which the slab
    tier does not take (Q <= 8). The JAX side runs its XLA tiers; at
    float32 the port's first pass takes the slab tier (the same sums in
    another order)."""
    from scipy.ndimage import gaussian_filter
    mu, pot = _potential()
    Bb, n2, n1 = mu.shape
    rng = np.random.default_rng(5)
    pot = pot + 2e-3 * np.stack([gaussian_filter(p, 2) for p in
                                 rng.normal(size=pot.shape)])
    mu, pot = mu.astype(dtype), pot.astype(dtype)
    xj, yj = jax.vmap(lambda p: JB._pushforward_map(p, n1, n2))(
        jnp.asarray(pot))
    hi = np.asarray(jax.vmap(lambda x, y: JB._adaptive_hi_mask(
        x, y, n1, n2))(xj, yj))
    assert 0 < hi.sum() < hi.size
    want = JB._sampling_pushforward_batch(jnp.asarray(mu), xj, yj, n1, n2,
                                          0, 127, push_backend="xla")
    xt, yt = T._pushforward_map(torch.tensor(pot), n1, n2)
    T.reset_counts()
    got = T._sampling_pushforward_batch(torch.tensor(mu), xt, yt, n1, n2, 0,
                                        127)
    assert {k: v for k, v in T.COUNTS.items() if k.startswith("push")
            and v} == tiers
    _close(got, want, tol)


def test_local_band_ok_rejects_active_dy_at_margin():
    """A block whose only active cell has dy == margin (the inactive-cell
    fill value) must not read as empty."""
    Bb, Q, n2s, n1s = 1, 1, 140, 8
    margin = 128
    z = torch.zeros((Bb, Q, n2s, n1s), dtype=torch.float32)
    zi = torch.zeros((Bb, Q, n2s, n1s), dtype=torch.int32)
    mass = z.clone()
    mass[0, 0, 0, 0] = 1.0
    yI = zi.clone()
    yI[0, 0, 0, 0] = margin
    c = torch.arange(n1s, dtype=torch.int32).expand(Bb, Q, n2s, n1s)
    subs = (c, c, z, yI, yI + 1, z, mass)
    assert not bool(T._local_band_ok(subs, G_local=32, margin=margin,
                                     row_block=32))
    subs0 = (c, c, z, yI, yI + 1, z, z)
    assert bool(T._local_band_ok(subs0, G_local=32, margin=margin,
                                 row_block=32))


def test_slab_push_lane_multiple_of_128():
    """With n1 % 128 == 0 the slab lanes still cover the +dxmax-shifted
    targets: the right-edge mass stays."""
    rng = np.random.default_rng(7)
    Bb, Q, n2s, n1s = 2, 1, 40, 128
    mass = torch.tensor(rng.uniform(0.1, 1.0, (Bb, Q, n2s, n1s)),
                        dtype=torch.float32)
    c = torch.arange(n1s, dtype=torch.int32).expand(Bb, Q, n2s, n1s)
    r = torch.arange(n2s, dtype=torch.int32)[:, None].expand(Bb, Q, n2s, n1s)
    xI = torch.clamp(c + 3, max=n1s - 1)
    yI = torch.clamp(r + 2, max=n2s - 1)
    xf = torch.full(mass.shape, 0.3)
    yf = torch.full(mass.shape, 0.4)
    subs = (xI, torch.clamp(xI + 1, max=n1s - 1), xf, yI,
            torch.clamp(yI + 1, max=n2s - 1), yf, mass)
    assert bool(T._dx_inband_predicate(subs, 7))
    assert bool(T._local_band_ok(subs, G_local=24, margin=128, row_block=16))
    rho = T._slab_push(subs, n1s, n2s, G=24, dxmax=7, margin=128, R=16)
    assert rho.shape == (Bb, n2s, n1s)
    _close(rho, T._scatter_pushforward_batch(subs, n1s, n2s), 1e-6)


# ---------------------------------------------------------------------------
# the solver
# ---------------------------------------------------------------------------

def _blobs(dtype):
    n1, n2 = 28, 100
    t = np.arange(n2)[:, None]
    x = np.arange(n1)[None, :]

    def blob(t0, x0):
        return np.exp(-((t - t0) ** 2 / 80.0 + (x - x0) ** 2 / 40.0))

    mu = np.stack([blob(30, 10) + blob(70, 20),
                   blob(40, 14) + blob(85, 8)]).astype(dtype) + 1e-3
    nu = np.stack([blob(45, 11) + blob(80, 19),
                   blob(38, 15) + blob(88, 9)]).astype(dtype) + 1e-3
    return mu, nu


def test_bfm_batch_matches_jax_f32():
    mu, nu = _blobs(np.float32)
    lj, gj = JB.bfm_jax_batch(jnp.asarray(mu), jnp.asarray(nu), num_steps=6,
                              step_scale=1.0, dmax=127, push_backend="xla",
                              legendre_banded="anchor")
    T.reset_counts()
    lt, gt = T.bfm_batch(torch.tensor(mu), torch.tensor(nu), num_steps=6,
                         step_scale=1.0, dmax=127)
    assert T.COUNTS["push_slab"] == 12 and T.COUNTS["legendre_fallbacks"] == 0
    assert np.allclose(_np(lt), np.asarray(lj), rtol=1e-4, atol=1e-8)
    _close(gt, gj, 1e-4)


def test_bfm_batch_scatter_tier_matches_jax_f64():
    mu, nu = _blobs(np.float64)
    lj, gj = JB.bfm_jax_batch(jnp.asarray(mu), jnp.asarray(nu), num_steps=6,
                              step_scale=1.0, dmax=0, push_backend="xla",
                              legendre_banded="full")
    T.reset_counts()
    lt, gt = T.bfm_batch(torch.tensor(mu), torch.tensor(nu), num_steps=6,
                         step_scale=1.0, dmax=0, push="xla",
                         legendre="full")
    assert T.COUNTS["push_scatter"] == 12
    _close(lt, lj, 1e-10)
    _close(gt, gj, 1e-10)


def test_dead_shot_gives_zero():
    mu, nu = _blobs(np.float32)
    mu[1] = nu[1] = 0.0
    loss, grad = T.bfm_batch(torch.tensor(mu), torch.tensor(nu), num_steps=2)
    assert np.isfinite(_np(loss)).all() and float(loss[1]) == 0.0
    assert not torch.any(grad[1])


@pytest.mark.parametrize("kw", [dict(legendre="banded"), dict(push="vec")])
def test_unported_backends_raise(kw):
    """The vectorized fold stays unported; the banded Legendre kernel, which
    raised until it was ported, resolves."""
    if kw.get("legendre") == "banded":
        assert T.resolve_backends(**kw) == ("pallas", "nat", "banded")
        return
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        T.resolve_backends(**kw)
