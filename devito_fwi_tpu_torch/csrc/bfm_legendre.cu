// Legendre transforms with their certificates, for Hopper (sm_90a), plain C
// interface for ctypes: the banded transform and the anchored one.
//
//   bfm_legendre_banded replaces legendre_banded
//       (devito_fwi_tpu/ops/pallas_bfm.py:173, pl.pallas_call :215,
//       _legendre_kernel :80).
//   bfm_legendre_anchored replaces no Pallas kernel. Its JAX counterpart is
//       the XLA route _legendre_last_anchored
//       (devito_fwi_tpu/misfit/bfm.py:109), the BFM's default Legendre
//       transform; in plain torch it takes a few hundred launches a pass
//       and writes its candidates to device memory (about 7.7 GB a pass at
//       n = 1357), so this kernel was added to run a pass as one launch.
//
// The banded transform, for a (rows, n) float32 u and the BFM grid
// coordinates s_j = (j + 0.5)/n (a host table, built in float32 as the
// Pallas wrapper builds it, so that the kernel and the plain version read
// the same slopes), with big = FLT_MAX/8:
//
//   out[r, i] = max over the offsets d = -W .. ND-1-W of
//               s_i * s_{i+d} - u[r, i+d],
//
// ND = 8*ceil((2W+1)/8) (the Pallas kernel's rolls walk the offsets in
// chunks of 8, so it evaluates ND >= 2W+1 of them), a column outside [0, n)
// giving s_i*0 - big = -big, the running max starting at -big;
//
//   ok[r] = 1 iff the row passes the certificate: at the samples
//   i_m = min(m*K, n-1), m = 0 .. ceil((n-1)/K), the first and the last
//   argmax over the whole padded row (npad = n rounded up to 128 lanes, the
//   pad lanes holding -big) of v_j = s_{i_m} * s_j - u[r, j], a lane a hit
//   when v_j >= max v, must satisfy first(i_{m-1}) >= i_m - W and
//   last(i_m) <= i_{m-1} + W for every m >= 1. By total monotonicity every
//   argmax then lies in the band, and out is the full transform.
//
// The anchored transform, for a (rows, n) float32 u, the caller's float32
// slopes s (n,), blocks of A outputs (A a multiple of 8) and a window of
// W = A*ceil((2*Wside + A)/A) columns a block:
//
//   out[r, i] = max over w = 0 .. W-1 of s_i * s_p - u[r, p],
//               p = k*A + w - Wside, k = i / A (the block of output i),
//
// a column p outside [0, n) giving s_i*0 - big, the max starting at -inf
// (an empty max: the value is the window's largest);
//
//   ok = 1 iff s is sorted (s_{j+1} >= s_j) and every row passes: at the
//   anchors i_m = min(m*A, n-1), m = 0 .. nA = ceil(n/A), the first and the
//   last argmax over the row's n lanes (no pad lanes) of
//   v_j = s_{i_m} * s_j - u[r, j] satisfy first(i_m) >= m*A - Wside for
//   m < nA and last(i_m) <= (m-1)*A + W - Wside - 1 for m >= 1: every
//   output of block k then has its argmax inside the block's window.
//
// Numbers, both: -fmad=false keeps the product and the subtraction two
// roundings, as in the plain versions. Every max propagates NaN as
// jnp.maximum, torch.maximum and amax do (max.NaN; fmaxf would drop it); a
// max is exact, so its order does not matter. A sample whose v holds a NaN
// has no hit (v >= NaN is false): its first is n and its last -1, and it
// passes.
//
// What bounds them on the card: per 2-D transform of the 29-shot Marmousi W2
// state, (39353 rows of 300) and (8700 rows of 1357), the banded kernel's
// 1.9e9 taps and 1.5e9 certificate lanes, and the anchored kernel's 2.8e9
// taps (W 72 and 160 a block of A 8 and 32) and 9.8e8 anchor lanes (39 and
// 44 anchors a row): a product, a difference and a max each, some 1e10
// float operations (0.168 ms at 67 TFLOP/s for the anchored), bound by
// operations, not by the 0.1-0.2 GB of input and output (0.056 ms at 3.35
// TB/s). The max runs at half the rate of the product and the difference,
// so a warp issues three instructions an evaluation: the loads and the
// bookkeeping around them are what a design can cut. The first banded
// design (one block of 256 threads a row) ran 14-15x its bound: at n = 300
// its second round of taps kept 44 of 256 threads busy, each tap cost two
// shared loads for three operations, the products s_i s_{i+d}, the same
// for every row, were formed again for each, and thread 0 alone checked the
// samples.
//
// Design: one launch of many small blocks of two kinds, each block 32
// rows, one a lane, over column tiles of T lanes (T <= 384; the whole row
// at n = 300) loaded into shared memory at a row pitch that puts the 32
// lanes of a warp on distinct banks; the slopes, the same for every row,
// are one shared table read by broadcast.
//
// A banded block takes a (32 rows, tile): the tile with the band's halo at
// an odd pitch; a lane takes 8 consecutive outputs of its row, the u and
// slope windows in registers, one shared load of each per tap for 8
// outputs.
//
// An anchored block takes a (32 rows, tile of T outputs, T a multiple of
// A): the tile's windows, T + W - A columns, at a pitch of an odd number of
// 16-byte words, so that a quarter warp's 16-byte loads of 8 rows fall on
// distinct banks. A lane takes 8 consecutive outputs of its row, which lie
// in one block and so share its window: a step of 4 taps is one 16-byte
// load of u and one broadcast of 4 slopes for 32 evaluations, so the inner
// loop is the product, the difference and the max and nothing else.
//
// Both kinds stage a lane's outputs through a per-warp tile so that stores
// are row runs.
//
// A certificate block takes a (32 rows, group of 8 S samples), the same
// code for both transforms: a lane takes S samples of its row and walks the
// row's lanes once, tile by tile (pitch T + 1, odd), for all of them, one
// shared load a lane for S samples. It needs, per sample, only whether a
// hit lies left of a or right of c (banded: a = i_{m+1} - W, c = i_{m-1} +
// W; anchored: a = i_m - Wside, c = i_{m-1} + W - Wside - 1): the walk
// keeps, per sample, the maxima of [0, a), [a, c] and (c, n) - one running
// max and a switch at a and at c + 1, positions the same for all 32 lanes,
// so the inner loop is a product, a difference and a max. The banded
// transform's npad - n pad lanes are all -big: they are added to the
// regions they fall in once, not walked. A sample passes iff its max is
// NaN, or A is empty or max A < max, and C (pad lanes included) is empty or
// max C < max, which is first >= a and last <= c. A failing row marks its
// row in row_bad (banded) or clears the one flag (anchored, whose first
// certificate block also checks that s is sorted). The walk needs a < c + 1
// (banded: K <= W; anchored: always); the launch helpers (ops/cuda_bfm.py
// legendre_launch, legendre_anchored_launch) raise otherwise. Small blocks
// of both kinds in one grid, the longer kind first, keep the card's 132 SMs
// evenly busy where one block a row block (8,700 rows of 1357 make only
// 272) did not.
#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kRows = 32;               // rows a block, one a lane
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kV = 8;                   // consecutive outputs a lane
constexpr int kMaxTile = 384;           // lanes of a column tile
constexpr int kMaxS = 8;                // certificate samples a lane

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

struct Shape {
  // the certificate: samples i_m = min(m*K, n-1), m < nsamp, over npad
  // lanes; sample m's regions A = [0, a) and C = [c1, npad) with
  // a = i_{m+lnext} - lw and c1 = i_{m-1} + rw (c + 1)
  int n, K, nsamp, npad, lnext, lw, rw;
  int W, ND;            // banded: half band, offsets evaluated
  int A, Wside, Wwin;   // anchored: block, window's start before it, window
  int T, ntiles, passes;
  int nband, ncert;     // blocks of each kind: row blocks x tiles, x passes
  int cert_first;       // the kind with the longer blocks is numbered first
};

__device__ __forceinline__ int sample(const Shape& sh, int m) {
  return m * sh.K < sh.n - 1 ? m * sh.K : sh.n - 1;
}

// the regions of sample m: A = [0, a) and C = [c1, npad); a <= 0 leaves A
// empty (also for the last sample, which has no first check), and
// c1 = INT_MAX C (the first sample has no last check)
__device__ __forceinline__ int left_limit(const Shape& sh, int m) {
  return m + 1 < sh.nsamp ? sample(sh, m + sh.lnext) - sh.lw : INT_MIN;
}

__device__ __forceinline__ int right_limit(const Shape& sh, int m) {
  return m >= 1 ? sample(sh, m - 1) + sh.rw : INT_MAX;
}

// Columns [c0, c0 + L) of the block's 32 rows into us (row pitch `pitch`;
// big outside the row and for rows past the last) and of the slopes into sp
// (0 outside the row).
__device__ __forceinline__ void load_cols(const float* __restrict__ u,
                                          const float* __restrict__ s,
                                          float* us, float* sp, int n,
                                          int rows, size_t row0, int c0,
                                          int L, int pitch) {
  const float big = FLT_MAX / 8.0f;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int r = warp; r < kRows; r += kWarps) {
    const size_t row = row0 + r;
    const bool live = row < (size_t)rows;
    const float* src = u + (live ? row : 0) * (size_t)n;
    float* dst = us + r * pitch;
    for (int k = lane; k < L; k += 32) {
      const int j = c0 + k;
      dst[k] = (live && j >= 0 && j < n) ? src[j] : big;
    }
  }
  for (int k = threadIdx.x; k < L; k += kThreads) {
    const int j = c0 + k;
    sp[k] = (j >= 0 && j < n) ? s[j] : 0.0f;
  }
}

// A warp's kV outputs i0 .. i0+kV-1 of its 32 rows (acc, a lane a row) to
// out through the warp's staging tile st (32 x (kV + 1)), as row runs.
__device__ __forceinline__ void store_group(const float (&acc)[kV],
                                            float* st,
                                            float* __restrict__ out,
                                            int rows, int n, size_t row0,
                                            int i0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int v = 0; v < kV; ++v) st[lane * (kV + 1) + v] = acc[v];
  __syncwarp();
#pragma unroll
  for (int q = 0; q < kV; ++q) {
    const int idx = q * 32 + lane;
    const int r = idx / kV;
    const int v = idx % kV;
    const size_t row = row0 + r;
    if (row < (size_t)rows && i0 + v < n)
      out[row * n + i0 + v] = st[r * (kV + 1) + v];
  }
  __syncwarp();
}

// The banded transform on one tile of 32 rows: the tile's columns and the
// halo, then groups of kV outputs, a warp's lanes the 32 rows.
__device__ __forceinline__ void band_block(const float* __restrict__ u,
                                           const float* __restrict__ s,
                                           float* __restrict__ out, int rows,
                                           const Shape& sh, float* smem,
                                           int row_block, int tile) {
  const int Lk = sh.T + sh.ND;
  const int Ls = Lk + 1;                  // odd pitch: a row a bank
  float* us = smem;                       // us[r*Ls + k]: u[row0+r, j0-W+k]
  float* sp = us + kRows * Ls;            // sp[k]: s[j0-W+k]
  float* stage = sp + Lk;                 // kWarps x kRows x (kV + 1)
  const float big = FLT_MAX / 8.0f;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t row0 = (size_t)row_block * kRows;
  const int j0 = tile * sh.T;
  load_cols(u, s, us, sp, sh.n, rows, row0, j0 - sh.W, Lk, Ls);
  __syncthreads();
  const float* ur = us + lane * Ls;
  float* st = stage + warp * kRows * (kV + 1);
  for (int g = warp; g < sh.T / kV; g += kWarps) {
    const int base = g * kV;
    const int i0 = j0 + base;
    if (i0 >= sh.n) break;
    float si[kV], acc[kV], uw[2 * kV], sw[2 * kV];
#pragma unroll
    for (int v = 0; v < kV; ++v) {
      si[v] = sp[base + v + sh.W];
      acc[v] = -big;
      uw[v] = ur[base + v];
      sw[v] = sp[base + v];
    }
    for (int c = 0; c < sh.ND; c += kV) {
#pragma unroll
      for (int e = 0; e < kV; ++e) {
        uw[kV + e] = ur[base + c + kV + e];
        sw[kV + e] = sp[base + c + kV + e];
      }
#pragma unroll
      for (int dd = 0; dd < kV; ++dd) {
#pragma unroll
        for (int v = 0; v < kV; ++v) {
          const float p = si[v] * sw[v + dd];
          acc[v] = max_nan(acc[v], p - uw[v + dd]);
        }
      }
#pragma unroll
      for (int e = 0; e < kV; ++e) {
        uw[e] = uw[kV + e];
        sw[e] = sw[kV + e];
      }
    }
    store_group(acc, st, out, rows, sh.n, row0, i0);
  }
}

// The anchored transform on one tile of 32 rows: the windows of the tile's
// blocks, T + W - A columns from j0 - Wside, then groups of kV outputs (one
// block's, sharing its window), a warp's lanes the 32 rows.
__device__ __forceinline__ void anchored_block(const float* __restrict__ u,
                                               const float* __restrict__ s,
                                               float* __restrict__ out,
                                               int rows, const Shape& sh,
                                               float* smem, int row_block,
                                               int tile) {
  const int L = sh.T + sh.Wwin - sh.A;    // a multiple of 8
  const int P = L + 4;                    // an odd number of 16-byte words
  float* us = smem;                       // us[r*P + k]: u[row0+r, j0-Wside+k]
  float* sp = us + kRows * P;             // sp[k]: s[j0-Wside+k]
  float* stage = sp + L;                  // kWarps x kRows x (kV + 1)
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t row0 = (size_t)row_block * kRows;
  const int j0 = tile * sh.T;
  load_cols(u, s, us, sp, sh.n, rows, row0, j0 - sh.Wside, L, P);
  __syncthreads();
  const float* ur = us + lane * P;
  float* st = stage + warp * kRows * (kV + 1);
  for (int g = warp; g < sh.T / kV; g += kWarps) {
    const int base = g * kV;
    const int i0 = j0 + base;
    if (i0 >= sh.n) break;
    const int kb = base - base % sh.A;    // the block's window: [kb, kb + W)
    float si[kV], acc[kV];
#pragma unroll
    for (int v = 0; v < kV; ++v) {
      si[v] = sp[base + v + sh.Wside];
      acc[v] = -INFINITY;
    }
#pragma unroll 2
    for (int w = 0; w < sh.Wwin; w += 4) {
      const float4 uq = *reinterpret_cast<const float4*>(ur + kb + w);
      const float4 sq = *reinterpret_cast<const float4*>(sp + kb + w);
#pragma unroll
      for (int v = 0; v < kV; ++v) {
        acc[v] = max_nan(acc[v], si[v] * sq.x - uq.x);
        acc[v] = max_nan(acc[v], si[v] * sq.y - uq.y);
        acc[v] = max_nan(acc[v], si[v] * sq.z - uq.z);
        acc[v] = max_nan(acc[v], si[v] * sq.w - uq.w);
      }
    }
    store_group(acc, st, out, rows, sh.n, row0, i0);
  }
}

// The certificate's walk over lanes [j0, j0 + T) of the lane's row (in us,
// pitch T + 1) for its S samples mb .. mb+S-1: run[q] is the max of the
// current region, which switches at a (to B) and at c1 (to C), positions
// the same for the warp.
template <int S>
__device__ __forceinline__ void walk_tile(const float* us, const float* sp,
                                          const Shape& sh, int mb, int j0,
                                          const float (&sm)[S],
                                          float (&run)[S], float (&mA)[S],
                                          float (&mB)[S]) {
  const int lane = threadIdx.x & 31;
  const float* ur = us + lane * (sh.T + 1);   // ur[j - j0]: u[row, j]
  const int je = j0 + sh.T < sh.n ? j0 + sh.T : sh.n;
  int j = j0;
  while (j < je) {
    int nb = je;
#pragma unroll
    for (int q = 0; q < S; ++q) {
      const int m = mb + q;
      int a = 0, c1 = INT_MAX;
      if (m < sh.nsamp) {
        const int al = left_limit(sh, m);
        a = al > 0 ? al : 0;
        c1 = right_limit(sh, m);
      }
      if (a == j) {
        mA[q] = run[q];
        run[q] = -INFINITY;
      }
      if (c1 == j) {
        mB[q] = run[q];
        run[q] = -INFINITY;
      }
      if (a > j && a < nb) nb = a;
      if (c1 > j && c1 < nb) nb = c1;
    }
#pragma unroll 4
    for (; j < nb; ++j) {
      const float uj = ur[j - j0];
      const float sj = sp[j - j0];
#pragma unroll
      for (int q = 0; q < S; ++q) run[q] = max_nan(run[q], sm[q] * sj - uj);
    }
  }
}

// Whether sample m of the lane's row passes, from its walk.
__device__ __forceinline__ bool sample_passes(const Shape& sh, int m,
                                              float run, float mA, float mB) {
  if (m >= sh.nsamp) return true;
  const float big = FLT_MAX / 8.0f;
  const int al = left_limit(sh, m);
  const int c1 = right_limit(sh, m);
  float mC;
  if (c1 < sh.n) {
    mC = run;                 // switched at c1: run holds [c1, n)
  } else {
    mB = run;                 // B reaches the row's end
    mC = -INFINITY;
  }
  if (sh.npad > sh.n) {       // the pad lanes [n, npad), all -big
    if (c1 <= sh.n) {
      mC = max_nan(mC, -big);
    } else {
      mB = max_nan(mB, -big);
      if (c1 < sh.npad) mC = max_nan(mC, -big);
    }
  }
  const float M = max_nan(max_nan(mA, mB), mC);
  if (M != M) return true;    // a NaN: no lane is a hit
  const bool first_ok = al <= 0 || mA < M;
  const bool last_ok = c1 >= sh.npad || mC < M;
  return first_ok && last_ok;
}

// The certificate of 32 rows for one group of kWarps x S samples: the
// row's tiles in turn (no halo), walked; a failing row is marked in row_bad
// (banded) or clears *ok (anchored: row_bad null).
template <int S>
__device__ __forceinline__ void certificate_block(
    const float* __restrict__ u, const float* __restrict__ s,
    int* __restrict__ row_bad, unsigned char* __restrict__ ok, int rows,
    const Shape& sh, float* smem, int row_block, int group) {
  float* us = smem;                       // us[r*(T+1) + k]: u[row0+r, j0+k]
  float* sp = us + kRows * (sh.T + 1);    // sp[k]: s[j0+k]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t row0 = (size_t)row_block * kRows;
  const int mb = (group * kWarps + warp) * S;
  float sm[S], run[S], mA[S], mB[S];
#pragma unroll
  for (int q = 0; q < S; ++q) {
    const int m = mb + q;
    sm[q] = m < sh.nsamp ? s[sample(sh, m)] : 0.0f;
    run[q] = -INFINITY;
    mA[q] = -INFINITY;
    mB[q] = -INFINITY;
  }
  for (int tile = 0; tile < sh.ntiles; ++tile) {
    const int j0 = tile * sh.T;
    if (tile) __syncthreads();
    load_cols(u, s, us, sp, sh.n, rows, row0, j0, sh.T, sh.T + 1);
    __syncthreads();
    walk_tile<S>(us, sp, sh, mb, j0, sm, run, mA, mB);
  }
  bool pass = true;
#pragma unroll
  for (int q = 0; q < S; ++q)
    pass = pass && sample_passes(sh, mb + q, run[q], mA[q], mB[q]);
  const size_t row = row0 + lane;
  if (!pass && row < (size_t)rows) {
    if (row_bad)
      row_bad[row] = 1;
    else
      *ok = 0;
  }
  if (!row_bad && row_block == 0 && group == 0) {
    // the anchored flag needs sorted slopes (monotone argmax)
    for (int j = 1 + threadIdx.x; j < sh.n; j += kThreads)
      if (!(s[j] >= s[j - 1])) *ok = 0;
  }
}

// Block blockIdx.x's kind and its number within the kind: the kind with
// the longer blocks takes the lower numbers, so that the short ones fill
// the card's tail.
__device__ __forceinline__ bool certificate_kind(const Shape& sh, int& id) {
  id = blockIdx.x;
  if (sh.cert_first) {
    if (id < sh.ncert) return true;
    id -= sh.ncert;
    return false;
  }
  if (id < sh.nband) return false;
  id -= sh.nband;
  return true;
}

// One launch, two kinds of block: nband blocks a (row block, tile) of the
// band and ncert a (row block, sample group) of the certificate.
template <int S>
__global__ void __launch_bounds__(kThreads)
legendre_banded(const float* __restrict__ u, const float* __restrict__ s,
                float* __restrict__ out, int* __restrict__ row_bad,
                int rows, Shape sh) {
  extern __shared__ __align__(16) float smem[];
  int id;
  if (certificate_kind(sh, id))
    certificate_block<S>(u, s, row_bad, nullptr, rows, sh, smem,
                         id / sh.passes, id % sh.passes);
  else
    band_block(u, s, out, rows, sh, smem, id / sh.ntiles, id % sh.ntiles);
}

template <int S>
__global__ void __launch_bounds__(kThreads)
legendre_anchored(const float* __restrict__ u, const float* __restrict__ s,
                  float* __restrict__ out, unsigned char* __restrict__ ok,
                  int rows, Shape sh) {
  extern __shared__ __align__(16) float smem[];
  int id;
  if (certificate_kind(sh, id))
    certificate_block<S>(u, s, nullptr, ok, rows, sh, smem, id / sh.passes,
                         id % sh.passes);
  else
    anchored_block(u, s, out, rows, sh, smem, id / sh.ntiles,
                   id % sh.ntiles);
}

template <typename Flag>
using Kernel = void (*)(const float*, const float*, float*, Flag*, int,
                        Shape);

// the instantiations for S samples a lane
Kernel<int> banded_kernel(int S) {
  switch (S) {
    case 1: return legendre_banded<1>;
    case 2: return legendre_banded<2>;
    case 3: return legendre_banded<3>;
    case 4: return legendre_banded<4>;
    case 5: return legendre_banded<5>;
    case 6: return legendre_banded<6>;
    case 7: return legendre_banded<7>;
    default: return legendre_banded<8>;
  }
}

Kernel<unsigned char> anchored_kernel(int S) {
  switch (S) {
    case 1: return legendre_anchored<1>;
    case 2: return legendre_anchored<2>;
    case 3: return legendre_anchored<3>;
    case 4: return legendre_anchored<4>;
    case 5: return legendre_anchored<5>;
    case 6: return legendre_anchored<6>;
    case 7: return legendre_anchored<7>;
    default: return legendre_anchored<8>;
  }
}

// The geometry's checks shared by both entry points: S, passes, the grid
// and the shared memory the helper chose (the larger kind's).
bool finish_shape(Shape& sh, int rows, int S, int passes, size_t band,
                  size_t cert, int smem) {
  const long long blocks = (rows + kRows - 1) / kRows;
  const long long nband = blocks * sh.ntiles;
  const long long ncert = blocks * passes;
  if ((size_t)smem != (band > cert ? band : cert) ||
      (long long)passes * kWarps * S < sh.nsamp ||
      nband + ncert >= (1LL << 31))
    return false;
  sh.passes = passes;
  sh.nband = (int)nband;
  sh.ncert = (int)ncert;
  return true;
}

template <typename Flag>
int launch(Kernel<Flag> kernel, const float* u, const float* s, float* out,
           Flag* flag, int rows, const Shape& sh, int smem,
           cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<(unsigned)(sh.nband + sh.ncert), kThreads, smem, stream>>>(
      u, s, out, flag, rows, sh);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out (rows, n) from u (rows, n) and the table s (n,), all float32 and
// contiguous, and row_bad (rows,) int32, zeros on entry: 1 where a row
// fails the certificate. T (the column tile, a multiple of 8 up to 384),
// S (certificate samples a lane, 1..8), passes (sample groups) and smem
// (bytes of dynamic shared memory, the larger kind's) are what
// ops/cuda_bfm.legendre_launch chose; they are checked against the shape.
// Returns the CUDA error of the launch, or 0.
int bfm_legendre_banded(const float* u, const float* s, float* out,
                        int* row_bad, int rows, int n, int W, int K, int T,
                        int S, int passes, int smem, void* stream) {
  if (rows < 1 || n < 2 || K < 1 || K > W || T < kV || T > kMaxTile ||
      T % kV || S < 1 || S > kMaxS || passes < 1)
    return (int)cudaErrorInvalidValue;
  Shape sh = {};
  sh.n = n;
  sh.K = K;
  sh.nsamp = (n - 1 + K - 1) / K + 1;
  sh.npad = (n + 127) / 128 * 128;
  sh.lnext = 1;
  sh.lw = W;
  sh.rw = W + 1;
  sh.W = W;
  sh.ND = (2 * W + 1 + 7) / 8 * 8;
  sh.T = T;
  sh.ntiles = (n + T - 1) / T;
  // per lane: the band's T/8 outputs of ND taps, the certificate's S
  // samples of n lanes
  sh.cert_first = (long long)n * S > (long long)T * sh.ND / kV;
  const size_t band = sizeof(float) *
      ((size_t)kRows * (T + sh.ND + 1) + (T + sh.ND) +
       (size_t)kWarps * kRows * (kV + 1));
  const size_t cert = sizeof(float) * ((size_t)kRows * (T + 1) + T);
  if (!finish_shape(sh, rows, S, passes, band, cert, smem))
    return (int)cudaErrorInvalidValue;
  return launch(banded_kernel(S), u, s, out, row_bad, rows, sh, smem,
                (cudaStream_t)stream);
}

// out (rows, n) from u (rows, n) and the caller's slopes s (n,), all
// float32 and contiguous, and the flag ok (one byte): set to 1 here, then
// cleared where a row fails the certificate or s is not sorted. A (a
// multiple of 8), Wside >= 0: the geometry of misfit/bfm.py's anchored
// route. T (the output tile, a multiple of A up to 384), S, passes and
// smem are what ops/cuda_bfm.legendre_anchored_launch chose; they are
// checked against the shape. Returns the CUDA error of the flag's set or
// of the launch, or 0.
int bfm_legendre_anchored(const float* u, const float* s, float* out,
                          unsigned char* ok, int rows, int n, int A,
                          int Wside, int T, int S, int passes, int smem,
                          void* stream) {
  if (rows < 1 || n < 2 || A < kV || A % kV || Wside < 0 ||
      Wside > (1 << 20) || T < A || T % A || T > kMaxTile || S < 1 ||
      S > kMaxS || passes < 1)
    return (int)cudaErrorInvalidValue;
  Shape sh = {};
  sh.n = n;
  sh.K = A;
  sh.nsamp = (n + A - 1) / A + 1;
  sh.npad = n;
  sh.A = A;
  sh.Wside = Wside;
  sh.Wwin = (2 * Wside + 2 * A - 1) / A * A;
  sh.lnext = 0;
  sh.lw = Wside;
  sh.rw = sh.Wwin - Wside;
  sh.T = T;
  sh.ntiles = (n + T - 1) / T;
  // per lane: a band block's T/8 outputs of W taps over 8 warps, a
  // certificate block's S anchors of n lanes
  sh.cert_first = (long long)n * S > (long long)T * sh.Wwin / kWarps;
  const int L = T + sh.Wwin - A;
  const size_t band = sizeof(float) *
      ((size_t)kRows * (L + 4) + L + (size_t)kWarps * kRows * (kV + 1));
  const size_t cert = sizeof(float) * ((size_t)kRows * (T + 1) + T);
  if (!finish_shape(sh, rows, S, passes, band, cert, smem))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t e = cudaMemsetAsync(ok, 1, 1, st);
  if (e != cudaSuccess) return (int)e;
  return launch(anchored_kernel(S), u, s, out, ok, rows, sh,
                smem, st);
}

const char* bfm_legendre_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
