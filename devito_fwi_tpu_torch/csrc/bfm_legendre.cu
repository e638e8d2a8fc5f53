// Banded Legendre transform with its certificate, for Hopper (sm_90a), plain
// C interface for ctypes.
//
//   bfm_legendre_banded replaces legendre_banded
//       (devito_fwi_tpu/ops/pallas_bfm.py:173, pl.pallas_call :215,
//       _legendre_kernel :80).
//
// What it computes, for a (rows, n) float32 u and the BFM grid coordinates
// s_j = (j + 0.5)/n (a host table, built in float32 as the Pallas wrapper
// builds it, so that the kernel and the plain version read the same
// slopes), with big = FLT_MAX/8:
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
// Numbers: -fmad=false keeps the product and the subtraction two roundings,
// as in the plain version. The band's max propagates NaN as jnp.maximum
// and torch.maximum do (max.NaN; fmaxf would drop it); a max is exact, so
// its order does not matter. A row holding a NaN has no hit (v >= NaN is
// false), so its first is n and its last -1, and it passes.
//
// What bounds it on the card: per 2-D transform of the 29-shot Marmousi W2
// state, (39353 rows of 300) and (8700 rows of 1357), the band's 1.9e9 taps
// and the certificate's 1.5e9 lane evaluations, a product, a difference and
// a max each: some 1e10 float operations, bound by operations, not by the
// 0.1 GB of input and output. The first design (one block of 256 threads a
// row) ran 14-15x its bound: at n = 300 its second round of taps kept 44
// of 256 threads busy, each tap cost two shared loads for three operations,
// the products s_i s_{i+d}, the same for every row, were formed again for
// each, and thread 0 alone checked the samples.
//
// Design: one launch of many small blocks of two kinds, each block 32
// rows, one a lane, over column tiles of T lanes (T <= 384; the whole row
// at n = 300) loaded into shared memory at an odd row pitch (the 32 lanes
// of a warp read 32 rows on 32 banks); the slopes, the same for every row,
// are one shared table read by broadcast. A band block takes a (32 rows,
// tile): the tile with the band's halo; a lane takes 8 consecutive outputs
// of its row, the u and slope windows in registers, one shared load of
// each per tap for 8 outputs; the outputs go through a per-warp staging
// tile so that stores are row runs. A certificate block takes a (32 rows,
// group of 8 S samples): a lane takes S samples of its row and walks the
// row's lanes once, tile by tile, for all of them, one shared load a lane
// for S samples. It needs, per sample, only whether a hit lies left of
// a = i_{m+1} - W (first >= a fails otherwise) or right of c = i_{m-1} +
// W: the walk keeps, per sample, the maxima of [0, a), [a, c] and (c, n) -
// one running max and a switch at a and at c + 1, positions the same for
// all 32 lanes, so the inner loop is a product, a difference and a max.
// The npad - n pad lanes are all -big: they are added to the regions they
// fall in once, not walked. A sample passes iff A is empty or max A < max,
// and C (pad lanes included) is empty or max C < max, which is first >= a
// and last <= c; a row with a failing sample and no NaN is marked bad. The
// walk needs K <= W (a < c + 1); the launch helper (ops/cuda_bfm.py
// legendre_launch) raises otherwise. Small blocks of both kinds in one
// grid, the longer kind first, keep the card's 132 SMs evenly busy where
// one block a row block (8,700 rows of 1357 make only 272) did not.
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
  int n, W, K, ND, npad, nsamp, T, ntiles, passes;
  int nband, ncert;     // blocks of each kind: row blocks x tiles, x passes
  int cert_first;       // the kind with the longer blocks is numbered first
};

__device__ __forceinline__ int sample(const Shape& sh, int m) {
  return m * sh.K < sh.n - 1 ? m * sh.K : sh.n - 1;
}

// the regions of sample m: A = [0, a), C = [c1, npad) (c1 = c + 1); a <= 0
// leaves A empty (also for the last sample, which has no first check), and
// c1 = INT_MAX C (the first sample has no last check)
__device__ __forceinline__ int left_limit(const Shape& sh, int m) {
  return m + 1 < sh.nsamp ? sample(sh, m + 1) - sh.W : INT_MIN;
}

__device__ __forceinline__ int right_limit(const Shape& sh, int m) {
  return m >= 1 ? sample(sh, m - 1) + sh.W + 1 : INT_MAX;
}

// Columns [c0, c0 + L) of the block's 32 rows into us (pitch L + 1; big
// outside the row and for rows past the last) and of the slopes into sp
// (0 outside); returns, per warp, whether the rows it loaded hold a NaN
// (a bit a row).
__device__ __forceinline__ unsigned load_cols(const float* __restrict__ u,
                                              const float* __restrict__ s,
                                              float* us, float* sp, int n,
                                              int rows, size_t row0, int c0,
                                              int L) {
  const float big = FLT_MAX / 8.0f;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned nans = 0;
  for (int r = warp; r < kRows; r += kWarps) {
    const size_t row = row0 + r;
    const bool live = row < (size_t)rows;
    const float* src = u + (live ? row : 0) * (size_t)n;
    float* dst = us + r * (L + 1);
    int nan = 0;
    for (int k = lane; k < L; k += 32) {
      const int j = c0 + k;
      float x = big;
      if (live && j >= 0 && j < n) {
        x = src[j];
        nan |= x != x;
      }
      dst[k] = x;
    }
    if (__any_sync(0xffffffffu, nan)) nans |= 1u << r;
  }
  for (int k = threadIdx.x; k < L; k += kThreads) {
    const int j = c0 + k;
    sp[k] = (j >= 0 && j < n) ? s[j] : 0.0f;
  }
  return nans;
}

// The band on one tile of 32 rows: the tile's columns and the halo, then
// groups of kV outputs, a warp's lanes the 32 rows.
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
  load_cols(u, s, us, sp, sh.n, rows, row0, j0 - sh.W, Lk);
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
#pragma unroll
    for (int v = 0; v < kV; ++v) st[lane * (kV + 1) + v] = acc[v];
    __syncwarp();
#pragma unroll
    for (int q = 0; q < kV; ++q) {
      const int idx = q * 32 + lane;
      const int r = idx / kV;
      const int v = idx % kV;
      const size_t row = row0 + r;
      if (row < (size_t)rows && i0 + v < sh.n)
        out[row * sh.n + i0 + v] = st[r * (kV + 1) + v];
    }
    __syncwarp();
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
      for (int q = 0; q < S; ++q) run[q] = fmaxf(run[q], sm[q] * sj - uj);
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
      mC = fmaxf(mC, -big);
    } else {
      mB = fmaxf(mB, -big);
      if (c1 < sh.npad) mC = fmaxf(mC, -big);
    }
  }
  const float M = fmaxf(fmaxf(mA, mB), mC);
  const bool first_ok = al <= 0 || mA < M;
  const bool last_ok = c1 >= sh.npad || mC < M;
  return first_ok && last_ok;
}

// The certificate of 32 rows for one group of kWarps x S samples: the
// row's tiles in turn (no halo), walked; a row with a failing sample and
// no NaN is marked in row_bad.
template <int S>
__device__ __forceinline__ void certificate_block(
    const float* __restrict__ u, const float* __restrict__ s,
    int* __restrict__ row_bad, int rows, const Shape& sh, float* smem,
    int row_block, int group) {
  float* us = smem;                       // us[r*(T+1) + k]: u[row0+r, j0+k]
  float* sp = us + kRows * (sh.T + 1);    // sp[k]: s[j0+k]
  unsigned* nan_row = (unsigned*)(sp + sh.T);   // a word a warp
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
  unsigned nans = 0;
  for (int tile = 0; tile < sh.ntiles; ++tile) {
    const int j0 = tile * sh.T;
    if (tile) __syncthreads();
    nans |= load_cols(u, s, us, sp, sh.n, rows, row0, j0, sh.T);
    __syncthreads();
    walk_tile<S>(us, sp, sh, mb, j0, sm, run, mA, mB);
  }
  if (lane == 0) nan_row[warp] = nans;
  bool ok = true;
#pragma unroll
  for (int q = 0; q < S; ++q)
    ok = ok && sample_passes(sh, mb + q, run[q], mA[q], mB[q]);
  __syncthreads();
  unsigned nan_any = 0;
  for (int w = 0; w < kWarps; ++w) nan_any |= nan_row[w];
  const size_t row = row0 + lane;
  if (!ok && !((nan_any >> lane) & 1u) && row < (size_t)rows)
    row_bad[row] = 1;
}

// One launch, two kinds of block: nband blocks a (row block, tile) of
// the band and ncert a (row block, sample group) of the certificate; the
// kind with the longer blocks takes the lower numbers, so that the short
// ones fill the card's tail.
template <int S>
__global__ void __launch_bounds__(kThreads)
legendre_banded(const float* __restrict__ u, const float* __restrict__ s,
                float* __restrict__ out, int* __restrict__ row_bad,
                int rows, Shape sh) {
  extern __shared__ float smem[];
  int id = blockIdx.x;
  bool cert;
  if (sh.cert_first) {
    cert = id < sh.ncert;
    if (!cert) id -= sh.ncert;
  } else {
    cert = id >= sh.nband;
    if (cert) id -= sh.nband;
  }
  if (cert)
    certificate_block<S>(u, s, row_bad, rows, sh, smem, id / sh.passes,
                         id % sh.passes);
  else
    band_block(u, s, out, rows, sh, smem, id / sh.ntiles, id % sh.ntiles);
}

template <int S>
int launch(const float* u, const float* s, float* out, int* row_bad,
           int rows, const Shape& sh, int smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        legendre_banded<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
  }
  legendre_banded<S><<<(unsigned)(sh.nband + sh.ncert), kThreads, smem,
                       stream>>>(u, s, out, row_bad, rows, sh);
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
  Shape sh;
  sh.n = n;
  sh.W = W;
  sh.K = K;
  sh.ND = (2 * W + 1 + 7) / 8 * 8;
  sh.npad = (n + 127) / 128 * 128;
  sh.nsamp = (n - 1 + K - 1) / K + 1;
  sh.T = T;
  sh.ntiles = (n + T - 1) / T;
  sh.passes = passes;
  const long long blocks = (rows + kRows - 1) / kRows;
  const long long nband = blocks * sh.ntiles;
  const long long ncert = blocks * passes;
  // per lane: the band's T/8 outputs of ND taps, the certificate's S
  // samples of n lanes
  sh.cert_first = (long long)n * S > (long long)T * sh.ND / kV;
  const size_t band = sizeof(float) *
      ((size_t)kRows * (T + sh.ND + 1) + (T + sh.ND) +
       (size_t)kWarps * kRows * (kV + 1));
  const size_t cert = sizeof(float) *
      ((size_t)kRows * (T + 1) + T + kWarps);
  if ((size_t)smem != (band > cert ? band : cert) ||
      (long long)passes * kWarps * S < sh.nsamp ||
      nband + ncert >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  sh.nband = (int)nband;
  sh.ncert = (int)ncert;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (S) {
    case 1: return launch<1>(u, s, out, row_bad, rows, sh, smem, st);
    case 2: return launch<2>(u, s, out, row_bad, rows, sh, smem, st);
    case 3: return launch<3>(u, s, out, row_bad, rows, sh, smem, st);
    case 4: return launch<4>(u, s, out, row_bad, rows, sh, smem, st);
    case 5: return launch<5>(u, s, out, row_bad, rows, sh, smem, st);
    case 6: return launch<6>(u, s, out, row_bad, rows, sh, smem, st);
    case 7: return launch<7>(u, s, out, row_bad, rows, sh, smem, st);
    default: return launch<8>(u, s, out, row_bad, rows, sh, smem, st);
  }
}

const char* bfm_legendre_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
