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
// as in the plain version. The max propagates NaN as jnp.maximum and
// torch.maximum do (fmaxf would drop it). A row holding a NaN has no hit
// (v >= NaN is false), so its first is n and its last -1, as in the Pallas
// certificate.
//
// What bounds it on the card: per 2-D transform of the 29-shot Marmousi W2
// state, (39353 rows of 300) and (8700 rows of 1357), about 5e9 operations
// for the band and 7e9 for the certificate at 67 TFLOP/s f32, ~0.19 ms, and
// ~0.1 GB of input and output at 3.35 TB/s: it is bound by operations.
// Design: one block per row. The row and the slopes, padded, sit in shared
// memory (2 x (n + ND) floats, 11.7 KB at n = 1357); each thread takes
// outputs i = tid, tid + blockDim, ... and walks its ND taps in registers.
// Each warp takes certificate samples in turn: its lanes stride over the
// padded row keeping (max, first, last, any NaN), combined by shuffles; one
// thread then checks the consecutive pairs and writes the row's flag. This
// first design re-reads the row from shared memory once per tap and once per
// sample; the times against the bound are in PERF.md.
#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float max_nan(float a, float b) {
  return (b > a || b != b) ? b : a;
}

struct Arg {
  float v;     // max over the lanes seen
  int first;   // INT_MAX: no lane seen yet
  int last;
  int nan;
};

__device__ __forceinline__ Arg combine(Arg a, Arg b) {
  Arg o;
  o.nan = a.nan | b.nan;
  if (b.first == INT_MAX || (a.first != INT_MAX && a.v > b.v)) {
    o.v = a.v; o.first = a.first; o.last = a.last;
  } else if (a.first == INT_MAX || b.v > a.v) {
    o.v = b.v; o.first = b.first; o.last = b.last;
  } else {
    o.v = a.v;
    o.first = a.first < b.first ? a.first : b.first;
    o.last = a.last > b.last ? a.last : b.last;
  }
  return o;
}

__global__ void legendre_banded(const float* __restrict__ u,
                                const float* __restrict__ s,
                                float* __restrict__ out,
                                int* __restrict__ row_ok, int n, int W,
                                int K, int ND, int npad, int nsamp) {
  extern __shared__ float smem[];
  const int L = n + ND;
  float* us = smem;                     // us[k]: u[r, k - W], big outside
  float* sp = smem + L;                 // sp[k]: s[k - W], 0 outside
  int* first = (int*)(sp + L);          // per certificate sample
  int* last = first + nsamp;
  const float big = FLT_MAX / 8.0f;
  const size_t row = blockIdx.x;
  const float* ur = u + row * (size_t)n;

  for (int k = threadIdx.x; k < L; k += blockDim.x) {
    const int j = k - W;
    const bool in = j >= 0 && j < n;
    us[k] = in ? ur[j] : big;
    sp[k] = in ? s[j] : 0.0f;
  }
  __syncthreads();

  float* outr = out + row * (size_t)n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float si = sp[i + W];
    float acc = -big;
    for (int d = 0; d < ND; ++d) {
      const float p = si * sp[i + d];
      acc = max_nan(acc, p - us[i + d]);
    }
    outr[i] = acc;
  }

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int m = warp; m < nsamp; m += nwarps) {
    const int im = m * K < n - 1 ? m * K : n - 1;
    const float sm = sp[im + W];
    Arg a = {0.0f, INT_MAX, -1, 0};
    for (int j = lane; j < npad; j += 32) {
      float v;
      if (j < n) {
        const float p = sm * sp[j + W];
        v = p - us[j + W];
      } else {
        v = sm * 0.0f - big;
      }
      if (v != v) {
        a.nan = 1;
      } else if (a.first == INT_MAX || v > a.v) {
        a.v = v; a.first = j; a.last = j;
      } else if (v == a.v) {
        a.last = j;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      Arg b;
      b.v = __shfl_xor_sync(0xffffffffu, a.v, off);
      b.first = __shfl_xor_sync(0xffffffffu, a.first, off);
      b.last = __shfl_xor_sync(0xffffffffu, a.last, off);
      b.nan = __shfl_xor_sync(0xffffffffu, a.nan, off);
      a = combine(a, b);
    }
    if (lane == 0) {
      first[m] = a.nan ? n : a.first;
      last[m] = a.nan ? -1 : a.last;
    }
  }
  __syncthreads();

  if (threadIdx.x == 0) {
    int ok = 1;
    for (int m = 1; m < nsamp; ++m) {
      const int im = m * K < n - 1 ? m * K : n - 1;
      const int prev = (m - 1) * K < n - 1 ? (m - 1) * K : n - 1;
      ok = ok && first[m - 1] >= im - W && last[m] <= prev + W;
    }
    row_ok[row] = ok;
  }
}

}  // namespace

extern "C" {

// out (rows, n) and row_ok (rows,) int32 from u (rows, n) and the table s
// (n,), all float32 and contiguous. Returns the CUDA error of the launch,
// or 0.
int bfm_legendre_banded(const float* u, const float* s, float* out,
                        int* row_ok, int rows, int n, int W, int K,
                        void* stream) {
  if (rows < 1 || n < 2 || W < 0 || K < 1) return (int)cudaErrorInvalidValue;
  const int ND = (2 * W + 1 + 7) / 8 * 8;
  const int npad = (n + 127) / 128 * 128;
  const int nsamp = (n - 1 + K - 1) / K + 1;
  const size_t shm = (size_t)2 * (n + ND) * sizeof(float) +
                     (size_t)2 * nsamp * sizeof(int);
  if (shm > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        legendre_banded, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)shm);
    if (e != cudaSuccess) return (int)e;
  }
  legendre_banded<<<(unsigned)rows, kThreads, shm, (cudaStream_t)stream>>>(
      u, s, out, row_ok, n, W, K, ND, npad, nsamp);
  return (int)cudaGetLastError();
}

const char* bfm_legendre_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
