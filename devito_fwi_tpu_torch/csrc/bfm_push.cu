// BFM pushforward slabs for Hopper (sm_90a), plain C interface for ctypes.
//
//   bfm_push_slabs replaces both pushforward_slabs_nat
//       (devito_fwi_tpu/ops/pallas_bfm.py:369, _push_kernel_nat :312) and
//       pushforward_slabs (pallas_bfm.py:323, _push_kernel :300); both
//       compute _push_block (:245) for every (shot, row block).
//
// What it computes: five planes of one (shot b, block j) give, for every
// subsample q, block row i and lane l, a local row offset rel, a lane
// offset dxr and the weights wy0, mass, wx0; the kernel derives
// wy1 = mass - wy0 and wx1 = 1 - wx0. The cell adds wx * wy to slab
// element (i + g, l + e) of the block's (R + G, lanes) slab for
// (g, wy) in {(rel, wy0), (rel + 1, wy1)} and (e, wx) in
// {(dxr, wx0), (dxr + 1, wx1)}, for 0 <= g < G and 0 <= e < DX only. The
// two layouts differ only in where (b, j, q, i) lies, so one kernel takes
// the plane strides: the natural (B, Q, n2p, lanes) planes and the blocked
// (B, nblk, Q, R, lanes) planes.
//
// Order of the sums: _push_block adds, per slab element, over g ascending
// the sum over e ascending of the sum over q ascending. Every output
// element here is one thread that walks the same nest (g, then e, then q),
// takes the terms that are not zero and adds them in that order, so the
// nesting of the partial sums is the plain version's. Terms that are zero
// add nothing exactly (all weights are >= 0), no atomics are used, and the
// library is compiled with -fmad=false: the slabs equal the plain torch
// version's bitwise.
//
// What bounds it on the card: it reads the five planes once (5 x 242 MB at
// the 29-shot Marmousi state, B = 29, Q = 4, n2p = 1360, lanes = 384) and
// writes the slabs (151 MB), so its bound is device-memory bandwidth,
// ~0.41 ms. This first design tests, for each output, every candidate cell
// of its nest, up to 16 block rows x 16 lanes x Q subsamples, reading the
// planes through L1/L2 (a (Q, R, lanes) block of the five planes is
// 491 KB and does not fit shared memory); it is bound by those reads and
// compares, far above the bound. A compact per-block list of the
// contributions in shared memory is the next step.
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

__global__ void push_slabs(const int* __restrict__ rel,
                           const int* __restrict__ dxr,
                           const float* __restrict__ wy0,
                           const float* __restrict__ mass,
                           const float* __restrict__ wx0,
                           float* __restrict__ out, int nblk, int Q, int R,
                           int G, int DX, int lanes, long long s_b,
                           long long s_blk, long long s_q, long long s_i,
                           size_t n) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int S = R + G;
  const int lane = (int)(idx % lanes);
  const int row = (int)((idx / lanes) % S);
  const size_t bj = idx / ((size_t)lanes * S);
  const size_t b = bj / nblk;
  const size_t j = bj % nblk;
  const size_t base = b * (size_t)s_b + j * (size_t)s_blk;
  const int g_lo = row - R + 1 > 0 ? row - R + 1 : 0;
  const int g_hi = row < G - 1 ? row : G - 1;
  const int e_hi = lane < DX - 1 ? lane : DX - 1;
  float slab = 0.0f;
  for (int g = g_lo; g <= g_hi; ++g) {
    const size_t row_off = base + (size_t)(row - g) * (size_t)s_i;
    float acc = 0.0f;
    for (int e = 0; e <= e_hi; ++e) {
      const size_t cell = row_off + (size_t)(lane - e);
      float v = 0.0f;
      for (int q = 0; q < Q; ++q) {
        const size_t o = cell + (size_t)q * (size_t)s_q;
        const int d = dxr[o];
        if (d != e && d != e - 1) continue;
        const int r = rel[o];
        if (r != g && r != g - 1) continue;
        const float y0 = wy0[o];
        const float wy = r == g ? y0 : mass[o] - y0;
        const float x0 = wx0[o];
        const float wx = d == e ? x0 : 1.0f - x0;
        v = v + wx * wy;
      }
      acc = acc + v;
    }
    slab = slab + acc;
  }
  out[idx] = slab;
}

}  // namespace

extern "C" {

// Slabs out (B, nblk, R + G, lanes) float32 from the five planes; element
// (b, j, q, i, l) of each plane lies at b*s_b + j*s_blk + q*s_q + i*s_i + l.
// Returns the CUDA error of the launch, or 0.
int bfm_push_slabs(const int* rel, const int* dxr, const float* wy0,
                   const float* mass, const float* wx0, float* out, int B,
                   int nblk, int Q, int R, int G, int DX, int lanes,
                   long long s_b, long long s_blk, long long s_q,
                   long long s_i, void* stream) {
  if (B < 1 || nblk < 1 || Q < 1 || R < 1 || G < 1 || DX < 1 || lanes < 1)
    return (int)cudaErrorInvalidValue;
  const size_t n = (size_t)B * nblk * (R + G) * lanes;
  const int threads = 256;
  const size_t blocks = (n + threads - 1) / threads;
  push_slabs<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      rel, dxr, wy0, mass, wx0, out, nblk, Q, R, G, DX, lanes, s_b, s_blk,
      s_q, s_i, n);
  return (int)cudaGetLastError();
}

const char* bfm_push_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
