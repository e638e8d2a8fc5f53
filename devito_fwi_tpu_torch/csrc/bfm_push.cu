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
// What bounds it on the card: it must read the five planes once (5 x 242 MB
// at the 29-shot SMARMN state, B = 29, Q = 4, n2p = 1360, lanes = 384) and
// write the slabs (151 MB): device-memory bandwidth, 0.407 ms on an H100
// (3.35 TB/s). Each active cell adds to at most four outputs (about 6.4
// terms an output there), but a gather over every candidate of an output's
// nest (up to 16 block rows x 16 lanes x Q) tests ~90 times more cells
// than there are terms: the first design, one thread an output, took
// 20.03 ms (H100 80GB HBM3, 700 W).
//
// The design: one block takes one (shot b, row block j, tile of kTile
// lanes) and builds the list of the real contributions in shared memory.
//   1. count: the block reads its cells once, coalesced (the tile and the
//      DX - 1 lanes to its left that reach it, Q x R x (kTile + DX - 1)
//      cells), forms each cell's (up to four) products wx * wy as the first
//      design did, and counts the non-zero ones per output with
//      shared-memory atomics;
//   2. an exclusive prefix sum of the counts gives each output its slots;
//   3. fill: the same pass again (the cells now come from L1/L2) writes
//      each entry into a slot of its output: a word (key (g, e, q) << 16 |
//      slot) and, at the slot, the product;
//   4. sum: one thread an output sorts its words (insertion sort, 32-bit
//      words: half the shared-memory traffic of sorting 64-bit entries)
//      and adds the products with the nesting of _push_block: v over q,
//      acc over e, slab over g, each ascending; it writes the element.
// For one output a key names one source cell, so the sorted list is the
// first design's walk without the cells that add nothing. A zero product
// adds +0 to a sum of non-negative terms, which changes nothing, and the
// order the atomics ran in cannot reach the sorted sums; with -fmad=false
// the slabs equal the plain torch version's bitwise. Shared memory holds
// 4 Q R (kTile + DX - 1) entries of 8 bytes (every cell's four products,
// the worst case), one int an output and 16 warp sums: 101,440 bytes at
// the main path's Q = 4, R = 16, G = 24, DX = 16, two blocks an SM.
//
// Measured (chip_smoke.py phase 5, H100 80GB HBM3 at 700 W) on the 29-shot
// planes of a live SMARMN W2-2d trial: 3.67 ms against the first design's
// 20.03 ms (PERF.md, kernel table rows 12-13), 9x the bound; the count
// pass (two blocks an SM, their shared memory sized for the worst case)
// and the per-output sort take most of it.
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;       // lanes of a block's slab tile
constexpr int kThreads = 512;   // threads of a block
constexpr int kMaxQ = 8;
constexpr size_t kMaxSmem = 232448;  // a block's shared memory on sm_90

// Shared-memory bytes of a block: the entries, the counts, the scan's
// warp sums.
size_t smem_bytes(int Q, int R, int G, int DX) {
  const size_t cells = (size_t)Q * R * (kTile + DX - 1);
  return 8 * 4 * cells + 4 * (size_t)(R + G) * kTile + 4 * (kThreads / 32);
}

// One cell's planes and its place in the block.
struct Cell {
  int r, d, i, q, lane;
  float y0, y1, x0;
};

// Cell c of the block (its Q x R x (kTile + DX - 1) cells, lanes
// fastest); lane < 0 when it lies outside the planes.
__device__ __forceinline__ Cell load_cell(
    const int* __restrict__ rel, const int* __restrict__ dxr,
    const float* __restrict__ wy0, const float* __restrict__ mass,
    const float* __restrict__ wx0, size_t base, int c, int R, int DX,
    int lanes, int l0, long long s_q, long long s_i) {
  const int W = kTile + DX - 1;
  Cell e;
  e.i = (c / W) % R;
  e.q = c / (W * R);
  e.lane = l0 - (DX - 1) + c % W;
  if (e.lane < 0 || e.lane >= lanes) {
    e.lane = -1;
    return e;
  }
  const size_t o = base + (size_t)e.q * (size_t)s_q +
                   (size_t)e.i * (size_t)s_i + (size_t)e.lane;
  e.r = rel[o];
  e.d = dxr[o];
  e.y0 = wy0[o];
  e.y1 = mass[o] - e.y0;
  e.x0 = wx0[o];
  return e;
}

// emit(output, key, product) for each of the cell's (up to four)
// contributions to the tile whose product is not zero.
template <class Emit>
__device__ __forceinline__ void cell_entries(const Cell& c, int Q, int G,
                                             int DX, int lanes, int l0,
                                             Emit emit) {
  if (c.lane < 0) return;
  const float x1 = 1.0f - c.x0;
#pragma unroll
  for (int gs = 0; gs < 2; ++gs) {
    const int g = c.r + gs;
    if (g < 0 || g >= G) continue;
    const float wy = gs ? c.y1 : c.y0;
#pragma unroll
    for (int es = 0; es < 2; ++es) {
      const int e = c.d + es;
      const int tl = c.lane + e - l0;
      if (e < 0 || e >= DX || tl < 0 || tl >= kTile || c.lane + e >= lanes)
        continue;
      const float v = (es ? x1 : c.x0) * wy;
      if (v != 0.0f)
        emit((c.i + g) * kTile + tl, (uint32_t)((g * DX + e) * Q + c.q), v);
    }
  }
}

// Every entry of the block's cells, to emit.
template <class Emit>
__device__ __forceinline__ void for_cells(
    const int* __restrict__ rel, const int* __restrict__ dxr,
    const float* __restrict__ wy0, const float* __restrict__ mass,
    const float* __restrict__ wx0, size_t base, int ncell, int Q, int R,
    int G, int DX, int lanes, int l0, long long s_q, long long s_i,
    Emit emit) {
  for (int c = threadIdx.x; c < ncell; c += kThreads)
    cell_entries(load_cell(rel, dxr, wy0, mass, wx0, base, c, R, DX, lanes,
                           l0, s_q, s_i),
                 Q, G, DX, lanes, l0, emit);
}

// In-place exclusive prefix sum of cnt[0..n) by the whole block.
__device__ void block_exclusive_scan(int* cnt, int n, int* warp_sums) {
  const int tid = threadIdx.x;
  const int per = (n + kThreads - 1) / kThreads;
  const int lo = tid * per;
  const int hi = lo + per < n ? lo + per : n;
  int local = 0;
  for (int k = lo; k < hi; ++k) local += cnt[k];
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int inc = local;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc += y;
  }
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kThreads / 32 ? warp_sums[lane] : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w += y;
    }
    if (lane < kThreads / 32) warp_sums[lane] = w;
  }
  __syncthreads();
  int run = inc - local + (warp ? warp_sums[warp - 1] : 0);
  for (int k = lo; k < hi; ++k) {
    const int c = cnt[k];
    cnt[k] = run;
    run += c;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
push_slabs(const int* __restrict__ rel, const int* __restrict__ dxr,
           const float* __restrict__ wy0, const float* __restrict__ mass,
           const float* __restrict__ wx0, float* __restrict__ out, int nblk,
           int Q, int R, int G, int DX, int lanes, long long s_b,
           long long s_blk, long long s_q, long long s_i) {
  // the entries: word (key << 16 | slot), sorted per output, and the
  // product at its slot
  extern __shared__ uint32_t ent[];
  const int tid = threadIdx.x;
  const int S = R + G;
  const int nout = S * kTile;
  const int ncell = Q * R * (kTile + DX - 1);
  float* val = reinterpret_cast<float*>(ent + 4 * ncell);
  int* cnt = reinterpret_cast<int*>(val + 4 * ncell);
  int* warp_sums = cnt + nout;
  const size_t bj = blockIdx.x;
  const size_t b = bj / nblk;
  const size_t j = bj % nblk;
  const size_t base = b * (size_t)s_b + j * (size_t)s_blk;
  const int l0 = blockIdx.y * kTile;

  for (int k = tid; k < nout; k += kThreads) cnt[k] = 0;
  __syncthreads();
  for_cells(rel, dxr, wy0, mass, wx0, base, ncell, Q, R, G, DX, lanes, l0,
            s_q, s_i, [&](int o, uint32_t, float) { atomicAdd(&cnt[o], 1); });
  __syncthreads();
  block_exclusive_scan(cnt, nout, warp_sums);
  // cnt[o] is the first slot of output o; the fill advances it to the
  // first slot of o + 1
  for_cells(rel, dxr, wy0, mass, wx0, base, ncell, Q, R, G, DX, lanes, l0,
            s_q, s_i, [&](int o, uint32_t key, float v) {
              const int slot = atomicAdd(&cnt[o], 1);
              ent[slot] = key << 16 | (uint32_t)slot;
              val[slot] = v;
            });
  __syncthreads();

  float* slab = out + bj * (size_t)S * lanes;
  for (int o = tid; o < nout; o += kThreads) {
    const int lo = o ? cnt[o - 1] : 0;
    const int hi = cnt[o];
    // insertion sort by key (the keys of one output are distinct)
    for (int a = lo + 1; a < hi; ++a) {
      const uint32_t x = ent[a];
      int p = a - 1;
      while (p >= lo && ent[p] > x) {
        ent[p + 1] = ent[p];
        --p;
      }
      ent[p + 1] = x;
    }
    float sum = 0.0f, acc = 0.0f, v = 0.0f;
    int cg = -1, ce = -1;
    for (int a = lo; a < hi; ++a) {
      const uint32_t x = ent[a];
      const int k = (int)(x >> 16);
      const int g = k / (DX * Q);
      const int e = (k / Q) % DX;
      if (g != cg) {
        if (cg >= 0) {
          acc = acc + v;
          sum = sum + acc;
        }
        acc = 0.0f;
        v = 0.0f;
        cg = g;
        ce = e;
      } else if (e != ce) {
        acc = acc + v;
        v = 0.0f;
        ce = e;
      }
      v = v + val[x & 0xffffu];
    }
    if (cg >= 0) {
      acc = acc + v;
      sum = sum + acc;
    }
    const int row = o / kTile;
    const int lane = l0 + o % kTile;
    if (lane < lanes) slab[(size_t)row * lanes + lane] = sum;
  }
}

}  // namespace

extern "C" {

// Slabs out (B, nblk, R + G, lanes) float32 from the five planes; element
// (b, j, q, i, l) of each plane lies at b*s_b + j*s_blk + q*s_q + i*s_i + l.
// smem is the block's shared-memory bytes as the caller computed them
// (ops/cuda_bfm.py push_launch); it must equal the kernel's own figure.
// Returns the CUDA error of the launch, or 0.
int bfm_push_slabs(const int* rel, const int* dxr, const float* wy0,
                   const float* mass, const float* wx0, float* out, int B,
                   int nblk, int Q, int R, int G, int DX, int lanes,
                   long long s_b, long long s_blk, long long s_q,
                   long long s_i, long long smem, void* stream) {
  if (B < 1 || nblk < 1 || Q < 1 || Q > kMaxQ || R < 1 || G < 1 || DX < 1 ||
      lanes < 1)
    return (int)cudaErrorInvalidValue;
  const size_t bytes = smem_bytes(Q, R, G, DX);
  // a slot and a key each fit 16 bits (4 * cells < 65536 follows from the
  // shared-memory bound)
  if (bytes > kMaxSmem || (long long)bytes != smem ||
      (size_t)G * DX * Q > 0xffffu || (size_t)B * nblk > 0x7fffffffu)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      push_slabs, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(B * nblk), (unsigned)((lanes + kTile - 1) /
                                                   kTile));
  push_slabs<<<grid, kThreads, bytes, (cudaStream_t)stream>>>(
      rel, dxr, wy0, mass, wx0, out, nblk, Q, R, G, DX, lanes, s_b, s_blk,
      s_q, s_i);
  return (int)cudaGetLastError();
}

const char* bfm_push_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
