// 2-D acoustic OT2 leapfrog sweeps for Hopper (sm_90a), plain C interface
// for ctypes. Four entry points, each one sweep over all time steps of a
// shot batch on the caller's stream:
//
//   acoustic2d_forward(..., dt2 = NULL, ckpt = NULL)
//       replaces forward_rec_segments (devito_fwi_tpu/ops/pallas_acoustic.py
//       :221, _fwd_rec_kernel :182): records the two receiver rows of u at
//       every step.
//   acoustic2d_forward(..., dt2 != NULL)
//       replaces forward_dt2_segments (pallas_acoustic.py:569,
//       _fwd_dt2_kernel :520): the same forward, plus the d2u/dt2 history
//       un - 2u + up of every step and the illumination sum of un^2 over the
//       steps t < nsteps.
//   acoustic2d_forward(..., ckpt != NULL)
//       replaces forward_ckpt_segments (pallas_acoustic.py:306,
//       _fwd_ckpt_kernel :257): receiver rows and illumination as above,
//       plus the (u, u_prev) pair at the start of every segment of seg steps
//       instead of the history.
//   acoustic2d_adjoint
//       replaces gradient_stream_segments (pallas_acoustic.py:673,
//       _grad_stream_kernel :622): the reverse adjoint sweep over the
//       streamed history, grad += dt2[t] * v, scaled by -1/s^2 at the
//       last step.
//   acoustic2d_gradient_segments
//       replaces gradient_segments (pallas_acoustic.py:453, _grad_kernel
//       :361): for each segment from the last to the first, seg forward
//       steps from its saved pair into a per-segment d2u/dt2 scratch, then
//       the seg adjoint steps of that segment over the scratch; scaled by
//       -1/s^2 at the last step.
//
// Layout: fields are (B, nz, nx) float32 with x contiguous (the transposed
// layout of the JAX kernels); m, two_m_hd = 2m + hd and denom = 1/(m + hd)
// are (nz, nx) and shared by all shots; the source pattern (w s^2/m at the
// bilinear corners, at most four cells a shot) comes as each shot's non-zero
// cells (src_cell, src_val); receiver rows are (B, total, 2, nx) on the
// padded z-planes z0 and z0 + 1; the history is (B, total, nz, nx); the
// segment pairs are (B, nseg, 2, nz, nx) and the recompute scratch
// (B, seg, nz, nx).
//
// What bounds it on the card: the forward with history writes
// B * total * nz * nx * 4 bytes (11.2 GB for the 29-shot Marmousi batch) and
// the adjoint reads them back, so both are bound by device-memory bandwidth;
// the receivers-only and the checkpoint forwards move little beyond their
// state and are bound by the ~40 float operations per cell and step. Taken a
// step at a time, each sweep's floor is its state through device memory once
// a step: a field of the 29-shot batch is 8.2 MB.
//
// The forwards (forward_tile): the first design ran one launch a step, one
// thread a cell, every neighbour re-read through L1/L2, and the dense source
// pattern read at every cell: 4 fields a step for the modeling sweep (u and
// up read, up written, inj read), 7 with the history, 6 with the pairs, and
// the start and tail of 1368 short launches (~21 us a step). The fused tile
// runs kSteps = 2 steps a launch over a kTX x kTZ tile of one shot (512
// threads, two cells a thread): it loads u on the tile and a 2R halo into
// shared memory once, forms step t on the tile and an R halo there (the
// halo's cells repeat their owners' operations on the same stored values,
// so they round alike), then step t + 1 on the tile, and writes both new
// fields, every step's record rows, history values, illumination and
// segment pairs of the cells it owns. The source adds only at its cells, in
// the halo too (adding wav * 0 elsewhere changes no finite value).
// Neighbouring tiles read this launch's u and up in their halos, so the
// state ping-pongs between two pairs of buffers; a sweep or segment of odd
// length ends with one single-step launch, which writes un over up in place
// (read only at the cell's own place). 2 fields a step for the modeling
// sweep, 4 with the history, 3 with the pairs. The shots are the grid's
// fastest axis, so a tile's coefficients stay in L1/L2 across its shots.
// Times against these floors are in PERF.md (kernel table, rows 1, 2, 4).
//
// The reverse sweeps read v (at its neighbours), vn, the history slot and
// grad and write vn and grad: 6 batch fields a step. The first design
// (adjoint_step) ran one launch a step, one thread a cell, the neighbours
// through L1/L2: ~22 us a step, of which the launch's start and tail are
// a small part; the rest is traffic through L2 (v's stencil, vn and grad,
// and the three coefficients again for each shot: ~90 MB a step). The
// reverse (adjoint_tile) is the forwards' two-step tile in reverse: v with
// a 2R halo in shared memory, step t on the tile and an R halo (the
// residual rows added in the halo too), step t - 1 on the tile, both
// steps' terms added to grad in registers; the history slot is read with
// streaming loads, so that it does not evict the state from L2; an odd
// last step is one launch of the first design. Both keep the first
// design's arithmetic cell by cell, and the final -1/s^2 scale multiplies
// the last step's sum before it is stored, which rounds as a separate pass
// over grad did. Times against the floors, and those of the designs the
// tile was chosen over (tools/probe_reverses.py), are in PERF.md (rows 3
// and 5).
//
// Numerics: the arithmetic association of the JAX kernels' _make_lap_t and
// update is kept term for term (shift pair summed before the weight
// multiply, x term first, per-axis dt^2/h^2 scales), and the library is
// compiled with -fmad=false so no multiply-add is contracted: the kernels
// then round exactly like the plain torch twins in ops/cuda_acoustic.py.
// The recompute runs the very steps of the streamed forward from the very
// state it saved, so the checkpoint gradient equals the streamed one
// bitwise. Neighbours beyond the padded grid are zero; under a free surface
// rows 0..r of the z-derivative use the odd-mirrored stencil.
#include <cuda_runtime.h>
#include <stddef.h>

#include <utility>

namespace {

constexpr int kMaxR = 8;
constexpr int kBX = 32;
constexpr int kBY = 8;

// what one forward step writes besides the new field
constexpr int kRec = 1;    // the receiver rows of u
constexpr int kHist = 2;   // the d2u/dt2 value of the step
constexpr int kIllum = 4;  // the illumination sum (steps t < nsteps)
constexpr int kCkpt = 8;   // the (u, u_prev) pair when t is a segment start

struct Stencil {
  float w[kMaxR + 1];
  float inv_h2x;
  float inv_h2z;
};

// Laplacian of one shot's field u (nz, nx) at (z, x), dt^2 folded into the
// per-axis scales.
template <int R, bool FS>
__device__ __forceinline__ float laplacian(const float* __restrict__ u, int z,
                                           int x, int nz, int nx,
                                           const Stencil& s) {
  const size_t row = (size_t)z * nx;
  const float c = u[row + x];
  float accx = s.w[0] * c;
#pragma unroll
  for (int k = 1; k <= R; ++k) {
    const float sp = (x + k < nx) ? u[row + x + k] : 0.0f;
    const float sm = (x - k >= 0) ? u[row + x - k] : 0.0f;
    accx = accx + s.w[k] * (sp + sm);
  }
  float accz = s.w[0] * c;
  if (FS && z <= R) {
    // free-surface rows: plain +k term, then the odd mirror (zero at z = 0)
#pragma unroll
    for (int k = 1; k <= R; ++k) {
      const float up = (z + k < nz) ? u[(size_t)(z + k) * nx + x] : 0.0f;
      accz = accz + s.w[k] * up;
      const int i = z - k;
      if (i > 0) {
        accz = accz + s.w[k] * u[(size_t)i * nx + x];
      } else if (i < 0) {
        accz = accz - s.w[k] * u[(size_t)(-i) * nx + x];
      }
    }
  } else {
#pragma unroll
    for (int k = 1; k <= R; ++k) {
      const float sp = (z + k < nz) ? u[(size_t)(z + k) * nx + x] : 0.0f;
      const float sm = (z - k >= 0) ? u[(size_t)(z - k) * nx + x] : 0.0f;
      accz = accz + s.w[k] * (sp + sm);
    }
  }
  return accx * s.inv_h2x + accz * s.inv_h2z;
}

// Laplacian at c, a cell of a tile in shared memory with rows of S floats
// and zeros beyond the grid, whose global row is z: the association of
// laplacian() term for term.
template <int R, bool FS>
__device__ __forceinline__ float laplacian_tile(const float* c, int S, int z,
                                                const Stencil& s) {
  const float v = c[0];
  float accx = s.w[0] * v;
#pragma unroll
  for (int k = 1; k <= R; ++k) accx = accx + s.w[k] * (c[k] + c[-k]);
  float accz = s.w[0] * v;
  if (FS && z <= R) {
    // free-surface rows: plain +k term, then the odd mirror (zero at z = 0)
#pragma unroll
    for (int k = 1; k <= R; ++k) {
      accz = accz + s.w[k] * c[k * S];
      const int i = z - k;
      if (i > 0) {
        accz = accz + s.w[k] * c[-k * S];
      } else if (i < 0) {
        accz = accz - s.w[k] * c[(k - 2 * z) * S];  // row -i
      }
    }
  } else {
#pragma unroll
    for (int k = 1; k <= R; ++k)
      accz = accz + s.w[k] * (c[k * S] + c[-k * S]);
  }
  return accx * s.inv_h2x + accz * s.inv_h2z;
}

// The fused forward's tile (forward_tile): kTX x kTZ cells of one shot,
// kThreads threads, kSteps steps a launch. The shot is blockIdx.x.
constexpr int kTX = 32;
constexpr int kTZ = 32;
constexpr int kThreads = 512;
constexpr int kSteps = 2;
constexpr int kCells = kTX * kTZ / kThreads;
static_assert(kTX * kTZ % kThreads == 0, "whole cells a thread");

// Shared memory of a STEPS-step launch: u on the tile and a STEPS * R halo
// (its corners past (STEPS - 1) * R along both axes are never read) and,
// with two steps, step t's field on the tile and an R halo (corners unread).
template <int R, int STEPS>
struct FwdTile {
  static constexpr int H = STEPS * R;      // u's halo
  static constexpr int E = H - R;          // step t's halo
  static constexpr int SX = kTX + 2 * H;   // u: SZ rows x SX
  static constexpr int SZ = kTZ + 2 * H;
  static constexpr int NX = kTX + 2 * R;   // step t: NZ rows x NX
  static constexpr int NZ = kTZ + 2 * R;
  static constexpr int kRing = 2 * R * (kTX + kTZ);   // step t's halo cells
  static constexpr int kFloats = SX * SZ + (STEPS == 2 ? NX * NZ : 0);
  static constexpr size_t kBytes = kFloats * sizeof(float);
};
static_assert(FwdTile<kMaxR, 2>::kBytes <= 48 * 1024, "static shared memory");

// v plus the source of the shot at its cell, if the cell is one of the
// shot's source cells (src: the launch holds one)
__device__ __forceinline__ float add_source(float v, bool src, int cell,
                                           const int* __restrict__ cells,
                                           const float* __restrict__ vals,
                                           int K, float wt) {
  if (src) {
    for (int j = 0; j < K; ++j)
      if (cells[j] == cell) v = v + wt * vals[j];
  }
  return v;
}

// Ring cell j of a tile's R halo in the NX x NZ region of a step's field on
// the tile and that halo (R rows above and below the tile, then R columns
// left and right): its coordinates (lx, lz) there.
template <int R>
__device__ __forceinline__ void ring_cell(int j, int* lx, int* lz) {
  if (j < 2 * R * kTX) {
    const int row = j / kTX;
    *lx = R + j % kTX;
    *lz = row < R ? row : kTZ + row;
  } else {
    const int j2 = j - 2 * R * kTX;
    const int col = j2 % (2 * R);
    *lx = col < R ? col : kTX + col;
    *lz = R + j2 / (2 * R);
  }
}

// One shot's field ub on the tile at (xt, zt) and its STEPS * R halo into
// su (FwdTile's SZ rows x SX), zero beyond the grid and in the corners
// never read; all of a thread's loads first.
template <int R, int STEPS>
__device__ __forceinline__ void load_halo(float* su,
                                          const float* __restrict__ ub,
                                          int xt, int zt, int nz, int nx) {
  using T = FwdTile<R, STEPS>;
  constexpr int H = T::H;
  constexpr int E = T::E;
  constexpr int SX = T::SX;
  constexpr int kN1 = (SX * T::SZ + kThreads - 1) / kThreads;
  const int tid = threadIdx.x;
  float uv[kN1];
#pragma unroll
  for (int i = 0; i < kN1; ++i) {
    const int k = tid + i * kThreads;
    const int lx = k % SX;
    const int lz = k / SX;
    const int dx = lx < H ? H - lx : (lx >= H + kTX ? lx - H - kTX + 1 : 0);
    const int dz = lz < H ? H - lz : (lz >= H + kTZ ? lz - H - kTZ + 1 : 0);
    const int gx = xt - H + lx;
    const int gz = zt - H + lz;
    const bool in = k < SX * T::SZ && !(dx > E && dz > E) && gx >= 0 &&
                    gx < nx && gz >= 0 && gz < nz;
    uv[i] = in ? ub[(size_t)gz * nx + gx] : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < kN1; ++i) {
    const int k = tid + i * kThreads;
    if (k < SX * T::SZ) su[k] = uv[i];
  }
}

// Steps t .. t + STEPS - 1 over one tile of one shot. Reads u (with its
// halo) and up; with two steps writes step t's field to nup and step
// t + 1's to nu (neither is u or up, which neighbouring tiles read), with
// one step its field to nu, which may be up (each cell reads its own up
// before writing it, and nothing else reads up). At the tile's own cells,
// for each step: the receiver rows of u before the step, and what FLAGS
// asks for (the history value at (b, t) of a (B, total, nz, nx) buffer, the
// illumination for t < nsteps, the segment-start pair).
template <int R, bool FS, int FLAGS, int STEPS>
__global__ void __launch_bounds__(kThreads)
forward_tile(const float* __restrict__ u, const float* up, float* nu,
             float* nup, const float* __restrict__ m,
             const float* __restrict__ two_m_hd,
             const float* __restrict__ denom, const float* __restrict__ wav,
             const int* __restrict__ src_cell,
             const float* __restrict__ src_val, int K,
             float* __restrict__ rec, float* __restrict__ dt2,
             float* __restrict__ illum, float* __restrict__ ckpt, int t,
             int total, int nsteps, int seg, int nseg, int nz, int nx,
             int z0, Stencil s) {
  using T = FwdTile<R, STEPS>;
  constexpr int H = T::H;
  constexpr int E = T::E;
  constexpr int SX = T::SX;
  constexpr int NX = T::NX;
  __shared__ float smem[T::kFloats];
  float* su = smem;                   // u
  float* sn = smem + SX * T::SZ;      // step t (two steps)
  const int b = blockIdx.x;           // the shots of a tile adjoin
  const int xt = blockIdx.y * kTX;
  const int zt = blockIdx.z * kTZ;
  const int tid = threadIdx.x;
  const size_t field = (size_t)nz * nx;
  const size_t off = (size_t)b * field;
  const float* ub = u + off;
  const int* cells_b = src_cell + (size_t)b * K;
  const float* vals_b = src_val + (size_t)b * K;

  // 0. the operands of the cells this thread updates, read first: their
  // latency hides under phase 1. The tile's own cells (kCells a thread),
  // and with two steps the ring of step t's halo.
  float upv[kCells], mv[kCells], av[kCells], dv[kCells], il[kCells];
#pragma unroll
  for (int i = 0; i < kCells; ++i) {
    const int k = tid + i * kThreads;
    const int gx = xt + k % kTX;
    const int gz = zt + k / kTX;
    const bool in = gx < nx && gz < nz;
    const size_t cell = (size_t)gz * nx + gx;
    upv[i] = in ? up[off + cell] : 0.0f;
    mv[i] = in ? m[cell] : 0.0f;
    av[i] = in ? two_m_hd[cell] : 0.0f;
    dv[i] = in ? denom[cell] : 0.0f;
    il[i] = (FLAGS & kIllum) && in && t < nsteps ? illum[off + cell] : 0.0f;
  }
  constexpr int kNR = STEPS == 2 ? (T::kRing + kThreads - 1) / kThreads : 0;
  int rx[kNR > 0 ? kNR : 1], rz[kNR > 0 ? kNR : 1];
  float rup[kNR > 0 ? kNR : 1], rm[kNR > 0 ? kNR : 1],
      ra[kNR > 0 ? kNR : 1], rd[kNR > 0 ? kNR : 1];
#pragma unroll
  for (int i = 0; i < kNR; ++i) {
    // ring cell j in step t's coordinates (lx, lz) of the NX x NZ region:
    // R rows above and below the tile, then R columns left and right
    const int j = tid + i * kThreads;
    int lx, lz;
    ring_cell<R>(j, &lx, &lz);
    rx[i] = lx;
    rz[i] = lz;
    const int gx = xt - R + lx;
    const int gz = zt - R + lz;
    const bool in =
        j < T::kRing && gx >= 0 && gx < nx && gz >= 0 && gz < nz;
    const size_t cell = (size_t)gz * nx + gx;
    rup[i] = in ? up[off + cell] : 0.0f;
    rm[i] = in ? m[cell] : 0.0f;
    ra[i] = in ? two_m_hd[cell] : 0.0f;
    rd[i] = in ? denom[cell] : 0.0f;
  }

  // does a source cell of the shot fall among the cells this launch
  // updates (the tile and step t's halo)? Most tiles hold none.
  bool mine = false;
  for (int j = tid; j < K; j += kThreads) {
    const int c = cells_b[j];
    if (c >= 0) {
      const int cz = c / nx;
      const int cx = c - cz * nx;
      mine = mine || (cz >= zt - E && cz < zt + kTZ + E && cx >= xt - E &&
                      cx < xt + kTX + E);
    }
  }

  // 1. u on the tile and its halo
  load_halo<R, STEPS>(su, ub, xt, zt, nz, nx);
  const bool src = __syncthreads_or(mine);

  // 2. with two steps: step t on the tile (kept in registers for phase 3)
  // and on the ring of its R halo, into shared memory; zero beyond the grid
  float unv[kCells], ucv[kCells];
  if (STEPS == 2) {
    const float wt = wav[t];
#pragma unroll
    for (int i = 0; i < kCells; ++i) {
      const int k = tid + i * kThreads;
      const int tx = k % kTX;
      const int tz = k / kTX;
      const int gx = xt + tx;
      const int gz = zt + tz;
      const float* c = su + (tz + H) * SX + tx + H;
      ucv[i] = c[0];
      float v = 0.0f;
      if (gx < nx && gz < nz) {
        v = (laplacian_tile<R, FS>(c, SX, gz, s) + av[i] * ucv[i] -
             mv[i] * upv[i]) *
            dv[i];
        v = add_source(v, src, gz * nx + gx, cells_b, vals_b, K, wt);
      }
      unv[i] = v;
      sn[(tz + R) * NX + tx + R] = v;
    }
#pragma unroll
    for (int i = 0; i < kNR; ++i) {
      const int j = tid + i * kThreads;
      if (j >= T::kRing) continue;
      const int lx = rx[i];
      const int lz = rz[i];
      const int gx = xt - R + lx;
      const int gz = zt - R + lz;
      float v = 0.0f;
      if (gx >= 0 && gx < nx && gz >= 0 && gz < nz) {
        const float* c = su + (lz + R) * SX + lx + R;
        v = (laplacian_tile<R, FS>(c, SX, gz, s) + ra[i] * c[0] -
             rm[i] * rup[i]) *
            rd[i];
        v = add_source(v, src, gz * nx + gx, cells_b, vals_b, K, wt);
      }
      sn[lz * NX + lx] = v;
    }
    __syncthreads();
  }

  // 3. the tile's own cells: step t's outputs, with two steps step t + 1
  // from step t's field in shared memory
  const size_t bt = (size_t)b * total + t;
#pragma unroll
  for (int i = 0; i < kCells; ++i) {
    const int k = tid + i * kThreads;
    const int tx = k % kTX;
    const int tz = k / kTX;
    const int gx = xt + tx;
    const int gz = zt + tz;
    if (gx >= nx || gz >= nz) continue;
    const int cell = gz * nx + gx;
    const size_t o = off + cell;
    const bool row = gz == z0 || gz == z0 + 1;
    float uc, un;
    if (STEPS == 2) {
      uc = ucv[i];
      un = unv[i];
    } else {
      const float* c = su + (tz + H) * SX + tx + H;
      uc = c[0];
      un = (laplacian_tile<R, FS>(c, SX, gz, s) + av[i] * uc -
            mv[i] * upv[i]) *
           dv[i];
      un = add_source(un, src, cell, cells_b, vals_b, K, wav[t]);
    }
    float ilv = il[i];
    if ((FLAGS & kRec) && row) rec[(bt * 2 + (gz - z0)) * nx + gx] = uc;
    if ((FLAGS & kCkpt) && t % seg == 0) {
      const size_t pair = ((size_t)b * nseg + t / seg) * 2 * field + cell;
      ckpt[pair] = uc;
      ckpt[pair + field] = upv[i];
    }
    if (FLAGS & kHist) dt2[bt * field + cell] = un - 2.0f * uc + upv[i];
    if ((FLAGS & kIllum) && t < nsteps) ilv = ilv + un * un;
    if (STEPS == 2) {
      const int t1 = t + 1;
      const float* c = sn + (tz + R) * NX + tx + R;
      float unn =
          (laplacian_tile<R, FS>(c, NX, gz, s) + av[i] * un - mv[i] * uc) *
          dv[i];
      unn = add_source(unn, src, cell, cells_b, vals_b, K, wav[t1]);
      if ((FLAGS & kRec) && row)
        rec[((bt + 1) * 2 + (gz - z0)) * nx + gx] = un;
      if ((FLAGS & kCkpt) && t1 % seg == 0) {
        const size_t pair = ((size_t)b * nseg + t1 / seg) * 2 * field + cell;
        ckpt[pair] = un;
        ckpt[pair + field] = uc;
      }
      if (FLAGS & kHist) dt2[(bt + 1) * field + cell] = unn - 2.0f * un + uc;
      if ((FLAGS & kIllum) && t1 < nsteps) ilv = ilv + unn * unn;
      nup[o] = un;
      nu[o] = unn;
    } else {
      nu[o] = un;
    }
    if ((FLAGS & kIllum) && t < nsteps) illum[o] = ilv;
  }
}

// One reverse step for all shots, one thread a cell (blockIdx.z the shot):
// grad += dt2[b, th] * v (history of ht steps; times scale when last, the
// sweep's final step), vn <- v_new (in place) with the residual rows of
// step t added on z0 and z0 + 1.
template <int R, bool FS>
__global__ void adjoint_step(const float* __restrict__ v,
                             float* __restrict__ vn,
                             const float* __restrict__ m,
                             const float* __restrict__ two_m_hd,
                             const float* __restrict__ denom,
                             const float* __restrict__ dt2,
                             const float* __restrict__ res,
                             float* __restrict__ grad, int th, int ht, int t,
                             int total, int nz, int nx, int z0, int last,
                             float scale, Stencil s) {
  const int x = blockIdx.x * kBX + threadIdx.x;
  const int z = blockIdx.y * kBY + threadIdx.y;
  const int b = blockIdx.z;
  if (x >= nx || z >= nz) return;
  const size_t field = (size_t)nz * nx;
  const size_t cell = (size_t)z * nx + x;
  const size_t bt = (size_t)b * total + t;
  const float* vb = v + (size_t)b * field;
  const size_t o = (size_t)b * field + cell;

  const float vc = vb[cell];
  const float g =
      grad[o] + __ldcs(dt2 + ((size_t)b * ht + th) * field + cell) * vc;
  grad[o] = last ? g * scale : g;
  const float lap = laplacian<R, FS>(vb, z, x, nz, nx, s);
  float vnew = (lap + two_m_hd[cell] * vc - m[cell] * vn[o]) * denom[cell];
  if (z == z0 || z == z0 + 1) vnew = vnew + res[(bt * 2 + (z - z0)) * nx + x];
  vn[o] = vnew;
}

// Reverse steps t and t - 1 over one tile of one shot: the forwards'
// two-step tile in reverse. v with a 2R halo in shared memory, step t on
// the tile (kept in registers) and an R halo (into shared memory, the
// residual rows of step t added there too), then step t - 1 on the tile;
// grad gains both steps' terms in registers. Reads v (with its halo) and
// vn; writes step t's field to nvn and step t - 1's to nv (neither is v or
// vn, which neighbouring tiles read). With last, step t - 1 is the sweep's
// final one.
template <int R, bool FS>
__global__ void __launch_bounds__(kThreads)
adjoint_tile(const float* __restrict__ v, const float* __restrict__ vn,
             float* __restrict__ nv, float* __restrict__ nvn,
             const float* __restrict__ m, const float* __restrict__ two_m_hd,
             const float* __restrict__ denom, const float* __restrict__ dt2,
             const float* __restrict__ res, float* __restrict__ grad, int t,
             int t0, int ht, int total, int nz, int nx, int z0, int last,
             float scale, Stencil s) {
  using T = FwdTile<R, 2>;
  constexpr int H = T::H;
  constexpr int SX = T::SX;
  constexpr int NX = T::NX;
  constexpr int kNR = (T::kRing + kThreads - 1) / kThreads;
  __shared__ float smem[T::kFloats];
  float* sv = smem;                   // v
  float* sn = smem + SX * T::SZ;      // step t
  const int b = blockIdx.x;           // the shots of a tile adjoin
  const int xt = blockIdx.y * kTX;
  const int zt = blockIdx.z * kTZ;
  const int tid = threadIdx.x;
  const size_t field = (size_t)nz * nx;
  const size_t off = (size_t)b * field;
  const float* h0 = dt2 + ((size_t)b * ht + (t - t0)) * field;  // step t
  const float* h1 = h0 - field;                                  // step t-1
  const float* r0 = res + ((size_t)b * total + t) * 2 * nx;
  const float* r1 = r0 - 2 * nx;

  // 0. the operands of the cells this thread updates, read first: the
  // tile's own cells (kCells a thread) and the ring of step t's halo
  float vnv[kCells], mv[kCells], av[kCells], dv[kCells], gr[kCells],
      ha[kCells], hb[kCells];
#pragma unroll
  for (int i = 0; i < kCells; ++i) {
    const int k = tid + i * kThreads;
    const int gx = xt + k % kTX;
    const int gz = zt + k / kTX;
    const bool in = gx < nx && gz < nz;
    const size_t cell = (size_t)gz * nx + gx;
    vnv[i] = in ? vn[off + cell] : 0.0f;
    mv[i] = in ? m[cell] : 0.0f;
    av[i] = in ? two_m_hd[cell] : 0.0f;
    dv[i] = in ? denom[cell] : 0.0f;
    gr[i] = in ? grad[off + cell] : 0.0f;
    ha[i] = in ? __ldcs(h0 + cell) : 0.0f;
    hb[i] = in ? __ldcs(h1 + cell) : 0.0f;
  }
  int rx[kNR], rz[kNR];
  float rvn[kNR], rm[kNR], ra[kNR], rd[kNR];
#pragma unroll
  for (int i = 0; i < kNR; ++i) {
    const int j = tid + i * kThreads;
    int lx, lz;
    ring_cell<R>(j, &lx, &lz);
    rx[i] = lx;
    rz[i] = lz;
    const int gx = xt - R + lx;
    const int gz = zt - R + lz;
    const bool in =
        j < T::kRing && gx >= 0 && gx < nx && gz >= 0 && gz < nz;
    const size_t cell = (size_t)gz * nx + gx;
    rvn[i] = in ? vn[off + cell] : 0.0f;
    rm[i] = in ? m[cell] : 0.0f;
    ra[i] = in ? two_m_hd[cell] : 0.0f;
    rd[i] = in ? denom[cell] : 0.0f;
  }

  // 1. v on the tile and its 2R halo
  load_halo<R, 2>(sv, v + off, xt, zt, nz, nx);
  __syncthreads();

  // 2. step t on the tile (kept in registers) and on the ring of its R
  // halo, into shared memory; zero beyond the grid
  float vc[kCells], va[kCells];
#pragma unroll
  for (int i = 0; i < kCells; ++i) {
    const int k = tid + i * kThreads;
    const int tx = k % kTX;
    const int tz = k / kTX;
    const int gx = xt + tx;
    const int gz = zt + tz;
    const float* c = sv + (tz + H) * SX + tx + H;
    vc[i] = c[0];
    float w = 0.0f;
    if (gx < nx && gz < nz) {
      w = (laplacian_tile<R, FS>(c, SX, gz, s) + av[i] * vc[i] -
           mv[i] * vnv[i]) *
          dv[i];
      if (gz == z0 || gz == z0 + 1) w = w + r0[(gz - z0) * nx + gx];
    }
    va[i] = w;
    sn[(tz + R) * NX + tx + R] = w;
  }
#pragma unroll
  for (int i = 0; i < kNR; ++i) {
    const int j = tid + i * kThreads;
    if (j >= T::kRing) continue;
    const int lx = rx[i];
    const int lz = rz[i];
    const int gx = xt - R + lx;
    const int gz = zt - R + lz;
    float w = 0.0f;
    if (gx >= 0 && gx < nx && gz >= 0 && gz < nz) {
      const float* c = sv + (lz + R) * SX + lx + R;
      w = (laplacian_tile<R, FS>(c, SX, gz, s) + ra[i] * c[0] -
           rm[i] * rvn[i]) *
          rd[i];
      if (gz == z0 || gz == z0 + 1) w = w + r0[(gz - z0) * nx + gx];
    }
    sn[lz * NX + lx] = w;
  }
  __syncthreads();

  // 3. the tile's own cells: both steps' gradient terms, step t - 1 from
  // step t's field in shared memory
#pragma unroll
  for (int i = 0; i < kCells; ++i) {
    const int k = tid + i * kThreads;
    const int tx = k % kTX;
    const int tz = k / kTX;
    const int gx = xt + tx;
    const int gz = zt + tz;
    if (gx >= nx || gz >= nz) continue;
    const size_t o = off + (size_t)gz * nx + gx;
    float g = gr[i] + ha[i] * vc[i];
    g = g + hb[i] * va[i];
    const float* c = sn + (tz + R) * NX + tx + R;
    float w = (laplacian_tile<R, FS>(c, NX, gz, s) + av[i] * va[i] -
               mv[i] * vc[i]) *
              dv[i];
    if (gz == z0 || gz == z0 + 1) w = w + r1[(gz - z0) * nx + gx];
    grad[o] = last ? g * scale : g;
    nvn[o] = va[i];
    nv[o] = w;
  }
}

// u, up <- the saved pair of segment k of every shot.
__global__ void load_pair(const float* __restrict__ ckpt,
                          float* __restrict__ u, float* __restrict__ up,
                          int nseg, int k, size_t field, size_t n) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const size_t b = i / field;
  const float* pair = ckpt + ((size_t)b * nseg + k) * 2 * field + i % field;
  u[i] = pair[0];
  up[i] = pair[field];
}

Stencil make_stencil(const float* w, int r, float inv_h2x, float inv_h2z) {
  Stencil s = {};
  for (int k = 0; k <= r; ++k) s.w[k] = w[k];
  s.inv_h2x = inv_h2x;
  s.inv_h2z = inv_h2z;
  return s;
}

struct ForwardArgs {
  const float *m, *two_m_hd, *denom, *wav;
  const int* src_cell;
  const float* src_val;
  float *rec, *dt2, *illum, *ckpt, *state;
  int K, B, nz, nx, total, nsteps, seg, nseg, z0;
  Stencil s;
  cudaStream_t stream;
};

template <int R, bool FS, int FLAGS, int STEPS>
int launch_tile(const ForwardArgs& a, const float* u, const float* up,
                float* nu, float* nup, const float* wav, float* dt2, int t,
                int total) {
  const dim3 grid(a.B, (a.nx + kTX - 1) / kTX, (a.nz + kTZ - 1) / kTZ);
  forward_tile<R, FS, FLAGS, STEPS><<<grid, kThreads, 0, a.stream>>>(
      u, up, nu, nup, a.m, a.two_m_hd, a.denom, wav, a.src_cell, a.src_val,
      a.K, a.rec, dt2, a.illum, a.ckpt, t, total, a.nsteps, a.seg, a.nseg,
      a.nz, a.nx, a.z0, a.s);
  return (int)cudaGetLastError();
}

// Steps t = 0 .. nt-1 of a forward from the state in a.state's first two
// (B, nz, nx) fields (u, up), the other two spare; the wavelet, history and
// step count come from the arguments, so the recompute of one segment is
// this loop over its own slice. kSteps steps a launch: the two new fields
// go to the spare pair, the old pair becomes the spare one; an odd last
// step is one single-step launch in place.
template <int R, bool FS, int FLAGS>
int forward_steps(const ForwardArgs& a, const float* wav, float* dt2,
                  int total, int nt) {
  const size_t n = (size_t)a.B * a.nz * a.nx;
  float* u = a.state;
  float* up = a.state + n;
  float* s0 = a.state + 2 * n;
  float* s1 = a.state + 3 * n;
  int t = 0;
  if (kSteps == 2) {
    for (; t + 2 <= nt; t += 2) {
      const int err = launch_tile<R, FS, FLAGS, 2>(a, u, up, s1, s0, wav,
                                                   dt2, t, total);
      if (err) return err;
      float* o0 = u;
      float* o1 = up;
      u = s1;
      up = s0;
      s0 = o0;
      s1 = o1;
    }
  }
  for (; t < nt; ++t) {
    const int err =
        launch_tile<R, FS, FLAGS, 1>(a, u, up, up, nullptr, wav, dt2, t,
                                     total);
    if (err) return err;
    float* tmp = u;
    u = up;
    up = tmp;
  }
  return 0;
}

template <int R, bool FS, int FLAGS>
int run_forward(const ForwardArgs& a) {
  const cudaError_t err = cudaMemsetAsync(
      a.state, 0, 2 * (size_t)a.B * a.nz * a.nx * sizeof(float), a.stream);
  if (err != cudaSuccess) return (int)err;
  return forward_steps<R, FS, FLAGS>(a, a.wav, a.dt2, a.total, a.total);
}

struct AdjointArgs {
  const float *m, *two_m_hd, *denom, *dt2, *res;
  float *grad;
  float *v, *vn, *s0, *s1;         // the adjoint pair and a spare pair
  int B, nz, nx, total, nsteps, z0;
  float neg_inv_s2;
  Stencil s;
  cudaStream_t stream;
  // checkpoint route only: forward operands and the segment layout
  const float *wav, *src_val, *ckpt;
  const int* src_cell;
  float* state;
  int K, seg, nseg;
};

template <int R, bool FS>
int launch_step(const AdjointArgs& a, const float* dt2, int t0, int ht, int t,
                bool end) {
  const dim3 block(kBX, kBY);
  const dim3 grid((a.nx + kBX - 1) / kBX, (a.nz + kBY - 1) / kBY, a.B);
  adjoint_step<R, FS><<<grid, block, 0, a.stream>>>(
      a.v, a.vn, a.m, a.two_m_hd, a.denom, dt2, a.res, a.grad, t - t0, ht,
      t, a.total, a.nz, a.nx, a.z0, end, a.neg_inv_s2, a.s);
  return (int)cudaGetLastError();
}

// Reverse steps t = hi-1 .. lo over a history whose step t sits at
// th = t - t0 of ht steps, two a launch of adjoint_tile and an odd last
// one by adjoint_step; with last, step lo is the sweep's final one (grad
// scaled by -1/s^2 there). The adjoint pair (a.v, a.vn) and the spare pair
// are left as the steps leave them, so a later call continues the sweep.
template <int R, bool FS>
int adjoint_steps(AdjointArgs& a, const float* dt2, int t0, int ht, int lo,
                  int hi, bool last) {
  int t = hi - 1;
  const dim3 grid(a.B, (a.nx + kTX - 1) / kTX, (a.nz + kTZ - 1) / kTZ);
  for (; t - 1 >= lo; t -= 2) {
    adjoint_tile<R, FS><<<grid, kThreads, 0, a.stream>>>(
        a.v, a.vn, a.s1, a.s0, a.m, a.two_m_hd, a.denom, dt2, a.res, a.grad,
        t, t0, ht, a.total, a.nz, a.nx, a.z0, last && t - 1 == lo,
        a.neg_inv_s2, a.s);
    const int err = (int)cudaGetLastError();
    if (err) return err;
    float* o0 = a.v;
    float* o1 = a.vn;
    a.v = a.s1;
    a.vn = a.s0;
    a.s0 = o0;
    a.s1 = o1;
  }
  // an odd last step
  if (t >= lo) {
    const int err = launch_step<R, FS>(a, dt2, t0, ht, t, last && t == lo);
    if (err) return err;
    std::swap(a.v, a.vn);
  }
  return 0;
}

template <int R, bool FS>
int run_adjoint(AdjointArgs a) {
  // padded tail steps (t >= nsteps) are skipped in reverse
  return adjoint_steps<R, FS>(a, a.dt2, 0, a.total, 0, a.nsteps, true);
}

template <int R, bool FS>
int run_gradient_segments(AdjointArgs a) {
  // a.dt2 is the (B, seg, nz, nx) scratch of one segment
  ForwardArgs f = {};
  f.m = a.m;
  f.two_m_hd = a.two_m_hd;
  f.denom = a.denom;
  f.src_cell = a.src_cell;
  f.src_val = a.src_val;
  f.state = a.state;
  f.K = a.K;
  f.B = a.B;
  f.nz = a.nz;
  f.nx = a.nx;
  f.total = a.total;
  f.nsteps = a.nsteps;
  f.seg = a.seg;
  f.nseg = a.nseg;
  f.z0 = a.z0;
  f.s = a.s;
  f.stream = a.stream;
  const size_t field = (size_t)a.nz * a.nx;
  const size_t n = (size_t)a.B * field;
  const int threads = 256;
  float* scratch = const_cast<float*>(a.dt2);
  for (int k = a.nseg - 1; k >= 0; --k) {
    const int base = k * a.seg;
    load_pair<<<(unsigned)((n + threads - 1) / threads), threads, 0,
                a.stream>>>(a.ckpt, a.state, a.state + n, a.nseg, k, field,
                            n);
    int err = (int)cudaGetLastError();
    if (err) return err;
    err = forward_steps<R, FS, kHist>(f, a.wav + base, scratch, a.seg, a.seg);
    if (err) return err;
    const int hi = base + a.seg < a.nsteps ? base + a.seg : a.nsteps;
    err = adjoint_steps<R, FS>(a, scratch, base, a.seg, base, hi, k == 0);
    if (err) return err;
  }
  return 0;
}

// Dispatch the runtime radius onto the unrolled instantiations.
template <template <int, bool, int> class F, bool FS, int FLAGS, class A>
int dispatch_r(int r, const A& a) {
  switch (r) {
    case 1: return F<1, FS, FLAGS>::run(a);
    case 2: return F<2, FS, FLAGS>::run(a);
    case 3: return F<3, FS, FLAGS>::run(a);
    case 4: return F<4, FS, FLAGS>::run(a);
    case 5: return F<5, FS, FLAGS>::run(a);
    case 6: return F<6, FS, FLAGS>::run(a);
    case 7: return F<7, FS, FLAGS>::run(a);
    case 8: return F<8, FS, FLAGS>::run(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int R, bool FS, int FLAGS>
struct Fwd {
  static int run(const ForwardArgs& a) { return run_forward<R, FS, FLAGS>(a); }
};

template <int R, bool FS, int FLAGS>
struct Adj {
  static int run(const AdjointArgs& a) { return run_adjoint<R, FS>(a); }
};

template <int R, bool FS, int FLAGS>
struct Seg {
  static int run(const AdjointArgs& a) {
    return run_gradient_segments<R, FS>(a);
  }
};

template <int FLAGS>
int dispatch_forward(int fs, int r, const ForwardArgs& a) {
  return fs ? dispatch_r<Fwd, true, FLAGS>(r, a)
            : dispatch_r<Fwd, false, FLAGS>(r, a);
}

// What the fused tiles take: a positive grid of fewer than 2^31 cells a
// shot, at most (2^31 - 1, 65535, 65535) blocks, and at least one source
// slot a shot (the reverse sweeps ask with K = 1).
bool tile_shape_ok(int r, int K, int B, int nz, int nx) {
  return r >= 1 && r <= kMaxR && K >= 1 && B >= 1 && nz >= 1 && nx >= 1 &&
         (long long)nz * nx < (1LL << 31) && (nx + kTX - 1) / kTX <= 65535 &&
         (nz + kTZ - 1) / kTZ <= 65535;
}

// Sets the adjoint pair and the spare pair from adj, 4 (B, nz, nx) fields.
void set_adjoint_fields(AdjointArgs* a, float* adj) {
  const size_t n = (size_t)a->B * a->nz * a->nx;
  a->v = adj;
  a->vn = adj + n;
  a->s0 = adj + 2 * n;
  a->s1 = adj + 3 * n;
}

}  // namespace

extern "C" {

// Forward sweep over t = 0 .. total-1 from zero fields. dt2 and ckpt may
// not both be set; illum is set exactly when one of them is (history or
// checkpoint sweep) and holds zeros on entry. ckpt is (B, nseg, 2, nz, nx)
// with nseg * seg == total. The source pattern (B, nz, nx) comes as its
// non-zero cells: src_cell (B, K) int32 z * nx + x (-1 pads) and src_val
// (B, K) their values. state is 4 (B, nz, nx) scratch fields (the sweep
// zeroes the first two). Returns the first CUDA error of a launch, or 0.
int acoustic2d_forward(const float* m, const float* two_m_hd,
                       const float* denom, const float* wav,
                       const int* src_cell, const float* src_val, int K,
                       float* rec, float* dt2, float* illum, float* ckpt,
                       float* state, int B, int nz, int nx, int total,
                       int nsteps, int seg, int z0, int fs, int r,
                       const float* w, float inv_h2x, float inv_h2z,
                       void* stream) {
  if (!tile_shape_ok(r, K, B, nz, nx) || (dt2 != NULL && ckpt != NULL) ||
      (illum != NULL) != (dt2 != NULL || ckpt != NULL) || seg < 1 ||
      total % seg != 0)
    return (int)cudaErrorInvalidValue;
  ForwardArgs a = {};
  a.m = m;
  a.two_m_hd = two_m_hd;
  a.denom = denom;
  a.wav = wav;
  a.src_cell = src_cell;
  a.src_val = src_val;
  a.rec = rec;
  a.dt2 = dt2;
  a.illum = illum;
  a.ckpt = ckpt;
  a.state = state;
  a.K = K;
  a.B = B;
  a.nz = nz;
  a.nx = nx;
  a.total = total;
  a.nsteps = nsteps;
  a.seg = seg;
  a.nseg = total / seg;
  a.z0 = z0;
  a.s = make_stencil(w, r, inv_h2x, inv_h2z);
  a.stream = (cudaStream_t)stream;
  if (dt2 != NULL) return dispatch_forward<kRec | kHist | kIllum>(fs, r, a);
  if (ckpt != NULL) return dispatch_forward<kRec | kIllum | kCkpt>(fs, r, a);
  return dispatch_forward<kRec>(fs, r, a);
}

// Reverse sweep over t = nsteps-1 .. 0, grad scaled by neg_inv_s2 at the
// last step. grad (B, nz, nx) holds zeros on entry; adj is 4 (B, nz, nx)
// fields, the adjoint pair v, vn (zeros on entry) and a spare pair.
int acoustic2d_adjoint(const float* m, const float* two_m_hd,
                       const float* denom, const float* dt2, const float* res,
                       float* grad, float* adj, int B, int nz, int nx,
                       int total, int nsteps, int z0, int fs, int r,
                       const float* w, float inv_h2x, float inv_h2z,
                       float neg_inv_s2, void* stream) {
  if (!tile_shape_ok(r, 1, B, nz, nx) || nsteps < 1 || nsteps > total)
    return (int)cudaErrorInvalidValue;
  AdjointArgs a = {};
  a.m = m;
  a.two_m_hd = two_m_hd;
  a.denom = denom;
  a.dt2 = dt2;
  a.res = res;
  a.grad = grad;
  a.B = B;
  a.nz = nz;
  a.nx = nx;
  set_adjoint_fields(&a, adj);
  a.total = total;
  a.nsteps = nsteps;
  a.z0 = z0;
  a.neg_inv_s2 = neg_inv_s2;
  a.s = make_stencil(w, r, inv_h2x, inv_h2z);
  a.stream = (cudaStream_t)stream;
  return fs ? dispatch_r<Adj, true, 0>(r, a) : dispatch_r<Adj, false, 0>(r, a);
}

// Checkpoint-and-recompute gradient: segments k = nseg-1 .. 0, each
// recomputed from ckpt[:, k] into scratch (B, seg, nz, nx), then reversed
// over its steps t < nsteps; grad scaled by neg_inv_s2 at the last step.
// grad and adj as in acoustic2d_adjoint; state is 4 (B, nz, nx) scratch
// fields; the source comes as in acoustic2d_forward.
int acoustic2d_gradient_segments(
    const float* m, const float* two_m_hd, const float* denom,
    const float* wav, const int* src_cell, const float* src_val, int K,
    const float* ckpt, const float* res, float* scratch, float* grad,
    float* adj, float* state, int B, int nz, int nx, int seg, int nseg,
    int nsteps, int z0, int fs, int r, const float* w, float inv_h2x,
    float inv_h2z, float neg_inv_s2, void* stream) {
  if (!tile_shape_ok(r, K, B, nz, nx) || seg < 1 || nseg < 1 ||
      nsteps < 1 || nsteps > seg * nseg)
    return (int)cudaErrorInvalidValue;
  AdjointArgs a = {};
  a.m = m;
  a.two_m_hd = two_m_hd;
  a.denom = denom;
  a.dt2 = scratch;
  a.res = res;
  a.grad = grad;
  a.B = B;
  a.nz = nz;
  a.nx = nx;
  set_adjoint_fields(&a, adj);
  a.total = seg * nseg;
  a.nsteps = nsteps;
  a.z0 = z0;
  a.neg_inv_s2 = neg_inv_s2;
  a.s = make_stencil(w, r, inv_h2x, inv_h2z);
  a.stream = (cudaStream_t)stream;
  a.wav = wav;
  a.src_cell = src_cell;
  a.src_val = src_val;
  a.K = K;
  a.ckpt = ckpt;
  a.state = state;
  a.seg = seg;
  a.nseg = nseg;
  return fs ? dispatch_r<Seg, true, 0>(r, a) : dispatch_r<Seg, false, 0>(r, a);
}

const char* acoustic2d_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
