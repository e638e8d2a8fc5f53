// 2-D viscoacoustic SLS 2nd-order sweeps for Hopper (sm_90a), plain C
// interface for ctypes. Two entry points, each one sweep over all time steps
// of a shot batch on the caller's stream, one fused launch a step
// (forward_step, adjoint_step):
//
//   visco2d_forward(..., hist = NULL, pout != NULL)
//       replaces _visco_sls2_segments (devito_fwi_tpu/ops/pallas_staggered.py
//       :395, _visco_sls2_kernel :304): forward modeling that records, at
//       every step, rows z0 and z0 + 1 of p before the update, and the p
//       field after step nsteps - 1. The TPU kernel is single-shot; this one
//       takes a shot batch.
//   visco2d_forward(..., hist != NULL)
//       replaces visco_fwd_hist_segments (pallas_staggered.py:924,
//       _visco_fwd_hist_kernel :841): the same forward, writing the history
//       (L, rn) of every step and the illumination sum of pn^2 over the
//       steps t < nsteps.
//   visco2d_adjoint
//       replaces visco_grad_stream_segments (pallas_staggered.py:1052,
//       _visco_grad_stream_kernel :953): the adjoint (lp, lpp, lr) recursion
//       walked from step nsteps-1 down to 0 over the history, with the
//       residual rows added to lp on rows z0 and z0 + 1; it accumulates the
//       images ga1..ga4 of the four coefficient fields and the dense source
//       cotangent gsrc.
//
// The update (L = sum_d D-_d(b D+_d p), the x term first):
//   rn = damp (r + A L - B r)
//   pn = damp (2 p - damp pp + C L - D rn) + wav[t] inj
// with A = s (tt/t_s) rho, B = s/t_s, C = s^2 bm (1+tt), D = s^2 vp^2
// precombined on the host. The reverse step, with P = damp lp and
// R = damp (lr - D P):
//   ga3 += L P;  ga4 -= rn P;  ga1 += L R;  ga2 -= rn pendR;
//   gsrc += (wavs2[t] injw) lp;
//   lp  <- 2 P + lsa(C P) + lsa(A R) + lpp (+ the residual rows)
//   lpp <- -damp P;  lr <- R - B R;  pendR <- R.
//
// Layout: fields are (B, nz, nx) float32 with x contiguous (the transposed
// layout of the JAX kernels); the six coefficient fields damp, b, A, B, C, D
// are (nz, nx) and shared by all shots; the source patterns inj
// (w dt^2 vp^2 at the source's corners) and injw (w) come as each shot's
// non-zero cells (src_cell, src_val); receiver and residual rows are
// (B, total, 2, nx); the history is (B, total, 2, nz, nx).
//
// What bounds it on the card: the history forward writes
// B * total * 2 * nz * nx * 4 bytes (21.9 GB for the 29-shot SMARMN batch)
// and the adjoint reads them back, so both are bound by device-memory
// bandwidth (about 6.5 ms each way at 3.35 TB/s); the modeling forward moves
// almost nothing and is bound by its ~80 float operations per cell and step
// (four eight-tap staggered derivatives and the update). But a field of the
// batch is 8.2 MB and the reverse's state and images are past the 50 MB
// L2, so a sweep's floor is its traffic a step through device memory.
//
// The forwards: the first design ran a step as two launches, one thread a
// cell: a flux launch wrote b D+x p and b D+z p to device memory and an
// update launch read them back at stencil distance, with the dense source
// pattern inj, which is non-zero at no more than four cells a shot: 11
// fields a step for the modeling sweep (3 and 8), 15 with the history (2
// more written and the illumination read and written), 36.0 and 49.0 ms
// over the 1336-step SMARMN sweep at 3.35 TB/s; it took 77.5 and 100.1 ms.
// The fused step (forward_step), one launch a step, a block a kFTX x kFTZ
// tile of one shot: it loads p on the tile and a 2R halo along each axis
// once, forms the two fluxes on the tile and an R halo along their axis in
// shared memory (the halo repeats the neighbours' arithmetic, so it rounds
// alike), then L, rn and pn on the tile. pn goes over pp and rn over r in
// place, since both are read only at the cell's own place; p and pp swap
// every step. The source adds only at inj's non-zero cells (adding wav * 0
// elsewhere changes no finite value). 5 fields a step (p, pp, r read, pn,
// rn written), 9 with the history: 16.3 and 29.4 ms over the sweep. pp, r
// and the illumination are read first, where their latency hides under
// the halo phases; the shots are the grid's fastest axis. Both derivatives
// see zeros beyond the padded grid: the inner one reads zero p, the outer
// one zero flux. Its times against those floors are in PERF.md (kernel
// table, rows 19 and 22).
//
// The adjoint: one fused launch a step, a block a kATX x kATZ tile of one
// shot (adjoint_step). The first design ran the reverse step as the
// forwards do, a flux launch (b D+(C P) and b D+(A R) on both axes, with P
// and R formed again at each of the 16 neighbours of a flux) and an update
// launch: 31 fields a step through device memory (6 and 25, the dense
// source weights and lpp and pendR read and written among them), 101 ms
// over the 1336-step SMARMN sweep at 3.35 TB/s, and it took 468.7 ms. The
// fused step loads lp and lr on its tile with a 2R halo along each axis
// once, forms P, R, C P and A R once a cell in shared memory, the four
// fluxes on the tile with an R halo there too, then the images and the new
// state of the tile. lp and lr ping-pong between two buffers, since a
// neighbour's halo reads this step's old values; lpp and pendR are not
// stored: they are (-damp)(damp lp) and damp (lr - D (damp lp)) of the
// state step t + 1 read, which the buffer this step writes still holds at
// the cell's own place - the same operations, so the same values. gsrc is
// added only at the shot's source cells. 16 fields a step: lp and lr read
// in both buffers and written, the history's two, the four images read and
// written (52.3 ms over the sweep). 512 threads a block, two cells a thread
// in the last phase, whose images are loaded before the first, so that the
// four loads' latency, exposed at the step's end when they sat in the last
// phase, hides under the halo phases; the shots are the grid's fastest
// axis, so that a tile's coefficients stay in L1 across its shots. Its
// time against that floor is in PERF.md (kernel table, row 23).
//
// Numerics: each update keeps the Pallas kernels' association term for term
// (every shifted derivative summed tap by tap in offset order, then scaled
// by 1/h; the coefficient products as above), and the library is compiled
// with -fmad=false, so the kernels round exactly like the plain torch twins
// in ops/cuda_visco.py. Offsets into the history and the rows are 64-bit.
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kMaxR = 8;

// the two staggered first-derivative stencils: D+ on offsets -R+1..R, D- on
// -R..R-1 (2R taps each, none zero)
constexpr int kP = 0;
constexpr int kM = 1;

struct Coefs {
  float wp[2 * kMaxR];
  float wm[2 * kMaxR];
  float ihx, ihz;
};

struct Params {
  const float *damp, *b, *A, *B, *C, *D;
};

template <int R, int KIND>
__device__ __forceinline__ int tap(int k) {
  return KIND == kP ? k - R + 1 : k - R;
}

// sum_k w[k] * u[tap(k) * stride] in tap order, times ih: a shifted
// derivative on a tile in shared memory, which holds zeros beyond the grid
template <int R, int KIND>
__device__ __forceinline__ float sderiv(const float* u, int stride,
                                        const float* w, float ih) {
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < 2 * R; ++k) {
    const float term = w[k] * u[tap<R, KIND>(k) * stride];
    acc = k == 0 ? term : acc + term;
  }
  return acc * ih;
}

// The fused forward step's tile (forward_step): kFTX x kFTZ cells of one
// shot. p on the tile and a 2R halo along each axis (the corners are not
// needed), the two fluxes b D+ p on the tile and an R halo along their
// axis, in shared memory. The shot is blockIdx.x, as in adjoint_step.
constexpr int kFTX = 32;
constexpr int kFTZ = 32;
constexpr int kFThreads = 512;
static_assert(kFTX * kFTZ % kFThreads == 0, "whole cells a thread");

template <int R>
struct FwdTile {
  static constexpr int SX = kFTX + 4 * R;    // p: SZ rows x SX
  static constexpr int SZ = kFTZ + 4 * R;
  static constexpr int FXW = kFTX + 2 * R;   // x flux: kFTZ rows x FXW
  static constexpr int FZH = kFTZ + 2 * R;   // z flux: FZH rows x kFTX
  static constexpr int kFloats = SX * SZ + kFTZ * FXW + FZH * kFTX;
  static constexpr size_t kBytes = kFloats * sizeof(float);
};

// Forward step t over one tile of one shot: reads p with halos, writes pn
// over pp and rn over r at the tile's own cells (both read only there);
// the receiver rows of p before the update; the source at the shot's
// cells; with HIST the history (L, rn) and the illumination.
template <int R, bool HIST>
__global__ void __launch_bounds__(kFThreads)
forward_step(Params q, const float* __restrict__ p, float* __restrict__ pp,
             float* __restrict__ r, const float* __restrict__ wav,
             const int* __restrict__ src_cell,
             const float* __restrict__ src_val, int K,
             float* __restrict__ rec, float* __restrict__ hist,
             float* __restrict__ illum, int t, int total, int nsteps, int nz,
             int nx, int z0, Coefs c) {
  using T = FwdTile<R>;
  extern __shared__ float sm[];
  float* sp = sm;                          // p
  float* fx = sp + T::SX * T::SZ;          // b D+x p
  float* fz = fx + kFTZ * T::FXW;          // b D+z p
  const int b = blockIdx.x;                // the shots of a tile adjoin
  const int xt = blockIdx.y * kFTX;
  const int zt = blockIdx.z * kFTZ;
  const int tid = threadIdx.x;
  const size_t field = (size_t)nz * nx;
  const size_t off = (size_t)b * field;

  // 0. pp, r (and the illumination) and the coefficients of the tile's own
  // cells, kCells a thread, read first: their loads' latency hides under
  // phases 1 and 2
  constexpr int kCells = kFTX * kFTZ / kFThreads;
  float ppv[kCells], rv[kCells], il[kCells], qd[kCells], qa[kCells],
      qb[kCells], qc[kCells], qe[kCells];
#pragma unroll
  for (int i = 0; i < kCells; ++i) {
    const int k = tid + i * kFThreads;
    const int gx = xt + k % kFTX;
    const int gz = zt + k / kFTX;
    const bool in = gx < nx && gz < nz;
    const size_t cell = (size_t)gz * nx + gx;
    const size_t o = off + cell;
    ppv[i] = in ? pp[o] : 0.0f;
    rv[i] = in ? r[o] : 0.0f;
    il[i] = HIST && in && t < nsteps ? illum[o] : 0.0f;
    qd[i] = in ? q.damp[cell] : 0.0f;
    qa[i] = in ? q.A[cell] : 0.0f;
    qb[i] = in ? q.B[cell] : 0.0f;
    qc[i] = in ? q.C[cell] : 0.0f;
    qe[i] = in ? q.D[cell] : 0.0f;
  }

  // 1. p on the tile and its 2R halos, zero beyond the grid; all of a
  // thread's loads first
  constexpr int kN1 = (T::SX * T::SZ + kFThreads - 1) / kFThreads;
  float pv1[kN1];
#pragma unroll
  for (int i = 0; i < kN1; ++i) {
    const int k = tid + i * kFThreads;
    const int lx = k % T::SX;
    const int lz = k / T::SX;
    const bool xin = lx >= 2 * R && lx < 2 * R + kFTX;
    const bool zin = lz >= 2 * R && lz < 2 * R + kFTZ;
    const int gx = xt - 2 * R + lx;
    const int gz = zt - 2 * R + lz;
    const bool in = k < T::SX * T::SZ && (xin || zin) && gx >= 0 &&
                    gx < nx && gz >= 0 && gz < nz;
    pv1[i] = in ? p[off + (size_t)gz * nx + gx] : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < kN1; ++i) {
    const int k = tid + i * kFThreads;
    if (k < T::SX * T::SZ) sp[k] = pv1[i];
  }
  __syncthreads();

  // 2. the fluxes: x on the tile's rows and an R halo in x, z on its
  // columns and an R halo in z; zero beyond the grid
  constexpr int kNX = (kFTZ * T::FXW + kFThreads - 1) / kFThreads;
  constexpr int kNZ = (T::FZH * kFTX + kFThreads - 1) / kFThreads;
  float bx[kNX], bz[kNZ];
#pragma unroll
  for (int i = 0; i < kNX; ++i) {
    const int k = tid + i * kFThreads;
    const int gx = xt - R + k % T::FXW;
    const int gz = zt + k / T::FXW;
    const bool in = k < kFTZ * T::FXW && gx >= 0 && gx < nx && gz < nz;
    bx[i] = in ? q.b[(size_t)gz * nx + gx] : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < kNZ; ++i) {
    const int k = tid + i * kFThreads;
    const int gx = xt + k % kFTX;
    const int gz = zt - R + k / kFTX;
    const bool in = k < T::FZH * kFTX && gz >= 0 && gz < nz && gx < nx;
    bz[i] = in ? q.b[(size_t)gz * nx + gx] : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < kNX; ++i) {
    const int k = tid + i * kFThreads;
    if (k >= kFTZ * T::FXW) continue;
    const int lx = k % T::FXW;
    const int lz = k / T::FXW;
    const int gx = xt - R + lx;
    const int gz = zt + lz;
    float v = 0.0f;
    if (gx >= 0 && gx < nx && gz < nz)
      v = bx[i] *
          sderiv<R, kP>(sp + (lz + 2 * R) * T::SX + lx + R, 1, c.wp, c.ihx);
    fx[k] = v;
  }
#pragma unroll
  for (int i = 0; i < kNZ; ++i) {
    const int k = tid + i * kFThreads;
    if (k >= T::FZH * kFTX) continue;
    const int lx = k % kFTX;
    const int lz = k / kFTX;
    const int gx = xt + lx;
    const int gz = zt - R + lz;
    float v = 0.0f;
    if (gz >= 0 && gz < nz && gx < nx)
      v = bz[i] * sderiv<R, kP>(sp + (lz + R) * T::SX + lx + 2 * R, T::SX,
                                c.wp, c.ihz);
    fz[k] = v;
  }
  __syncthreads();

  // 3. L, rn and pn on the tile; the source at step t on inj's non-zero
  // cells of the shot (adding wt * 0 elsewhere would change no value)
  const float wt = wav[t];
  const int* cells_b = src_cell + (size_t)b * K;
  const float* vals_b = src_val + (size_t)b * K;
  const size_t bt = (size_t)b * total + t;
#pragma unroll
  for (int i = 0; i < kCells; ++i) {
    const int k = tid + i * kFThreads;
    const int tx = k % kFTX;
    const int tz = k / kFTX;
    const int gx = xt + tx;
    const int gz = zt + tz;
    if (gx >= nx || gz >= nz) continue;
    const size_t cell = (size_t)gz * nx + gx;
    const size_t o = off + cell;
    const float pv = sp[(tz + 2 * R) * T::SX + tx + 2 * R];
    if (gz == z0 || gz == z0 + 1)
      rec[(bt * 2 + (gz - z0)) * nx + gx] = pv;
    const float L =
        sderiv<R, kM>(fx + tz * T::FXW + tx + R, 1, c.wm, c.ihx) +
        sderiv<R, kM>(fz + (tz + R) * kFTX + tx, kFTX, c.wm, c.ihz);
    const float damp = qd[i];
    const float rn = damp * ((rv[i] + qa[i] * L) - qb[i] * rv[i]);
    float pn =
        damp * ((((2.0f * pv) - damp * ppv[i]) + qc[i] * L) - qe[i] * rn);
    for (int j = 0; j < K; ++j) {
      if (cells_b[j] == (int)cell) pn = pn + wt * vals_b[j];
    }
    if (HIST) {
      float* h = hist + bt * 2 * field + cell;
      h[0] = L;
      h[field] = rn;
      if (t < nsteps) illum[o] = il[i] + pn * pn;
    }
    pp[o] = pn;
    r[o] = rn;
  }
}

// The fused reverse step's tile (adjoint_step): kATX x kATZ cells of one
// shot. C P and A R on the tile and a 2R halo along each axis (the corners
// are not needed), the four fluxes on the tile and an R halo along their
// axis, and P, R on the tile, in shared memory. The shot is blockIdx.x, so
// that the blocks of one tile run together and share its coefficients in
// L1.
constexpr int kATX = 32;
constexpr int kATZ = 32;
constexpr int kAThreads = 512;
static_assert(kATX * kATZ % kAThreads == 0, "whole cells a thread");

template <int R>
struct AdjTile {
  static constexpr int SX = kATX + 4 * R;    // C P, A R: SZ rows x SX
  static constexpr int SZ = kATZ + 4 * R;
  static constexpr int FXW = kATX + 2 * R;   // x fluxes: kATZ rows x FXW
  static constexpr int FZH = kATZ + 2 * R;   // z fluxes: FZH rows x kATX
  static constexpr int kFloats =
      2 * SX * SZ + 2 * kATZ * FXW + 2 * FZH * kATX + 2 * kATX * kATZ;
  static constexpr size_t kBytes = kFloats * sizeof(float);
};

// Reverse step t over one tile of one shot: reads lp, lr of step t + 1's
// output (cur) with halos, writes lp, lr (nxt), and at the tile's own cells
// reads the state step t + 1 read, which nxt still holds, for lpp =
// (-damp) (damp lp) and pendR = damp (lr - D (damp lp)) (zero at the first
// step); the images in place; gsrc at the shot's source cells.
template <int R>
__global__ void __launch_bounds__(kAThreads)
adjoint_step(Params q, const float* __restrict__ lp,
             const float* __restrict__ lr, float* __restrict__ lp_n,
             float* __restrict__ lr_n, const float* __restrict__ hist,
             const float* __restrict__ res, const float* __restrict__ wavs2,
             const int* __restrict__ src_cell,
             const float* __restrict__ src_val, int K,
             float* __restrict__ ga1, float* __restrict__ ga2,
             float* __restrict__ ga3, float* __restrict__ ga4,
             float* __restrict__ gsrc, int t, int total, int nz, int nx,
             int z0, int first, Coefs c) {
  using T = AdjTile<R>;
  extern __shared__ float sm[];
  float* scp = sm;                         // C P
  float* sar = scp + T::SX * T::SZ;        // A R
  float* f1x = sar + T::SX * T::SZ;        // b D+x (C P)
  float* f2x = f1x + kATZ * T::FXW;        // b D+x (A R)
  float* f1z = f2x + kATZ * T::FXW;        // b D+z (C P)
  float* f2z = f1z + T::FZH * kATX;        // b D+z (A R)
  float* sP = f2z + T::FZH * kATX;         // P on the tile
  float* sR = sP + kATX * kATZ;            // R on the tile
  const int b = blockIdx.x;                // the shots of a tile adjoin
  const int xt = blockIdx.y * kATX;
  const int zt = blockIdx.z * kATZ;
  const int tid = threadIdx.x;
  const size_t field = (size_t)nz * nx;
  const size_t off = (size_t)b * field;

  // 0. the images of the tile's own cells, kCells a thread, read first:
  // their loads' latency hides under phases 1 and 2
  constexpr int kCells = kATX * kATZ / kAThreads;
  float g1[kCells], g2[kCells], g3[kCells], g4[kCells];
#pragma unroll
  for (int i = 0; i < kCells; ++i) {
    const int k = tid + i * kAThreads;
    const int gx = xt + k % kATX;
    const int gz = zt + k / kATX;
    g1[i] = g2[i] = g3[i] = g4[i] = 0.0f;
    if (gx < nx && gz < nz) {
      const size_t o = off + (size_t)gz * nx + gx;
      g1[i] = ga1[o];
      g2[i] = ga2[o];
      g3[i] = ga3[o];
      g4[i] = ga4[o];
    }
  }

  // 1. P, R, C P and A R on the tile and its halos, zero beyond the grid
  for (int k = tid; k < T::SX * T::SZ; k += kAThreads) {
    const int lx = k % T::SX;
    const int lz = k / T::SX;
    const bool xin = lx >= 2 * R && lx < 2 * R + kATX;
    const bool zin = lz >= 2 * R && lz < 2 * R + kATZ;
    if (!xin && !zin) continue;
    const int gx = xt - 2 * R + lx;
    const int gz = zt - 2 * R + lz;
    float cpv = 0.0f, arv = 0.0f, pv = 0.0f, rv = 0.0f;
    if (gx >= 0 && gx < nx && gz >= 0 && gz < nz) {
      const size_t cell = (size_t)gz * nx + gx;
      const float damp = q.damp[cell];
      pv = damp * lp[off + cell];
      rv = damp * (lr[off + cell] - q.D[cell] * pv);
      cpv = q.C[cell] * pv;
      arv = q.A[cell] * rv;
    }
    scp[k] = cpv;
    sar[k] = arv;
    if (xin && zin) {
      const int ti = (lz - 2 * R) * kATX + lx - 2 * R;
      sP[ti] = pv;
      sR[ti] = rv;
    }
  }
  __syncthreads();

  // 2. the fluxes: x on the tile's rows and an R halo in x, z on its
  // columns and an R halo in z; zero beyond the grid
  for (int k = tid; k < kATZ * T::FXW; k += kAThreads) {
    const int fx = k % T::FXW;
    const int fz = k / T::FXW;
    const int gx = xt - R + fx;
    const int gz = zt + fz;
    float v1 = 0.0f, v2 = 0.0f;
    if (gx >= 0 && gx < nx && gz < nz) {
      const float bc = q.b[(size_t)gz * nx + gx];
      const int ci = (fz + 2 * R) * T::SX + fx + R;
      v1 = bc * sderiv<R, kP>(scp + ci, 1, c.wp, c.ihx);
      v2 = bc * sderiv<R, kP>(sar + ci, 1, c.wp, c.ihx);
    }
    f1x[k] = v1;
    f2x[k] = v2;
  }
  for (int k = tid; k < T::FZH * kATX; k += kAThreads) {
    const int fx = k % kATX;
    const int fz = k / kATX;
    const int gx = xt + fx;
    const int gz = zt - R + fz;
    float v1 = 0.0f, v2 = 0.0f;
    if (gz >= 0 && gz < nz && gx < nx) {
      const float bc = q.b[(size_t)gz * nx + gx];
      const int ci = (fz + R) * T::SX + fx + 2 * R;
      v1 = bc * sderiv<R, kP>(scp + ci, T::SX, c.wp, c.ihz);
      v2 = bc * sderiv<R, kP>(sar + ci, T::SX, c.wp, c.ihz);
    }
    f1z[k] = v1;
    f2z[k] = v2;
  }
  // gsrc += (wavs2[t] injw) lp at the shot's source cells in this tile
  // (adding (wavs2[t] * 0) lp elsewhere would change no finite value)
  for (int k = tid; k < K; k += kAThreads) {
    const int cidx = src_cell[(size_t)b * K + k];
    if (cidx < 0) continue;
    const int gz = cidx / nx;
    const int gx = cidx - gz * nx;
    if (gx < xt || gx >= xt + kATX || gz < zt || gz >= zt + kATZ) continue;
    const size_t o = off + cidx;
    gsrc[o] = gsrc[o] + (wavs2[t] * src_val[(size_t)b * K + k]) * lp[o];
  }
  __syncthreads();

  // 3. the images and the new state on the tile
  const float* h = hist + ((size_t)b * total + t) * 2 * field;
#pragma unroll
  for (int i = 0; i < kCells; ++i) {
    const int k = tid + i * kAThreads;
    const int tx = k % kATX;
    const int tz = k / kATX;
    const int gx = xt + tx;
    const int gz = zt + tz;
    if (gx >= nx || gz >= nz) continue;
    const size_t cell = (size_t)gz * nx + gx;
    const size_t o = off + cell;
    const int xi = tz * T::FXW + tx + R;
    const int zi = (tz + R) * kATX + tx;
    const float lsa_cp = sderiv<R, kM>(f1x + xi, 1, c.wm, c.ihx) +
                         sderiv<R, kM>(f1z + zi, kATX, c.wm, c.ihz);
    const float lsa_ar = sderiv<R, kM>(f2x + xi, 1, c.wm, c.ihx) +
                         sderiv<R, kM>(f2z + zi, kATX, c.wm, c.ihz);
    const float L = h[cell];
    const float rn = h[field + cell];
    const float damp = q.damp[cell];
    const float pa = sP[k];
    const float ra = sR[k];
    float lpp = 0.0f, pend = 0.0f;
    if (!first) {
      const float po = damp * lp_n[o];
      lpp = (-damp) * po;
      pend = damp * (lr_n[o] - q.D[cell] * po);
    }
    ga3[o] = g3[i] + L * pa;
    ga4[o] = g4[i] - rn * pa;
    ga1[o] = g1[i] + L * ra;
    ga2[o] = g2[i] - rn * pend;
    float lpn = ((2.0f * pa + lsa_cp) + lsa_ar) + lpp;
    if (gz == z0 || gz == z0 + 1)
      lpn = lpn + res[(((size_t)b * total + t) * 2 + (gz - z0)) * nx + gx];
    lp_n[o] = lpn;
    lr_n[o] = ra - q.B[cell] * ra;
  }
}

struct ForwardArgs {
  Params q;
  const float* wav;
  const int* src_cell;
  const float* src_val;
  float *rec, *hist, *illum, *pout, *scratch;
  int K, B, nz, nx, total, nsteps, z0;
  Coefs c;
  cudaStream_t stream;
};

// One fused launch a step; scratch holds p, pp and r from zero, pn going
// over pp and rn over r, then p and pp swap.
template <int R, bool HIST>
int run_forward(const ForwardArgs& a) {
  using T = FwdTile<R>;
  cudaError_t err = cudaFuncSetAttribute(
      forward_step<R, HIST>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)T::kBytes);
  if (err != cudaSuccess) return (int)err;
  const size_t n = (size_t)a.B * a.nz * a.nx;
  float* p = a.scratch;
  float* pp = a.scratch + n;
  float* r = a.scratch + 2 * n;
  err = cudaMemsetAsync(a.scratch, 0, 3 * n * sizeof(float), a.stream);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.B, (a.nx + kFTX - 1) / kFTX, (a.nz + kFTZ - 1) / kFTZ);
  for (int t = 0; t < a.total; ++t) {
    forward_step<R, HIST><<<grid, kFThreads, T::kBytes, a.stream>>>(
        a.q, p, pp, r, a.wav, a.src_cell, a.src_val, a.K, a.rec, a.hist,
        a.illum, t, a.total, a.nsteps, a.nz, a.nx, a.z0, a.c);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    float* tmp = p;
    p = pp;
    pp = tmp;
    if (a.pout != NULL && t == a.nsteps - 1) {
      err = cudaMemcpyAsync(a.pout, p, n * sizeof(float),
                            cudaMemcpyDeviceToDevice, a.stream);
      if (err != cudaSuccess) return (int)err;
    }
  }
  return 0;
}

struct AdjointArgs {
  Params q;
  const int* src_cell;
  const float *src_val, *hist, *res, *wavs2;
  float *ga1, *ga2, *ga3, *ga4, *gsrc, *scratch;
  int K, B, nz, nx, total, nsteps, z0;
  Coefs c;
  cudaStream_t stream;
};

// One fused launch a step; scratch holds two states (lp, lr), swapped every
// step, the first zero.
template <int R>
int run_adjoint(const AdjointArgs& a) {
  using T = AdjTile<R>;
  cudaError_t err = cudaFuncSetAttribute(
      adjoint_step<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)T::kBytes);
  if (err != cudaSuccess) return (int)err;
  const size_t n = (size_t)a.B * a.nz * a.nx;
  float* st[2][2] = {{a.scratch, a.scratch + n},
                     {a.scratch + 2 * n, a.scratch + 3 * n}};
  err = cudaMemsetAsync(a.scratch, 0, 2 * n * sizeof(float), a.stream);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.B, (a.nx + kATX - 1) / kATX, (a.nz + kATZ - 1) / kATZ);
  // padded tail steps (t >= nsteps) are skipped in reverse
  for (int t = a.nsteps - 1, k = 0; t >= 0; --t, ++k) {
    float* const* cur = st[k & 1];
    float* const* nxt = st[(k & 1) ^ 1];
    adjoint_step<R><<<grid, kAThreads, T::kBytes, a.stream>>>(
        a.q, cur[0], cur[1], nxt[0], nxt[1], a.hist, a.res, a.wavs2,
        a.src_cell, a.src_val, a.K, a.ga1, a.ga2, a.ga3, a.ga4, a.gsrc, t,
        a.total, a.nz, a.nx, a.z0, k == 0, a.c);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

template <int R>
struct Fwd {
  static int run(const ForwardArgs& a) {
    return a.hist != NULL ? run_forward<R, true>(a)
                          : run_forward<R, false>(a);
  }
};

template <int R>
struct Adj {
  static int run(const AdjointArgs& a) { return run_adjoint<R>(a); }
};

// Dispatch the runtime radius onto the unrolled instantiations.
template <template <int> class F, class A>
int dispatch_r(int r, const A& a) {
  switch (r) {
    case 1: return F<1>::run(a);
    case 2: return F<2>::run(a);
    case 3: return F<3>::run(a);
    case 4: return F<4>::run(a);
    case 5: return F<5>::run(a);
    case 6: return F<6>::run(a);
    case 7: return F<7>::run(a);
    case 8: return F<8>::run(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

Coefs make_coefs(int r, const float* wp, const float* wm, float ihx,
                 float ihz) {
  Coefs c = {};
  for (int k = 0; k < 2 * r; ++k) {
    c.wp[k] = wp[k];
    c.wm[k] = wm[k];
  }
  c.ihx = ihx;
  c.ihz = ihz;
  return c;
}

Params make_params(const float* damp, const float* b, const float* A,
                   const float* Bc, const float* C, const float* D) {
  Params q = {damp, b, A, Bc, C, D};
  return q;
}

}  // namespace

extern "C" {

// Forward sweep over t = 0 .. total-1 from zero fields. rec is
// (B, total, 2, nx). With hist == NULL (modeling) illum is NULL and pout
// (B, nz, nx) receives p after step nsteps - 1; otherwise hist is
// (B, total, 2, nz, nx), illum (B, nz, nx) holds zeros on entry and pout is
// NULL. The source pattern inj (B, nz, nx) comes as its non-zero cells:
// src_cell (B, K) int32 z * nx + x (-1 pads) and src_val (B, K) their
// values. scratch is 3 (B, nz, nx) fields: p, pp and r (the sweep zeroes
// them). wp and wm are the 2r taps of the D+ and D- stencils. Returns the
// first CUDA error of a launch, or 0.
int visco2d_forward(const float* damp, const float* b, const float* A,
                    const float* Bc, const float* C, const float* D,
                    const float* wav, const int* src_cell,
                    const float* src_val, int K, float* rec, float* hist,
                    float* illum, float* pout, float* scratch, int B, int nz,
                    int nx, int total, int nsteps, int z0, int r,
                    const float* wp, const float* wm, float ihx, float ihz,
                    void* stream) {
  if (r < 1 || r > kMaxR || (hist == NULL) != (illum == NULL) ||
      (hist == NULL) == (pout == NULL) || z0 < 0 || z0 + 2 > nz ||
      nsteps < 1 || nsteps > total || K < 1 || B < 1 || nx < 1 ||
      (long long)nz * nx >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  ForwardArgs a = {};
  a.q = make_params(damp, b, A, Bc, C, D);
  a.wav = wav;
  a.src_cell = src_cell;
  a.src_val = src_val;
  a.rec = rec;
  a.hist = hist;
  a.illum = illum;
  a.pout = pout;
  a.scratch = scratch;
  a.K = K;
  a.B = B;
  a.nz = nz;
  a.nx = nx;
  a.total = total;
  a.nsteps = nsteps;
  a.z0 = z0;
  a.c = make_coefs(r, wp, wm, ihx, ihz);
  a.stream = (cudaStream_t)stream;
  return dispatch_r<Fwd>(r, a);
}

// Reverse sweep over t = nsteps-1 .. 0 of a history of total steps, with
// the residual rows res (B, total, 2, nx), wavs2 (total,) the wavelet times
// dt^2 and the source weights as each shot's non-zero cells: src_cell
// (B, K) int32 z * nx + x, -1 past a shot's last, src_val (B, K). grads is
// 5 (B, nz, nx) images (ga1, ga2, ga3, ga4, gsrc) holding zeros on entry;
// scratch 4 (B, nz, nx) fields (two states lp, lr). Returns the first CUDA
// error of a launch, or 0.
int visco2d_adjoint(const float* damp, const float* b, const float* A,
                    const float* Bc, const float* C, const float* D,
                    const int* src_cell, const float* src_val, int K,
                    const float* hist, const float* res, const float* wavs2,
                    float* grads, float* scratch, int B, int nz, int nx,
                    int total, int nsteps, int z0, int r, const float* wp,
                    const float* wm, float ihx, float ihz, void* stream) {
  if (r < 1 || r > kMaxR || z0 < 0 || z0 + 2 > nz || nsteps > total ||
      K < 1 || B < 1 || (long long)nz * nx >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const size_t n = (size_t)B * nz * nx;
  AdjointArgs a = {};
  a.q = make_params(damp, b, A, Bc, C, D);
  a.src_cell = src_cell;
  a.src_val = src_val;
  a.hist = hist;
  a.res = res;
  a.wavs2 = wavs2;
  a.ga1 = grads;
  a.ga2 = grads + n;
  a.ga3 = grads + 2 * n;
  a.ga4 = grads + 3 * n;
  a.gsrc = grads + 4 * n;
  a.scratch = scratch;
  a.K = K;
  a.B = B;
  a.nz = nz;
  a.nx = nx;
  a.total = total;
  a.nsteps = nsteps;
  a.z0 = z0;
  a.c = make_coefs(r, wp, wm, ihx, ihz);
  a.stream = (cudaStream_t)stream;
  return dispatch_r<Adj>(r, a);
}

const char* visco2d_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
