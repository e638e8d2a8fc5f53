// 2-D velocity-stress elastic sweeps for Hopper (sm_90a), plain C interface
// for ctypes. Two entry points, each one sweep over all time steps of a shot
// batch on the caller's stream:
//
//   elastic2d_forward(..., hist = NULL)
//       replaces _elastic_segments (devito_fwi_tpu/ops/pallas_staggered.py
//       :173, _elastic_kernel :79): forward modeling that records, at every
//       step, the two receiver rows of tau_zz and of div v (the centred
//       derivative of each velocity component on its own grid).
//   elastic2d_forward(..., hist != NULL)
//       replaces elastic_fwd_hist_segments (pallas_staggered.py:607,
//       _elastic_fwd_hist_kernel :508): the same forward recording only the
//       tau_zz rows, plus the history (vx', vz', dtau_x, dtau_z) of every
//       step and the illumination sum of vx'^2 + vz'^2 over the steps
//       t < nsteps.
//   elastic2d_adjoint (one fused launch a step, adjoint_step)
//       replaces elastic_grad_stream_segments (pallas_staggered.py:763,
//       _elastic_grad_stream_kernel :637): the exact transpose of the forward
//       step, walked from step nsteps-1 down to 0 over the history, with the
//       residual rows added to the tau_zz adjoint on rows z0 and z0 + 1; it
//       accumulates five images: lam, mu at the nodes, mu at the (+h/2, +h/2)
//       points, b at +h/2 in x and b at +h/2 in z.
//
// Layout: fields are (B, nz, nx) float32 with x contiguous (the transposed
// layout of the JAX kernels); the nine parameter fields lam, mu, b0, b1,
// damp, d0, d1, mu01, d01 are (nz, nx) and shared by all shots (b0, d0 are
// averaged to +h/2 in x, b1, d1 in z, mu01, d01 in both); the forward takes
// the source pattern (w * dt at the source's corners) as each shot's
// non-zero cells; receiver rows are (B, total, 2, 2, nx) for the modeling
// forward and (B, total, 2, nx) otherwise; the history is
// (B, total, 4, nz, nx).
//
// What bounds the forward on the card: at the 31-shot SMARM2 batch (420 x
// 220 padded, 1420 steps, space order 8) its operations bound it at
// 9.673 ms if the state never left the chip, and the history forward's
// 65 GB write at 19.5 ms (3.35 TB/s). But one field of the batch is
// 11.46 MB and the state (5 fields, twice for old and new) is past the
// 50 MB L2, so every step streams it through device memory: the floor of
// such a design is its traffic a step, 16 fields (183 MB, 77.7 ms over the
// sweep) for the first design's two launches a step, 10 fields (115 MB,
// 48.6 ms) for one.
//
// What the forward's design does about it: one launch a step that marches
// z (forward_step). A block of 64 threads owns a strip of 64 - 2R columns
// of one shot and walks down a segment of rows, one thread a column of the
// strip and its R halo; each thread keeps its column of the old tau_zz,
// tau_xz and of the new vx, vz in register queues, so every z tap is a
// register, and the x taps read one row of each field in shared memory
// (two alternating sets, one barrier a row). Old and new state are two
// buffers, swapped every step; the source adds only at its cells. The
// first fused design took a 32 x 32 tile a block and recomputed the
// velocities on an R halo along both axes (1.56x the velocity work) from
// the stresses loaded with a 2R halo (2.25x the loads), every tap a
// shared-memory read: 128.5 ms for the modelling sweep, 90.5 us a step
// against the fused floor's 34.2 us, at about 400 instructions a cell. The
// march recomputes only the x halo (64 / (64 - 2R) = 1.14x at R = 4) and a
// segment's 2R lead-in rows of velocities, and reads half the taps from
// registers; but a thread walks its column row by row, so the segments
// must be short enough to fill the card (5 of 44 rows at 31 shots,
// ``cuda_staggered.forward_launch`` from the blocks an SM holds,
// elastic2d_forward_blocks), and the lead-in, the queue shifts and the
// per-row loads cost about 450 instructions a thread and row (SASS), an
// estimated 80% of the card's issue rate at 96 registers a thread and 10
// blocks an SM. Measured (chip_smoke.py phase 13, H100 80GB HBM3 at 700 W;
// PERF.md, kernel table rows 18 and 20): the modelling sweep 113.8 ms,
// 80.1 us a step, and the history sweep 147.7 ms, against the tile's 128.3
// and 165.6 ms on the same card (tools/probe_elastic.py --baseline).
//
// The adjoint: the first design ran the reverse step as two launches,
// one thread a cell, every neighbour through L1/L2: a velocity phase (the
// history's vx', vz' and three derived stress-adjoint fields read at
// stencil distance, the velocity adjoints and five images updated in
// place) and a stress phase that wrote, besides the stress adjoints, the
// derived fields (s lam) sum + (2 s mu) th_i and (s mu01) th_xz only for
// the next step to read again: 35 fields a step through device memory
// (24 and 11), 170.0 ms over the 1420-step SMARM2 sweep at 3.35 TB/s, and
// it took 430.3 ms. The fused step (adjoint_step), one launch a step, a
// block a kTX x kTZ tile of one shot, mirrors forward_step: it loads the
// stored stress adjoints on its tile and a 2R halo and forms the derived
// fields there once a cell in shared memory (the same operations on the
// same stored values, so the same bits; they are no longer stored), the
// history's vx', vz' with an R halo, then the velocity adjoints on the
// tile and an R halo along each axis (the halo repeats the neighbours'
// arithmetic), the images of the tile, and the tile's stress adjoints
// from the velocity adjoints in shared memory. The adjoint state
// ping-pongs between two buffers, since a neighbour's halo reads this
// step's old values. 24 fields a step: the history's 4, the five adjoints
// read and written, the five images read and written (116.6 ms over the
// sweep). The images are loaded before the halo phases, where their
// latency hides; the shots are the grid's fastest axis, so that a tile's
// nine parameter fields stay in L1 across its shots. Its time against
// that floor is in PERF.md (kernel table, row 21).
//
// Numerics: each update keeps the association of the Pallas kernels term
// for term ((s*b0)*dtau_x; (2s*mu)*dvx with 2s formed first; (s*div)*sum;
// every shifted derivative summed tap by tap in offset order, then scaled
// by 1/h; a zero tap, which the twins skip, adds nothing), and the library
// is compiled with -fmad=false, so the kernels round exactly like the plain
// torch twins in ops/cuda_staggered.py. Neighbours beyond the padded grid
// are zero. Offsets into the history and the rows are 64-bit.
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kMaxR = 8;

// the three first-derivative stencils: D+ on offsets -R+1..R, D- on -R..R-1,
// the centred one on -R..R (its centre weight is zero, or a rounding residue
// of one, which the Pallas kernel keeps: adding w * u with w = 0 changes no
// sum, so the kernel always takes the 2R+1 taps)
constexpr int kP = 0;
constexpr int kM = 1;
constexpr int kC = 2;

// what the velocity phase of a forward step writes besides the velocities
constexpr int kRows = 1;  // tau_zz and div v rows (modeling)
constexpr int kHist = 2;  // tau_zz rows, history, illumination (gradient)

struct Coefs {
  float wp[2 * kMaxR];
  float wm[2 * kMaxR];
  float wc[2 * kMaxR + 1];
  float ihx, ihz, s, two_s;
};

struct Params {
  const float *lam, *mu, *b0, *b1, *damp, *d0, *d1, *mu01, *d01;
};

template <int R, int KIND>
__device__ __forceinline__ int tap(int k) {
  return KIND == kP ? k - R + 1 : k - R;
}

// sum_k w[k] * f(i + tap(k)) in tap order, zero beyond 0..n-1, times ih
template <int R, int KIND, class F>
__device__ __forceinline__ float deriv(F f, int i, int n, const float* w,
                                       float ih) {
  constexpr int kTaps = KIND == kC ? 2 * R + 1 : 2 * R;
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < kTaps; ++k) {
    const int j = i + tap<R, KIND>(k);
    const float v = (j >= 0 && j < n) ? f(j) : 0.0f;
    const float term = w[k] * v;
    acc = k == 0 ? term : acc + term;
  }
  return acc * ih;
}

template <int KIND>
__device__ __forceinline__ const float* weights(const Coefs& c) {
  return KIND == kP ? c.wp : (KIND == kM ? c.wm : c.wc);
}

// derivative along x (physical axis 0, contiguous) / z of one shot's field
template <int R, int KIND>
__device__ __forceinline__ float ddx(const float* __restrict__ u, int z,
                                     int x, int nx, const Coefs& c) {
  const float* row = u + (size_t)z * nx;
  return deriv<R, KIND>([&](int j) { return row[j]; }, x, nx,
                        weights<KIND>(c), c.ihx);
}

template <int R, int KIND>
__device__ __forceinline__ float ddz(const float* __restrict__ u, int z,
                                     int x, int nz, int nx, const Coefs& c) {
  return deriv<R, KIND>([&](int j) { return u[(size_t)j * nx + x]; }, z, nz,
                        weights<KIND>(c), c.ihz);
}


// The shifted derivative from shared memory: the taps at s[tap(k) * stride]
// around the centre s, summed in tap order, times ih; shared memory holds
// zeros beyond the grid, as deriv reads them.
template <int R, int KIND>
__device__ __forceinline__ float sderiv(const float* s, int stride,
                                        const float* w, float ih) {
  constexpr int kTaps = KIND == kC ? 2 * R + 1 : 2 * R;
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < kTaps; ++k) {
    const float term = w[k] * s[tap<R, KIND>(k) * stride];
    acc = k == 0 ? term : acc + term;
  }
  return acc * ih;
}

// The shifted derivative from a register queue: q[R] the centre, the taps
// at q[R + tap(k)], summed in tap order, times ih.
template <int R, int KIND>
__device__ __forceinline__ float qderiv(const float (&q)[2 * R + 1],
                                        const float* w, float ih) {
  constexpr int kTaps = KIND == kC ? 2 * R + 1 : 2 * R;
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < kTaps; ++k) {
    const float term = w[k] * q[R + tap<R, KIND>(k)];
    acc = k == 0 ? term : acc + term;
  }
  return acc * ih;
}

// q[k] <- q[k + 1], the new value at the front
template <int R>
__device__ __forceinline__ void push(float (&q)[2 * R + 1], float v) {
#pragma unroll
  for (int k = 0; k < 2 * R; ++k) q[k] = q[k + 1];
  q[2 * R] = v;
}

// The forward step's march: a block owns a strip of W = kMarchCols - 2R
// x-columns of one shot and walks down z over a segment of rows [zs, ze),
// one thread a column of the strip and its R x halo. In iteration i the
// thread computes the new velocity on row v = zs - R + i and the new
// stresses on row z = v - R. Each thread keeps its column in four register
// queues, so every z tap comes from registers: the old tau_zz and tau_xz
// on rows v - R .. v + R, the new vx and vz on rows z - R .. z + R. The x
// taps come from one row of each field in shared memory: tau_xx and tau_xz
// of row v on the strip and a 2R halo, vx and vz of row z on the strip and
// an R halo; two such sets alternate, one barrier an iteration. Only the x
// halo of the velocities and a segment's 2R lead-in rows of velocities
// repeat a neighbour's arithmetic.
constexpr int kMarchCols = 64;
constexpr int kFThreads = kMarchCols;

template <int R>
struct March {
  static constexpr int W = kMarchCols - 2 * R;  // the strip's columns
  static constexpr int PS = kMarchCols + 2 * R;  // stress rows: + 2R halo
  static constexpr int PV = kMarchCols;          // velocity rows: + R halo
  static constexpr int kSet = 2 * PS + 2 * PV;   // txx, txz, vx, vz rows
  static constexpr size_t kBytes = sizeof(float) * 2 * kSet;
};
static_assert(2 * kMaxR <= kMarchCols / 2, "the halo loaders are threads");

template <int R, int FLAGS>
__global__ void __launch_bounds__(kFThreads)
forward_step(Params p, const float* __restrict__ vx,
             const float* __restrict__ vz, const float* __restrict__ txx,
             const float* __restrict__ tzz, const float* __restrict__ txz,
             float* __restrict__ vx_out, float* __restrict__ vz_out,
             float* __restrict__ txx_out, float* __restrict__ tzz_out,
             float* __restrict__ txz_out, const float* __restrict__ wav,
             const int* __restrict__ src_cell,
             const float* __restrict__ src_val, int K,
             float* __restrict__ rec, float* __restrict__ hist,
             float* __restrict__ illum, int t, int total, int nsteps, int nz,
             int nx, int z0, int zlen, Coefs c) {
  using M = March<R>;
  constexpr int W = M::W, PS = M::PS, PV = M::PV;
  extern __shared__ float sm[];
  const int x0 = blockIdx.x * W;
  const int zs = blockIdx.y * zlen;
  const int ze = min(zs + zlen, nz);
  const int b = blockIdx.z;
  const int col = threadIdx.x;     // x = x0 - R + col
  const int x = x0 - R + col;
  const bool in_x = x >= 0 && x < nx;
  const bool own = in_x && col >= R && col < R + W;
  // the 2R halo loaders: stress row column hc, x = x0 - 2R + hc
  const bool halo = col < 2 * R;
  const int hc = col < R ? col : PS - 2 * R + col;
  const int hx = x0 - 2 * R + hc;
  const bool in_hx = halo && hx >= 0 && hx < nx;
  // the shot's fields, indexed by the cell z * nx + x (below 2^31)
  const size_t field = (size_t)nz * nx;
  const size_t off = (size_t)b * field;
  const float* __restrict__ vx_b = vx + off;
  const float* __restrict__ vz_b = vz + off;
  const float* __restrict__ txx_b = txx + off;
  const float* __restrict__ tzz_b = tzz + off;
  const float* __restrict__ txz_b = txz + off;
  float* __restrict__ vxo_b = vx_out + off;
  float* __restrict__ vzo_b = vz_out + off;
  float* __restrict__ txxo_b = txx_out + off;
  float* __restrict__ tzzo_b = tzz_out + off;
  float* __restrict__ txzo_b = txz_out + off;
  float* __restrict__ il_b = FLAGS & kHist ? illum + off : nullptr;
  const size_t bt = (size_t)b * total + t;
  float* __restrict__ h_b = FLAGS & kHist ? hist + bt * 4 * field : nullptr;
  const float wt = wav[t];
  const int* cells_b = src_cell + (size_t)b * K;
  const float* vals_b = src_val + (size_t)b * K;

  // does a source cell of the shot lie on the block's rows and strip?
  bool src_here = false;
  for (int q = 0; q < K; ++q) {
    const int cq = cells_b[q];
    const int qz = cq / nx, qx = cq - (cq / nx) * nx;
    src_here |= cq >= 0 && qz >= zs && qz < ze && qx >= x0 && qx < x0 + W;
  }

  // the queues: old tau_zz, tau_xz of the column on rows v - R .. v + R
  // (shifted at the start of an iteration, the front loaded one iteration
  // ahead), new vx, vz on rows v - 2R - 1 .. v - 1 before the push of row v;
  // zero beyond the grid
  float qzz[2 * R + 1], qxz[2 * R + 1], wx[2 * R + 1], wz[2 * R + 1];
#pragma unroll
  for (int k = 0; k < 2 * R; ++k) {
    const int r = zs - 2 * R + k;
    const bool in = in_x && r >= 0;
    qzz[k + 1] = in ? tzz_b[(unsigned)(r * nx + x)] : 0.0f;
    qxz[k + 1] = in ? txz_b[(unsigned)(r * nx + x)] : 0.0f;
  }
#pragma unroll
  for (int k = 0; k <= 2 * R; ++k) wx[k] = wz[k] = 0.0f;
  qzz[0] = qxz[0] = 0.0f;

  // what iteration i reads from device memory, loaded one iteration ahead:
  // the queues' fronts (row v + R), tau_xx on row v (and tau_xx, tau_xz of
  // the halo column), the velocity's operands on row v, the stresses' on
  // row z = v - R (zs <= v + R, and z < ze <= nz)
  float fzz, fxz, fxx, hxx, hxz;
  float vd0, vb0, vd1, vb1, vvx, vvz, vil;
  float slam, smu, sdamp, sd01, smu01, sxx0;
  auto fetch = [&](int i) {
    const int v = zs - R + i, z = v - R;
    const unsigned cv = v * nx + x;   // read only where row v is in the grid
    const bool vin = v >= 0 && v < nz;
    fzz = fxz = 0.0f;
    if (in_x && v + R < nz) {
      fzz = tzz_b[cv + R * nx];
      fxz = txz_b[cv + R * nx];
    }
    fxx = vd0 = vb0 = vd1 = vb1 = vvx = vvz = vil = 0.0f;
    if (in_x && vin) {
      fxx = txx_b[cv];
      vd0 = p.d0[cv];
      vb0 = p.b0[cv];
      vd1 = p.d1[cv];
      vb1 = p.b1[cv];
      vvx = vx_b[cv];
      vvz = vz_b[cv];
      if ((FLAGS & kHist) && own && v >= zs && v < ze && t < nsteps)
        vil = il_b[cv];
    }
    hxx = hxz = 0.0f;
    if (in_hx && vin) {
      hxx = txx_b[(unsigned)(v * nx + hx)];
      hxz = txz_b[(unsigned)(v * nx + hx)];
    }
    slam = smu = sdamp = sd01 = smu01 = sxx0 = 0.0f;
    if (own && z >= zs && z < ze) {
      const unsigned cz = cv - R * nx;
      slam = p.lam[cz];
      smu = p.mu[cz];
      sdamp = p.damp[cz];
      sd01 = p.d01[cz];
      smu01 = p.mu01[cz];
      sxx0 = txx_b[cz];
    }
  };
  fetch(0);

  const int iters = ze - zs + 2 * R;
  for (int i = 0; i < iters; ++i) {
    const int v = zs - R + i;
    const int z = v - R;
    push<R>(qzz, fzz);
    push<R>(qxz, fxz);
    const float d0 = vd0, b0 = vb0, d1 = vd1, b1 = vb1, vxo = vvx,
                vzo = vvz, lam = slam, mu = smu, damp = sdamp, d01 = sd01,
                mu01 = smu01, txx_old = sxx0;
    float il = vil;
    // this iteration's rows: tau_xx, tau_xz of row v, vx, vz of row z
    float* sxx = sm + (i & 1) * M::kSet;
    float* sxz = sxx + PS;
    float* svx = sxz + PS;
    float* svz = svx + PV;
    sxx[col + R] = fxx;
    sxz[col + R] = qxz[R];
    if (halo) {
      sxx[hc] = hxx;
      sxz[hc] = hxz;
    }
    svx[col] = wx[R + 1];
    svz[col] = wz[R + 1];
    __syncthreads();
    if (i + 1 < iters) fetch(i + 1);

    // the new velocity on row v
    float vxn = 0.0f, vzn = 0.0f;
    if (in_x && v >= 0 && v < nz) {
      const float dtau_x = sderiv<R, kP>(sxx + col + R, 1, c.wp, c.ihx) +
                           qderiv<R, kM>(qxz, c.wm, c.ihz);
      const float dtau_z = qderiv<R, kP>(qzz, c.wp, c.ihz) +
                           sderiv<R, kM>(sxz + col + R, 1, c.wm, c.ihx);
      vxn = d0 * (vxo + (c.s * b0) * dtau_x);
      vzn = d1 * (vzo + (c.s * b1) * dtau_z);
      if (own && v >= zs && v < ze) {
        const unsigned cv = v * nx + x;
        vxo_b[cv] = vxn;
        vzo_b[cv] = vzn;
        if (FLAGS & kHist) {
          float* h = h_b + cv;
          h[0] = vxn;
          h[field] = vzn;
          h[2 * field] = dtau_x;
          h[3 * field] = dtau_z;
          if (t < nsteps) {
            il = il + vxn * vxn;
            il = il + vzn * vzn;
            il_b[cv] = il;
          }
        }
      }
    }
    push<R>(wx, vxn);
    push<R>(wz, vzn);

    // the new stresses on row z, then the source at step t on inj's
    // non-zero cells of the shot (adding wt * 0 elsewhere would change no
    // value)
    if (!own || z < zs || z >= ze) continue;
    const unsigned cz = z * nx + x;
    const float dvx = sderiv<R, kM>(svx + col, 1, c.wm, c.ihx);
    const float dvz = qderiv<R, kM>(wz, c.wm, c.ihz);
    const float div = dvx + dvz;
    const float s_lam = c.s * lam;
    const float two_s_mu = c.two_s * mu;
    float txxn = damp * ((txx_old + s_lam * div) + two_s_mu * dvx);
    float tzzn = damp * ((qzz[0] + s_lam * div) + two_s_mu * dvz);
    const float g = qderiv<R, kP>(wx, c.wp, c.ihz) +
                    sderiv<R, kP>(svz + col, 1, c.wp, c.ihx);
    const float txzn = d01 * (qxz[0] + (c.s * mu01) * g);
    if (src_here) {
      for (int q = 0; q < K; ++q) {
        if (cells_b[q] == (int)cz) {
          const float w = wt * vals_b[q];
          txxn = txxn + w;
          tzzn = tzzn + w;
        }
      }
    }
    txxo_b[cz] = txxn;
    tzzo_b[cz] = tzzn;
    txzo_b[cz] = txzn;
    // the receiver rows: the old tau_zz and, for modelling, the centred
    // divergence of the old velocities
    if (z == z0 || z == z0 + 1) {
      const int plane = z - z0;
      if (FLAGS & kRows) {
        rec[((bt * 2 + 0) * 2 + plane) * nx + x] = qzz[0];
        const float div_c = ddx<R, kC>(vx_b, z, x, nx, c) +
                            ddz<R, kC>(vz_b, z, x, nz, nx, c);
        rec[((bt * 2 + 1) * 2 + plane) * nx + x] = div_c;
      } else {
        rec[(bt * 2 + plane) * nx + x] = qzz[0];
      }
    }
  }
}

// The fused reverse step's tile (adjoint_step): kTX x kTZ cells of one
// shot, kAThreads threads. In shared memory: the three derived stress-
// adjoint fields on the tile and a 2R halo (the outer corners beyond R of
// both axes are not needed and not loaded); damp txxb, damp tzzb and
// d01 txzb on the tile; the history's vx', vz' and the two products
// (s b0) vhx, (s b1) vhz on the tile and an R halo along each axis.
constexpr int kTX = 32;
constexpr int kTZ = 32;
// (s b0) vhx, (s b1) vhz on the tile and an R halo along each axis.
constexpr int kAThreads = 512;
static_assert(kTX * kTZ % kAThreads == 0, "whole cells a thread");

template <int R>
struct AdjTile {
  static constexpr int SX = kTX + 4 * R;  // derived fields: SZ rows x SX
  static constexpr int SZ = kTZ + 4 * R;
  static constexpr int VX = kTX + 2 * R;  // history, velocity products
  static constexpr int VZ = kTZ + 2 * R;
  static constexpr int kArms = 2 * R * kTX + 2 * R * kTZ;
  static constexpr size_t kBytes =
      sizeof(float) * (3 * SX * SZ + 3 * kTX * kTZ + 4 * VX * VZ);
};

// how far local index l lies outside [lo, lo + n): 0 inside
__device__ __forceinline__ int outside(int l, int lo, int n) {
  return l < lo ? lo - l : (l >= lo + n ? l - (lo + n) + 1 : 0);
}

// whether the derived fields are needed at derived-tile index (lx, lz):
// the tile and its 2R halo, less the corners beyond R of both axes
template <int R>
__device__ __forceinline__ bool derived_needed(int lx, int lz) {
  const int ex = outside(lx, 2 * R, kTX);
  const int ez = outside(lz, 2 * R, kTZ);
  return !ex || !ez || (ex <= R && ez <= R);
}

// The velocity adjoint at derived-tile index si of a cell whose stored
// velocity adjoints are vx, vz: vh_x = d0 ((vxb - D+x dvbx) - D-z gbs),
// vh_z = d1 ((vzb - D+z dvbz) - D-x gbs).
template <int R>
__device__ __forceinline__ float2 vel_adjoint_at(const float* sdx,
                                                 const float* sdz,
                                                 const float* sgs, float vx,
                                                 float vz, float d0,
                                                 float d1, int si,
                                                 const Coefs& c) {
  constexpr int SX = AdjTile<R>::SX;
  const float vbtx = (vx - sderiv<R, kP>(sdx + si, 1, c.wp, c.ihx)) -
                     sderiv<R, kM>(sgs + si, SX, c.wm, c.ihz);
  const float vbtz = (vz - sderiv<R, kP>(sdz + si, SX, c.wp, c.ihz)) -
                     sderiv<R, kM>(sgs + si, 1, c.wm, c.ihx);
  return make_float2(d0 * vbtx, d1 * vbtz);
}

// Reverse step t (history step t of total) over one tile of one shot:
// reads the adjoint state step t + 1 wrote (vxb, vzb, txxb, tzzb, txzb)
// with halos and writes the new one (the _n buffers); the images in place.
// 1. the derived fields (s lam) sum + (2 s mu) th_i and (s mu01) th_xz from
//    the stored stress adjoints, once a cell, and the history's vx', vz';
// 2. the velocity adjoints on the tile (out, with the images) and its R
//    halo (the neighbours' arithmetic again), as (s b) vh in shared memory;
// 3. the stress adjoints on the tile, with the residual rows.
template <int R>
__global__ void __launch_bounds__(kAThreads, 2)
adjoint_step(Params p, const float* __restrict__ hist,
             const float* __restrict__ res, const float* __restrict__ vxb,
             const float* __restrict__ vzb, const float* __restrict__ txxb,
             const float* __restrict__ tzzb, const float* __restrict__ txzb,
             float* __restrict__ vxb_n, float* __restrict__ vzb_n,
             float* __restrict__ txxb_n, float* __restrict__ tzzb_n,
             float* __restrict__ txzb_n, float* __restrict__ glam,
             float* __restrict__ gmun, float* __restrict__ gmup,
             float* __restrict__ gb0, float* __restrict__ gb1, int t,
             int total, int nz, int nx, int z0, Coefs c) {
  using T = AdjTile<R>;
  extern __shared__ float sm[];
  float* sdx = sm;                       // (s lam) sum + (2 s mu) th_x
  float* sdz = sdx + T::SX * T::SZ;      // (s lam) sum + (2 s mu) th_z
  float* sgs = sdz + T::SX * T::SZ;      // (s mu01) th_xz
  float* sthx = sgs + T::SX * T::SZ;     // damp txxb on the tile
  float* sthz = sthx + kTX * kTZ;        // damp tzzb
  float* stho = sthz + kTX * kTZ;        // d01 txzb
  float* svx = stho + kTX * kTZ;         // the history's vx'
  float* svz = svx + T::VX * T::VZ;      // vz'
  float* sbx = svz + T::VX * T::VZ;      // (s b0) vhx
  float* sbz = sbx + T::VX * T::VZ;      // (s b1) vhz
  const int b = blockIdx.x;              // the shots of a tile adjoin
  const int xt = blockIdx.y * kTX;
  const int zt = blockIdx.z * kTZ;
  const int tid = threadIdx.x;
  const size_t field = (size_t)nz * nx;
  const size_t off = (size_t)b * field;
  const float* h = hist + ((size_t)b * total + t) * 4 * field;
  const float s = c.s;

  // 0. the images, the stored velocity adjoints and the history's
  // dtau_x, dtau_z of the tile's own cells, kCells a thread, read first:
  // their loads' latency hides under phase 1
  constexpr int kCells = kTX * kTZ / kAThreads;
  float g[5][kCells], vx0[kCells], vz0[kCells], hx[kCells], hz[kCells];
#pragma unroll
  for (int i = 0; i < kCells; ++i) {
    const int k = tid + i * kAThreads;
    const int gx = xt + k % kTX;
    const int gz = zt + k / kTX;
    const bool in = gx < nx && gz < nz;
    const size_t cell = (size_t)gz * nx + gx;
    const size_t o = off + cell;
    g[0][i] = in ? glam[o] : 0.0f;
    g[1][i] = in ? gmun[o] : 0.0f;
    g[2][i] = in ? gmup[o] : 0.0f;
    g[3][i] = in ? gb0[o] : 0.0f;
    g[4][i] = in ? gb1[o] : 0.0f;
    vx0[i] = in ? vxb[o] : 0.0f;
    vz0[i] = in ? vzb[o] : 0.0f;
    hx[i] = in ? h[2 * field + cell] : 0.0f;
    hz[i] = in ? h[3 * field + cell] : 0.0f;
  }

  // 1a. the derived fields on the tile and its 2R halo, zero beyond the
  // grid, as the first design's stress phase wrote them; the stored
  // stress adjoints of all of a thread's cells are read first
  constexpr int kN1 = (T::SX * T::SZ + kAThreads - 1) / kAThreads;
  float axx[kN1], azz[kN1], axz[kN1];
#pragma unroll
  for (int i = 0; i < kN1; ++i) {
    const int k = tid + i * kAThreads;
    const int lx = k % T::SX;
    const int lz = k / T::SX;
    const int gx = xt - 2 * R + lx;
    const int gz = zt - 2 * R + lz;
    const bool in = k < T::SX * T::SZ && derived_needed<R>(lx, lz) &&
                    gx >= 0 && gx < nx && gz >= 0 && gz < nz;
    const size_t o = off + (size_t)gz * nx + gx;
    axx[i] = in ? txxb[o] : 0.0f;
    azz[i] = in ? tzzb[o] : 0.0f;
    axz[i] = in ? txzb[o] : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < kN1; ++i) {
    const int k = tid + i * kAThreads;
    const int lx = k % T::SX;
    const int lz = k / T::SX;
    if (k >= T::SX * T::SZ || !derived_needed<R>(lx, lz)) continue;
    const int gx = xt - 2 * R + lx;
    const int gz = zt - 2 * R + lz;
    float dx = 0.0f, dz = 0.0f, gs = 0.0f;
    if (gx >= 0 && gx < nx && gz >= 0 && gz < nz) {
      const size_t cell = (size_t)gz * nx + gx;
      const float damp = p.damp[cell];
      const float thx = damp * axx[i];
      const float thz = damp * azz[i];
      const float tho = p.d01[cell] * axz[i];
      const float sthd = thx + thz;
      const float s_lam = s * p.lam[cell];
      const float two_s_mu = c.two_s * p.mu[cell];
      dx = s_lam * sthd + two_s_mu * thx;
      dz = s_lam * sthd + two_s_mu * thz;
      gs = (s * p.mu01[cell]) * tho;
      if (!outside(lx, 2 * R, kTX) && !outside(lz, 2 * R, kTZ)) {
        const int ti = (lz - 2 * R) * kTX + lx - 2 * R;
        sthx[ti] = thx;
        sthz[ti] = thz;
        stho[ti] = tho;
      }
    }
    sdx[k] = dx;
    sdz[k] = dz;
    sgs[k] = gs;
  }
  // 1b. the history's vx', vz' on the tile and an R halo along each axis
  constexpr int kN2 = (T::VX * T::VZ + kAThreads - 1) / kAThreads;
  float hvx[kN2], hvz[kN2];
#pragma unroll
  for (int i = 0; i < kN2; ++i) {
    const int k = tid + i * kAThreads;
    const int lx = k % T::VX;
    const int lz = k / T::VX;
    const int gx = xt - R + lx;
    const int gz = zt - R + lz;
    const bool in = k < T::VX * T::VZ &&
                    !(outside(lx, R, kTX) && outside(lz, R, kTZ)) &&
                    gx >= 0 && gx < nx && gz >= 0 && gz < nz;
    const size_t cell = (size_t)gz * nx + gx;
    hvx[i] = in ? h[cell] : 0.0f;
    hvz[i] = in ? h[field + cell] : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < kN2; ++i) {
    const int k = tid + i * kAThreads;
    if (k < T::VX * T::VZ) {
      svx[k] = hvx[i];
      svz[k] = hvz[i];
    }
  }
  __syncthreads();

  // 2a. the velocity adjoints on the tile: out, with the five images
#pragma unroll
  for (int i = 0; i < kCells; ++i) {
    const int k = tid + i * kAThreads;
    const int tx = k % kTX;
    const int tz = k / kTX;
    const int gx = xt + tx;
    const int gz = zt + tz;
    const int vi = (tz + R) * T::VX + tx + R;
    if (gx >= nx || gz >= nz) {
      sbx[vi] = 0.0f;
      sbz[vi] = 0.0f;
      continue;
    }
    const size_t cell = (size_t)gz * nx + gx;
    const size_t o = off + cell;
    const int si = (tz + 2 * R) * T::SX + tx + 2 * R;
    const float2 vh = vel_adjoint_at<R>(sdx, sdz, sgs, vx0[i], vz0[i],
                                        p.d0[cell], p.d1[cell], si, c);
    sbx[vi] = (s * p.b0[cell]) * vh.x;
    sbz[vi] = (s * p.b1[cell]) * vh.y;
    vxb_n[o] = vh.x;
    vzb_n[o] = vh.y;
    const float dvx = sderiv<R, kM>(svx + vi, 1, c.wm, c.ihx);
    const float dvz = sderiv<R, kM>(svz + vi, T::VX, c.wm, c.ihz);
    const float div = dvx + dvz;
    const float gg = sderiv<R, kP>(svx + vi, T::VX, c.wp, c.ihz) +
                     sderiv<R, kP>(svz + vi, 1, c.wp, c.ihx);
    const int ti = tz * kTX + tx;
    const float thx = sthx[ti];
    const float thz = sthz[ti];
    const float tho = stho[ti];
    const float sthd = thx + thz;
    glam[o] = g[0][i] + (s * div) * sthd;
    gmun[o] = g[1][i] + c.two_s * (dvx * thx + dvz * thz);
    gmup[o] = g[2][i] + (s * gg) * tho;
    gb0[o] = g[3][i] + (s * hx[i]) * vh.x;
    gb1[o] = g[4][i] + (s * hz[i]) * vh.y;
  }
  // 2b. the velocity adjoints on the R halo along each axis, to shared
  // memory only
  for (int k = tid; k < T::kArms; k += kAThreads) {
    int lx, lz;
    if (k < 2 * R * kTX) {  // the R rows above and below the tile
      const int kk = k % (R * kTX);
      lz = kk / kTX + (k / (R * kTX)) * (R + kTZ);
      lx = R + kk % kTX;
    } else {  // the R columns left and right of it
      const int kk = k - 2 * R * kTX;
      const int k2 = kk % (kTZ * R);
      lz = R + k2 / R;
      lx = (kk / (kTZ * R)) * (R + kTX) + k2 % R;
    }
    const int gx = xt - R + lx;
    const int gz = zt - R + lz;
    const int vi = lz * T::VX + lx;
    if (gx < 0 || gx >= nx || gz < 0 || gz >= nz) {
      sbx[vi] = 0.0f;
      sbz[vi] = 0.0f;
      continue;
    }
    const size_t cell = (size_t)gz * nx + gx;
    const int si = (lz + R) * T::SX + lx + R;
    const float2 vh =
        vel_adjoint_at<R>(sdx, sdz, sgs, vxb[off + cell], vzb[off + cell],
                          p.d0[cell], p.d1[cell], si, c);
    sbx[vi] = (s * p.b0[cell]) * vh.x;
    sbz[vi] = (s * p.b1[cell]) * vh.y;
  }
  __syncthreads();

  // 3. the stress adjoints on the tile from (s b) vh in shared memory, the
  // residual rows of step t on z0 and z0 + 1
#pragma unroll
  for (int i = 0; i < kCells; ++i) {
    const int k = tid + i * kAThreads;
    const int tx = k % kTX;
    const int tz = k / kTX;
    const int gx = xt + tx;
    const int gz = zt + tz;
    if (gx >= nx || gz >= nz) continue;
    const size_t o = off + (size_t)gz * nx + gx;
    const int vi = (tz + R) * T::VX + tx + R;
    const int ti = tz * kTX + tx;
    const float xx = sthx[ti] - sderiv<R, kM>(sbx + vi, 1, c.wm, c.ihx);
    float zz = sthz[ti] - sderiv<R, kM>(sbz + vi, T::VX, c.wm, c.ihz);
    const float xz =
        (stho[ti] - sderiv<R, kP>(sbx + vi, T::VX, c.wp, c.ihz)) -
        sderiv<R, kP>(sbz + vi, 1, c.wp, c.ihx);
    if (gz == z0 || gz == z0 + 1)
      zz = zz + res[(((size_t)b * total + t) * 2 + (gz - z0)) * nx + gx];
    txxb_n[o] = xx;
    tzzb_n[o] = zz;
    txzb_n[o] = xz;
  }
}

struct ForwardArgs {
  Params p;
  const float* wav;
  const int* src_cell;
  const float* src_val;
  float *rec, *hist, *illum, *scratch;
  int K, B, nz, nx, total, nsteps, z0, zlen;
  Coefs c;
  cudaStream_t stream;
};

// The batch stepped from zero state through all steps; scratch holds two
// states (vx, vz, txx, tzz, txz), swapped every step. One march launch a
// step: blockIdx.x the strip, .y the segment of zlen rows, .z the shot.
template <int R, int FLAGS>
int run_forward(const ForwardArgs& a) {
  using M = March<R>;
  cudaError_t err = cudaFuncSetAttribute(
      forward_step<R, FLAGS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)M::kBytes);
  if (err != cudaSuccess) return (int)err;
  const size_t n = (size_t)a.B * a.nz * a.nx;
  float* st[2][5];
  for (int k = 0; k < 2; ++k)
    for (int f = 0; f < 5; ++f) st[k][f] = a.scratch + (5 * k + f) * n;
  err = cudaMemsetAsync(st[0][0], 0, 5 * n * sizeof(float), a.stream);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.nx + M::W - 1) / M::W, (a.nz + a.zlen - 1) / a.zlen,
                  a.B);
  for (int t = 0; t < a.total; ++t) {
    float* const* cur = st[t & 1];
    float* const* nxt = st[(t & 1) ^ 1];
    forward_step<R, FLAGS><<<grid, kFThreads, M::kBytes, a.stream>>>(
        a.p, cur[0], cur[1], cur[2], cur[3], cur[4], nxt[0], nxt[1], nxt[2],
        nxt[3], nxt[4], a.wav, a.src_cell, a.src_val, a.K, a.rec, a.hist,
        a.illum, t, a.total, a.nsteps, a.nz, a.nx, a.z0, a.zlen, a.c);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

struct AdjointArgs {
  Params p;
  const float *hist, *res;
  float *glam, *gmun, *gmup, *gb0, *gb1, *scratch;
  int B, nz, nx, total, nsteps, z0;
  Coefs c;
  cudaStream_t stream;
};

// One fused launch a step; scratch holds two adjoint states (vxb, vzb,
// txxb, tzzb, txzb), swapped every step, the first zero.
template <int R>
int run_adjoint(const AdjointArgs& a) {
  using T = AdjTile<R>;
  cudaError_t err = cudaFuncSetAttribute(
      adjoint_step<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)T::kBytes);
  if (err != cudaSuccess) return (int)err;
  const size_t n = (size_t)a.B * a.nz * a.nx;
  float* st[2][5];
  for (int k = 0; k < 2; ++k)
    for (int f = 0; f < 5; ++f) st[k][f] = a.scratch + (5 * k + f) * n;
  err = cudaMemsetAsync(st[0][0], 0, 5 * n * sizeof(float), a.stream);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.B, (a.nx + kTX - 1) / kTX, (a.nz + kTZ - 1) / kTZ);
  // padded tail steps (t >= nsteps) are skipped in reverse
  for (int t = a.nsteps - 1, k = 0; t >= 0; --t, ++k) {
    float* const* cur = st[k & 1];
    float* const* nxt = st[(k & 1) ^ 1];
    adjoint_step<R><<<grid, kAThreads, T::kBytes, a.stream>>>(
        a.p, a.hist, a.res, cur[0], cur[1], cur[2], cur[3], cur[4], nxt[0],
        nxt[1], nxt[2], nxt[3], nxt[4], a.glam, a.gmun, a.gmup, a.gb0, a.gb1,
        t, a.total, a.nz, a.nx, a.z0, a.c);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

template <int R>
struct Fwd {
  static int run(const ForwardArgs& a) {
    return a.hist != NULL ? run_forward<R, kHist>(a) : run_forward<R, kRows>(a);
  }
};

template <int R>
struct Adj {
  static int run(const AdjointArgs& a) { return run_adjoint<R>(a); }
};

// The blocks of the forward march's modelling step an SM holds, or the
// negated CUDA error.
template <int R>
struct FwdBlocks {
  static int run(const int&) {
    using M = March<R>;
    cudaError_t err = cudaFuncSetAttribute(
        forward_step<R, kRows>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)M::kBytes);
    int n = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, forward_step<R, kRows>, kFThreads, M::kBytes);
    return err == cudaSuccess ? n : -(int)err;
  }
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

Coefs make_coefs(int r, const float* wp, const float* wm, const float* wc,
                 float ihx, float ihz, float s, float two_s) {
  Coefs c = {};
  for (int k = 0; k < 2 * r; ++k) {
    c.wp[k] = wp[k];
    c.wm[k] = wm[k];
  }
  for (int k = 0; k <= 2 * r; ++k) c.wc[k] = wc != NULL ? wc[k] : 0.0f;
  c.ihx = ihx;
  c.ihz = ihz;
  c.s = s;
  c.two_s = two_s;
  return c;
}

Params make_params(const float* lam, const float* mu, const float* b0,
                   const float* b1, const float* damp, const float* d0,
                   const float* d1, const float* mu01, const float* d01) {
  Params p = {lam, mu, b0, b1, damp, d0, d1, mu01, d01};
  return p;
}

}  // namespace

extern "C" {

// Forward sweep over t = 0 .. total-1 from zero fields. With hist == NULL
// (modeling) rec is (B, total, 2, 2, nx) and illum is NULL; otherwise rec
// is (B, total, 2, nx), hist (B, total, 4, nz, nx) and illum (B, nz, nx)
// holding zeros on entry. The source pattern inj (B, nz, nx) comes as its
// non-zero cells: src_cell (B, K) cell indices z * nx + x (-1 pads) and
// src_val (B, K) their values. scratch is 10 (B, nz, nx) fields, two
// states of vx, vz, txx, tzz, txz (the sweep zeroes them). Each step
// marches z in segments of zlen rows. wp and wm are the 2r taps of the D+
// and D- stencils, wc the 2r+1 of the centred one. Returns the first CUDA
// error of a launch, or 0.
int elastic2d_forward(const float* lam, const float* mu, const float* b0,
                      const float* b1, const float* damp, const float* d0,
                      const float* d1, const float* mu01, const float* d01,
                      const float* wav, const int* src_cell,
                      const float* src_val, int K, float* rec, float* hist,
                      float* illum, float* scratch, int B, int nz, int nx,
                      int total, int nsteps, int z0, int r, int zlen,
                      const float* wp, const float* wm, const float* wc,
                      float ihx, float ihz, float s, float two_s,
                      void* stream) {
  if (r < 1 || r > kMaxR || (hist == NULL) != (illum == NULL) ||
      z0 < 0 || z0 + 2 > nz || nsteps > total || K < 1 || B < 1 ||
      zlen < 1 || (size_t)nz * nx > 0x7fffffffu)
    return (int)cudaErrorInvalidValue;
  ForwardArgs a = {};
  a.p = make_params(lam, mu, b0, b1, damp, d0, d1, mu01, d01);
  a.wav = wav;
  a.src_cell = src_cell;
  a.src_val = src_val;
  a.rec = rec;
  a.hist = hist;
  a.illum = illum;
  a.scratch = scratch;
  a.K = K;
  a.B = B;
  a.nz = nz;
  a.nx = nx;
  a.total = total;
  a.nsteps = nsteps;
  a.z0 = z0;
  a.zlen = zlen;
  a.c = make_coefs(r, wp, wm, wc, ihx, ihz, s, two_s);
  a.stream = (cudaStream_t)stream;
  return dispatch_r<Fwd>(r, a);
}

// Reverse sweep over t = nsteps-1 .. 0 of a history of total steps, with the
// residual rows res (B, total, 2, nx). grads is 5 (B, nz, nx) images (lam,
// mu at the nodes, mu01, b0, b1) holding zeros on entry; scratch 10
// (B, nz, nx) fields, two adjoint states of vxb, vzb, txxb, tzzb, txzb (the
// sweep zeroes them). Returns the first CUDA error of a launch, or 0.
int elastic2d_adjoint(const float* lam, const float* mu, const float* b0,
                      const float* b1, const float* damp, const float* d0,
                      const float* d1, const float* mu01, const float* d01,
                      const float* hist, const float* res, float* grads,
                      float* scratch, int B, int nz, int nx, int total,
                      int nsteps, int z0, int r, const float* wp,
                      const float* wm, float ihx, float ihz, float s,
                      float two_s, void* stream) {
  if (r < 1 || r > kMaxR || z0 < 0 || z0 + 2 > nz || nsteps > total ||
      B < 1 || nx < 1 || (long long)nz * nx >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const size_t n = (size_t)B * nz * nx;
  AdjointArgs a = {};
  a.p = make_params(lam, mu, b0, b1, damp, d0, d1, mu01, d01);
  a.hist = hist;
  a.res = res;
  a.glam = grads;
  a.gmun = grads + n;
  a.gmup = grads + 2 * n;
  a.gb0 = grads + 3 * n;
  a.gb1 = grads + 4 * n;
  a.scratch = scratch;
  a.B = B;
  a.nz = nz;
  a.nx = nx;
  a.total = total;
  a.nsteps = nsteps;
  a.z0 = z0;
  a.c = make_coefs(r, wp, wm, NULL, ihx, ihz, s, two_s);
  a.stream = (cudaStream_t)stream;
  return dispatch_r<Adj>(r, a);
}

// The blocks of elastic2d_forward's modelling step an SM holds at radius
// r (the history step takes fewer registers); a negative value is the
// negated CUDA error.
int elastic2d_forward_blocks(int r) {
  if (r < 1 || r > kMaxR) return -(int)cudaErrorInvalidValue;
  return dispatch_r<FwdBlocks>(r, 0);
}

const char* elastic2d_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
