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
// What the forward's design does about it: one launch a step, a block a
// kTX x kTZ tile of one shot (forward_step). The block loads the old
// stresses on its tile and a 2R halo into shared memory once, computes the
// new velocities on the tile and an R halo from them (the halo repeats the
// neighbours' arithmetic, so it rounds alike), then the tile's stresses
// from the velocities in shared memory; old and new state are two buffers,
// swapped every step. The source adds only at its cells. Measured
// (chip_smoke.py phase 13, H100 80GB HBM3 at 700 W; PERF.md, kernel table
// rows 18 and 20): the modeling sweep 128.5 ms against the first design's
// 170.9 ms, 90.5 us a step against the fused floor's 34.2 us, and the
// history sweep 165.0 ms against 226.4 ms: 1.33x and 1.37x, short of the
// 2x aimed at. The step runs about 400 instructions a cell (four 8-tap
// derivatives a side at two float operations a tap under -fmad=false, the
// halo's recompute, the tile and parameter loads) and is bound by that
// instruction rate and latency, not bytes: shot groups that fit the L2
// and a padded row pitch made it no faster.
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

// Forward step t of a shot batch, one launch: a block takes a kTX x kTZ
// tile of one shot. It loads the old stresses on the tile and a 2R halo
// into shared memory (zeros beyond the grid), computes the new velocities
// on the tile and an R halo from them (the halo repeats the neighbouring
// blocks' arithmetic, so it rounds the same), writes the tile's velocities
// and what FLAGS ask for, then updates the tile's stresses from the
// velocities in shared memory. Old and new state are separate buffers: a
// neighbour's halo reads the old stresses.
constexpr int kTX = 32;
constexpr int kTZ = 32;
constexpr int kFThreads = 512;

template <int R>
struct FwdTile {
  static constexpr int SX = kTX + 4 * R;  // stresses: the tile + 2R halo
  static constexpr int SZ = kTZ + 4 * R;
  static constexpr int VX = kTX + 2 * R;  // velocities: the tile + R halo
  static constexpr int VZ = kTZ + 2 * R;
  static constexpr int kRing = 2 * R * VX + 2 * R * kTZ;
  static constexpr size_t kBytes =
      sizeof(float) * (3 * SX * SZ + 2 * VX * VZ);
};

// The shifted derivative from a shared-memory tile: the taps at
// s[tap(k) * stride] around the centre s, summed in tap order, times ih;
// the tile holds zeros beyond the grid, as deriv reads them.
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

struct Vel {
  float vx, vz, dtau_x, dtau_z;
};

// The new velocities at stress-tile index si, grid cell ``cell`` of a shot
// whose old velocities are vx_b, vz_b.
template <int R>
__device__ __forceinline__ Vel velocity_at(const Params& p,
                                           const float* sxx,
                                           const float* szz,
                                           const float* sxz,
                                           const float* __restrict__ vx_b,
                                           const float* __restrict__ vz_b,
                                           int si, size_t cell,
                                           const Coefs& c) {
  constexpr int SX = FwdTile<R>::SX;
  Vel v;
  v.dtau_x = sderiv<R, kP>(sxx + si, 1, c.wp, c.ihx) +
             sderiv<R, kM>(sxz + si, SX, c.wm, c.ihz);
  v.dtau_z = sderiv<R, kP>(szz + si, SX, c.wp, c.ihz) +
             sderiv<R, kM>(sxz + si, 1, c.wm, c.ihx);
  v.vx = p.d0[cell] * (vx_b[cell] + (c.s * p.b0[cell]) * v.dtau_x);
  v.vz = p.d1[cell] * (vz_b[cell] + (c.s * p.b1[cell]) * v.dtau_z);
  return v;
}

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
             int nx, int z0, Coefs c) {
  using T = FwdTile<R>;
  extern __shared__ float sm[];
  float* sxx = sm;
  float* szz = sxx + T::SX * T::SZ;
  float* sxz = szz + T::SX * T::SZ;
  float* svx = sxz + T::SX * T::SZ;
  float* svz = svx + T::VX * T::VZ;
  const int xt = blockIdx.x * kTX;
  const int zt = blockIdx.y * kTZ;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const size_t field = (size_t)nz * nx;
  const size_t off = (size_t)b * field;
  const float* vx_b = vx + off;
  const float* vz_b = vz + off;

  // 1. the old stresses on the tile and its 2R halo
  for (int k = tid; k < T::SX * T::SZ; k += kFThreads) {
    const int gx = xt - 2 * R + k % T::SX;
    const int gz = zt - 2 * R + k / T::SX;
    float axx = 0.0f, azz = 0.0f, axz = 0.0f;
    if (gx >= 0 && gx < nx && gz >= 0 && gz < nz) {
      const size_t o = off + (size_t)gz * nx + gx;
      axx = txx[o];
      azz = tzz[o];
      axz = txz[o];
    }
    sxx[k] = axx;
    szz[k] = azz;
    sxz[k] = axz;
  }
  __syncthreads();

  // 2a. the new velocities on the tile: to shared memory and out, with the
  // receiver rows, the history and the illumination
  const size_t bt = (size_t)b * total + t;
  for (int k = tid; k < kTX * kTZ; k += kFThreads) {
    const int tx = k % kTX;
    const int tz = k / kTX;
    const int gx = xt + tx;
    const int gz = zt + tz;
    const int vi = (tz + R) * T::VX + tx + R;
    if (gx >= nx || gz >= nz) {
      svx[vi] = 0.0f;
      svz[vi] = 0.0f;
      continue;
    }
    const size_t cell = (size_t)gz * nx + gx;
    const size_t o = off + cell;
    const int si = (tz + 2 * R) * T::SX + tx + 2 * R;
    const Vel v = velocity_at<R>(p, sxx, szz, sxz, vx_b, vz_b, si, cell, c);
    svx[vi] = v.vx;
    svz[vi] = v.vz;
    vx_out[o] = v.vx;
    vz_out[o] = v.vz;
    if (gz == z0 || gz == z0 + 1) {
      const int plane = gz - z0;
      if (FLAGS & kRows) {
        rec[((bt * 2 + 0) * 2 + plane) * nx + gx] = szz[si];
        const float div_c = ddx<R, kC>(vx_b, gz, gx, nx, c) +
                            ddz<R, kC>(vz_b, gz, gx, nz, nx, c);
        rec[((bt * 2 + 1) * 2 + plane) * nx + gx] = div_c;
      } else {
        rec[(bt * 2 + plane) * nx + gx] = szz[si];
      }
    }
    if (FLAGS & kHist) {
      float* h = hist + bt * 4 * field + cell;
      h[0] = v.vx;
      h[field] = v.vz;
      h[2 * field] = v.dtau_x;
      h[3 * field] = v.dtau_z;
      if (t < nsteps) {
        float il = illum[o];
        il = il + v.vx * v.vx;
        il = il + v.vz * v.vz;
        illum[o] = il;
      }
    }
  }
  // 2b. the new velocities on the R halo around the tile, to shared memory
  for (int k = tid; k < T::kRing; k += kFThreads) {
    int lx, lz;
    if (k < 2 * R * T::VX) {  // the R rows above and below the tile
      const int kk = k % (R * T::VX);
      lz = kk / T::VX + (k / (R * T::VX)) * (R + kTZ);
      lx = kk % T::VX;
    } else {  // the R columns left and right of it
      const int kk = k - 2 * R * T::VX;
      const int k2 = kk % (kTZ * R);
      lz = R + k2 / R;
      lx = (kk / (kTZ * R)) * (R + kTX) + k2 % R;
    }
    const int gx = xt - R + lx;
    const int gz = zt - R + lz;
    const int vi = lz * T::VX + lx;
    if (gx < 0 || gx >= nx || gz < 0 || gz >= nz) {
      svx[vi] = 0.0f;
      svz[vi] = 0.0f;
      continue;
    }
    const size_t cell = (size_t)gz * nx + gx;
    const int si = (lz + R) * T::SX + lx + R;
    const Vel v = velocity_at<R>(p, sxx, szz, sxz, vx_b, vz_b, si, cell, c);
    svx[vi] = v.vx;
    svz[vi] = v.vz;
  }
  __syncthreads();

  // 3. the stresses on the tile from the new velocities, then the source
  // at step t on inj's non-zero cells of the shot (adding wt * 0 elsewhere
  // would change no value)
  const float wt = wav[t];
  const int* cells_b = src_cell + (size_t)b * K;
  const float* vals_b = src_val + (size_t)b * K;
  for (int k = tid; k < kTX * kTZ; k += kFThreads) {
    const int tx = k % kTX;
    const int tz = k / kTX;
    const int gx = xt + tx;
    const int gz = zt + tz;
    if (gx >= nx || gz >= nz) continue;
    const size_t cell = (size_t)gz * nx + gx;
    const size_t o = off + cell;
    const int vi = (tz + R) * T::VX + tx + R;
    const int si = (tz + 2 * R) * T::SX + tx + 2 * R;
    const float dvx = sderiv<R, kM>(svx + vi, 1, c.wm, c.ihx);
    const float dvz = sderiv<R, kM>(svz + vi, T::VX, c.wm, c.ihz);
    const float div = dvx + dvz;
    const float s_lam = c.s * p.lam[cell];
    const float two_s_mu = c.two_s * p.mu[cell];
    const float damp = p.damp[cell];
    float txxn = damp * ((sxx[si] + s_lam * div) + two_s_mu * dvx);
    float tzzn = damp * ((szz[si] + s_lam * div) + two_s_mu * dvz);
    const float g = sderiv<R, kP>(svx + vi, T::VX, c.wp, c.ihz) +
                    sderiv<R, kP>(svz + vi, 1, c.wp, c.ihx);
    const float txzn = p.d01[cell] * (sxz[si] + (c.s * p.mu01[cell]) * g);
    for (int q = 0; q < K; ++q) {
      if (cells_b[q] == (int)cell) {
        const float w = wt * vals_b[q];
        txxn = txxn + w;
        tzzn = tzzn + w;
      }
    }
    txx_out[o] = txxn;
    tzz_out[o] = tzzn;
    txz_out[o] = txzn;
  }
}

// The fused reverse step's tile (adjoint_step): kTX x kTZ cells of one
// shot, kAThreads threads. In shared memory: the three derived stress-
// adjoint fields on the tile and a 2R halo (the outer corners beyond R of
// both axes are not needed and not loaded); damp txxb, damp tzzb and
// d01 txzb on the tile; the history's vx', vz' and the two products
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
  int K, B, nz, nx, total, nsteps, z0;
  Coefs c;
  cudaStream_t stream;
};

// The batch stepped from zero state through all steps; scratch holds two
// states (vx, vz, txx, tzz, txz), swapped every step.
template <int R, int FLAGS>
int run_forward(const ForwardArgs& a) {
  using T = FwdTile<R>;
  cudaError_t err = cudaFuncSetAttribute(
      forward_step<R, FLAGS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)T::kBytes);
  if (err != cudaSuccess) return (int)err;
  const size_t n = (size_t)a.B * a.nz * a.nx;
  float* st[2][5];
  for (int k = 0; k < 2; ++k)
    for (int f = 0; f < 5; ++f) st[k][f] = a.scratch + (5 * k + f) * n;
  err = cudaMemsetAsync(st[0][0], 0, 5 * n * sizeof(float), a.stream);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.nx + kTX - 1) / kTX, (a.nz + kTZ - 1) / kTZ, a.B);
  for (int t = 0; t < a.total; ++t) {
    float* const* cur = st[t & 1];
    float* const* nxt = st[(t & 1) ^ 1];
    forward_step<R, FLAGS><<<grid, kFThreads, T::kBytes, a.stream>>>(
        a.p, cur[0], cur[1], cur[2], cur[3], cur[4], nxt[0], nxt[1], nxt[2],
        nxt[3], nxt[4], a.wav, a.src_cell, a.src_val, a.K, a.rec, a.hist,
        a.illum, t, a.total, a.nsteps, a.nz, a.nx, a.z0, a.c);
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
// states of vx, vz, txx, tzz, txz (the sweep zeroes them). wp and wm are the 2r taps of the D+ and D-
// stencils, wc the 2r+1 of the centred one. Returns the first CUDA error
// of a launch, or 0.
int elastic2d_forward(const float* lam, const float* mu, const float* b0,
                      const float* b1, const float* damp, const float* d0,
                      const float* d1, const float* mu01, const float* d01,
                      const float* wav, const int* src_cell,
                      const float* src_val, int K, float* rec, float* hist,
                      float* illum, float* scratch, int B, int nz, int nx,
                      int total, int nsteps, int z0, int r,
                      const float* wp, const float* wm, const float* wc,
                      float ihx, float ihz, float s, float two_s,
                      void* stream) {
  if (r < 1 || r > kMaxR || (hist == NULL) != (illum == NULL) ||
      z0 < 0 || z0 + 2 > nz || nsteps > total || K < 1 || B < 1 ||
      (size_t)nz * nx > 0x7fffffffu)
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

const char* elastic2d_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
