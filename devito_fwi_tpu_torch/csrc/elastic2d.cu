// 2-D velocity-stress elastic sweeps for Hopper (sm_90a), plain C interface
// for ctypes. Two entry points, each one sweep over all time steps of a shot
// batch, two kernel launches per step on the caller's stream:
//
//   elastic2d_forward(..., rec2 = 1, hist = NULL)
//       replaces _elastic_segments (devito_fwi_tpu/ops/pallas_staggered.py
//       :173, _elastic_kernel :79): forward modeling that records, at every
//       step, the two receiver rows of tau_zz and of div v (the centred
//       derivative of each velocity component on its own grid).
//   elastic2d_forward(..., rec2 = 0, hist != NULL)
//       replaces elastic_fwd_hist_segments (pallas_staggered.py:607,
//       _elastic_fwd_hist_kernel :508): the same forward recording only the
//       tau_zz rows, plus the history (vx', vz', dtau_x, dtau_z) of every
//       step and the illumination sum of vx'^2 + vz'^2 over the steps
//       t < nsteps.
//   elastic2d_adjoint
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
// averaged to +h/2 in x, b1, d1 in z, mu01, d01 in both); the source
// pattern inj (w * dt at the source's corners) is (B, nz, nx); receiver rows
// are (B, total, 2, 2, nx) for the modeling forward and (B, total, 2, nx)
// otherwise; the history is (B, total, 4, nz, nx).
//
// What bounds it on the card: the history forward writes
// B * total * 4 * nz * nx * 4 bytes (65 GB for the 31-shot SMARM2 batch) and
// the adjoint reads them back, so both are bound by device-memory bandwidth
// (about 19 ms each way at 3.35 TB/s); the modeling forward moves almost
// nothing and is bound by its ~100 float operations per cell and step (six
// eight-tap staggered derivatives and the updates). The state of all shots
// (7 forward or 13 reverse fields of 370 KB each for each of 31 shots,
// 80-150 MB) does not fit the 50 MB L2, so neighbour reads go partly to
// device memory.
//
// What the design does about it: one thread per cell, one launch per phase
// per step for the whole batch (blockIdx.z is the shot). A step has two
// phases because the stress update reads the new velocities at stencil
// distance: velocity (reads the stresses' neighbours, writes the new
// velocities into a second pair of buffers, the history and the receiver
// rows), then stress (reads the new velocities' neighbours, updates the
// stresses in place, since no thread of that phase reads another cell's
// stress). The reverse has two phases too: the velocity adjoint (reads the
// history's and three derived tau-adjoint fields' neighbours, updates the
// velocity adjoint and the five images in place), then the stress adjoint
// (reads the velocity adjoint's neighbours, updates the stress adjoint in
// place and writes, for the next step, the three derived fields
// (s lam) sum + (2 s mu) th_i and (s mu01) th_xz that the velocity phase
// reads at stencil distance). The fields of one step (5 carries + 9
// parameters of 370 KB each) do not fit a block's shared memory, so the
// neighbours come through L1/L2. Several steps per launch, shared-memory
// tiles and thread-block clusters are the next steps.
//
// Numerics: each update keeps the association of the Pallas kernels term
// for term ((s*b0)*dtau_x; (2s*mu)*dvx with 2s formed first; (s*div)*sum;
// every shifted derivative summed tap by tap in offset order, then scaled
// by 1/h; a zero tap, which the twins skip, adds nothing), and the library
// is compiled with
// -fmad=false, so the kernels round exactly like the plain torch twins in
// ops/cuda_staggered.py. Neighbours beyond the padded grid are zero. Offsets
// into the history and the rows are 64-bit.
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kMaxR = 8;
constexpr int kBX = 32;
constexpr int kBY = 8;

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

// Velocity phase of forward step t: vx, vz -> vxn, vzn (other buffers).
template <int R, int FLAGS>
__global__ void velocity_step(Params p, const float* __restrict__ vx,
                              const float* __restrict__ vz,
                              float* __restrict__ vxn_out,
                              float* __restrict__ vzn_out,
                              const float* __restrict__ txx,
                              const float* __restrict__ tzz,
                              const float* __restrict__ txz,
                              float* __restrict__ rec,
                              float* __restrict__ hist,
                              float* __restrict__ illum, int t, int total,
                              int nsteps, int nz, int nx, int z0, Coefs c) {
  const int x = blockIdx.x * kBX + threadIdx.x;
  const int z = blockIdx.y * kBY + threadIdx.y;
  const int b = blockIdx.z;
  if (x >= nx || z >= nz) return;
  const size_t field = (size_t)nz * nx;
  const size_t cell = (size_t)z * nx + x;
  const size_t o = (size_t)b * field + cell;
  const size_t bt = (size_t)b * total + t;
  const float* txx_b = txx + (size_t)b * field;
  const float* tzz_b = tzz + (size_t)b * field;
  const float* txz_b = txz + (size_t)b * field;

  if (z == z0 || z == z0 + 1) {
    const int plane = z - z0;
    if (FLAGS & kRows) {
      const float* vx_b = vx + (size_t)b * field;
      const float* vz_b = vz + (size_t)b * field;
      rec[((bt * 2 + 0) * 2 + plane) * nx + x] = tzz[o];
      const float div_c =
          ddx<R, kC>(vx_b, z, x, nx, c) + ddz<R, kC>(vz_b, z, x, nz, nx, c);
      rec[((bt * 2 + 1) * 2 + plane) * nx + x] = div_c;
    } else {
      rec[(bt * 2 + plane) * nx + x] = tzz[o];
    }
  }

  const float dtau_x =
      ddx<R, kP>(txx_b, z, x, nx, c) + ddz<R, kM>(txz_b, z, x, nz, nx, c);
  const float dtau_z =
      ddz<R, kP>(tzz_b, z, x, nz, nx, c) + ddx<R, kM>(txz_b, z, x, nx, c);
  const float vxn = p.d0[cell] * (vx[o] + (c.s * p.b0[cell]) * dtau_x);
  const float vzn = p.d1[cell] * (vz[o] + (c.s * p.b1[cell]) * dtau_z);
  vxn_out[o] = vxn;
  vzn_out[o] = vzn;
  if (FLAGS & kHist) {
    float* h = hist + bt * 4 * field + cell;
    h[0] = vxn;
    h[field] = vzn;
    h[2 * field] = dtau_x;
    h[3 * field] = dtau_z;
    if (t < nsteps) {
      float il = illum[o];
      il = il + vxn * vxn;
      il = il + vzn * vzn;
      illum[o] = il;
    }
  }
}

// Stress phase of forward step t: the stresses in place from the new
// velocities, then the source at step t.
template <int R>
__global__ void stress_step(Params p, const float* __restrict__ vxn,
                            const float* __restrict__ vzn,
                            float* __restrict__ txx, float* __restrict__ tzz,
                            float* __restrict__ txz,
                            const float* __restrict__ wav,
                            const float* __restrict__ inj, int t, int nz,
                            int nx, Coefs c) {
  const int x = blockIdx.x * kBX + threadIdx.x;
  const int z = blockIdx.y * kBY + threadIdx.y;
  const int b = blockIdx.z;
  if (x >= nx || z >= nz) return;
  const size_t field = (size_t)nz * nx;
  const size_t cell = (size_t)z * nx + x;
  const size_t o = (size_t)b * field + cell;
  const float* vx_b = vxn + (size_t)b * field;
  const float* vz_b = vzn + (size_t)b * field;

  const float dvx = ddx<R, kM>(vx_b, z, x, nx, c);
  const float dvz = ddz<R, kM>(vz_b, z, x, nz, nx, c);
  const float div = dvx + dvz;
  const float s_lam = c.s * p.lam[cell];
  const float two_s_mu = c.two_s * p.mu[cell];
  const float damp = p.damp[cell];
  const float txxn = damp * ((txx[o] + s_lam * div) + two_s_mu * dvx);
  const float tzzn = damp * ((tzz[o] + s_lam * div) + two_s_mu * dvz);
  const float g =
      ddz<R, kP>(vx_b, z, x, nz, nx, c) + ddx<R, kP>(vz_b, z, x, nx, c);
  const float txzn = p.d01[cell] * (txz[o] + (c.s * p.mu01[cell]) * g);
  const float wt = wav[t];
  txx[o] = txxn + wt * inj[o];
  tzz[o] = tzzn + wt * inj[o];
  txz[o] = txzn;
}

// Velocity-adjoint phase of reverse step t (history step th of ht):
// the images, then vxb, vzb in place.
template <int R>
__global__ void adjoint_v_step(Params p, const float* __restrict__ hist,
                               float* __restrict__ vxb,
                               float* __restrict__ vzb,
                               const float* __restrict__ txxb,
                               const float* __restrict__ tzzb,
                               const float* __restrict__ txzb,
                               const float* __restrict__ dvbx,
                               const float* __restrict__ dvbz,
                               const float* __restrict__ gbs,
                               float* __restrict__ glam,
                               float* __restrict__ gmun,
                               float* __restrict__ gmup,
                               float* __restrict__ gb0,
                               float* __restrict__ gb1, int th, int ht,
                               int nz, int nx, Coefs c) {
  const int x = blockIdx.x * kBX + threadIdx.x;
  const int z = blockIdx.y * kBY + threadIdx.y;
  const int b = blockIdx.z;
  if (x >= nx || z >= nz) return;
  const size_t field = (size_t)nz * nx;
  const size_t cell = (size_t)z * nx + x;
  const size_t o = (size_t)b * field + cell;
  const float* h = hist + ((size_t)b * ht + th) * 4 * field;
  const float* vnx = h;
  const float* vnz = h + field;

  const float dvx = ddx<R, kM>(vnx, z, x, nx, c);
  const float dvz = ddz<R, kM>(vnz, z, x, nz, nx, c);
  const float div = dvx + dvz;
  const float g =
      ddz<R, kP>(vnx, z, x, nz, nx, c) + ddx<R, kP>(vnz, z, x, nx, c);
  const float damp = p.damp[cell];
  const float thx = damp * txxb[o];
  const float thz = damp * tzzb[o];
  const float tho = p.d01[cell] * txzb[o];
  const float sthd = thx + thz;
  glam[o] = glam[o] + (c.s * div) * sthd;
  gmun[o] = gmun[o] + c.two_s * (dvx * thx + dvz * thz);
  gmup[o] = gmup[o] + (c.s * g) * tho;

  const float* dvbx_b = dvbx + (size_t)b * field;
  const float* dvbz_b = dvbz + (size_t)b * field;
  const float* gbs_b = gbs + (size_t)b * field;
  const float vbtx = (vxb[o] - ddx<R, kP>(dvbx_b, z, x, nx, c)) -
                     ddz<R, kM>(gbs_b, z, x, nz, nx, c);
  const float vbtz = (vzb[o] - ddz<R, kP>(dvbz_b, z, x, nz, nx, c)) -
                     ddx<R, kM>(gbs_b, z, x, nx, c);
  const float vhx = p.d0[cell] * vbtx;
  const float vhz = p.d1[cell] * vbtz;
  gb0[o] = gb0[o] + (c.s * h[2 * field + cell]) * vhx;
  gb1[o] = gb1[o] + (c.s * h[3 * field + cell]) * vhz;
  vxb[o] = vhx;
  vzb[o] = vhz;
}

// Stress-adjoint phase of reverse step t: txxb, tzzb, txzb in place from
// the velocity adjoint's neighbours, the residual rows of step t on z0 and
// z0 + 1, then the three derived fields the next velocity phase reads.
template <int R>
__global__ void adjoint_tau_step(Params p, const float* __restrict__ vxb,
                                 const float* __restrict__ vzb,
                                 float* __restrict__ txxb,
                                 float* __restrict__ tzzb,
                                 float* __restrict__ txzb,
                                 float* __restrict__ dvbx,
                                 float* __restrict__ dvbz,
                                 float* __restrict__ gbs,
                                 const float* __restrict__ res, int t,
                                 int total, int nz, int nx, int z0,
                                 Coefs c) {
  const int x = blockIdx.x * kBX + threadIdx.x;
  const int z = blockIdx.y * kBY + threadIdx.y;
  const int b = blockIdx.z;
  if (x >= nx || z >= nz) return;
  const size_t field = (size_t)nz * nx;
  const size_t cell = (size_t)z * nx + x;
  const size_t o = (size_t)b * field + cell;
  const float* vx_b = vxb + (size_t)b * field;
  const float* vz_b = vzb + (size_t)b * field;
  const float s = c.s;
  const float* b0 = p.b0;
  const float* b1 = p.b1;
  // dtb_i = (s * b_i) * vh_i at a neighbour of the same row / column
  const float* rx = vx_b + (size_t)z * nx;
  const float* rz = vz_b + (size_t)z * nx;
  const float* b0r = b0 + (size_t)z * nx;
  const float* b1r = b1 + (size_t)z * nx;
  auto dtbx_x = [&](int j) { return (s * b0r[j]) * rx[j]; };
  auto dtbz_x = [&](int j) { return (s * b1r[j]) * rz[j]; };
  auto dtbx_z = [&](int j) {
    const size_t q = (size_t)j * nx + x;
    return (s * b0[q]) * vx_b[q];
  };
  auto dtbz_z = [&](int j) {
    const size_t q = (size_t)j * nx + x;
    return (s * b1[q]) * vz_b[q];
  };

  const float damp = p.damp[cell];
  const float d01 = p.d01[cell];
  const float thx = damp * txxb[o];
  const float thz = damp * tzzb[o];
  const float tho = d01 * txzb[o];
  const float txxb_n = thx - deriv<R, kM>(dtbx_x, x, nx, c.wm, c.ihx);
  float tzzb_n = thz - deriv<R, kM>(dtbz_z, z, nz, c.wm, c.ihz);
  const float txzb_n = (tho - deriv<R, kP>(dtbx_z, z, nz, c.wp, c.ihz)) -
                       deriv<R, kP>(dtbz_x, x, nx, c.wp, c.ihx);
  if (z == z0 || z == z0 + 1)
    tzzb_n = tzzb_n + res[(((size_t)b * total + t) * 2 + (z - z0)) * nx + x];
  txxb[o] = txxb_n;
  tzzb[o] = tzzb_n;
  txzb[o] = txzb_n;

  const float thx2 = damp * txxb_n;
  const float thz2 = damp * tzzb_n;
  const float tho2 = d01 * txzb_n;
  const float sthd2 = thx2 + thz2;
  const float s_lam = s * p.lam[cell];
  const float two_s_mu = c.two_s * p.mu[cell];
  dvbx[o] = s_lam * sthd2 + two_s_mu * thx2;
  dvbz[o] = s_lam * sthd2 + two_s_mu * thz2;
  gbs[o] = (s * p.mu01[cell]) * tho2;
}

struct ForwardArgs {
  Params p;
  const float *wav, *inj;
  float *rec, *hist, *illum;
  float *vx, *vz, *vx2, *vz2, *txx, *tzz, *txz;
  int B, nz, nx, total, nsteps, z0;
  Coefs c;
  cudaStream_t stream;
};

template <int R, int FLAGS>
int run_forward(ForwardArgs a) {
  const dim3 block(kBX, kBY);
  const dim3 grid((a.nx + kBX - 1) / kBX, (a.nz + kBY - 1) / kBY, a.B);
  for (int t = 0; t < a.total; ++t) {
    velocity_step<R, FLAGS><<<grid, block, 0, a.stream>>>(
        a.p, a.vx, a.vz, a.vx2, a.vz2, a.txx, a.tzz, a.txz, a.rec, a.hist,
        a.illum, t, a.total, a.nsteps, a.nz, a.nx, a.z0, a.c);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    stress_step<R><<<grid, block, 0, a.stream>>>(
        a.p, a.vx2, a.vz2, a.txx, a.tzz, a.txz, a.wav, a.inj, t, a.nz, a.nx,
        a.c);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    float* tmp = a.vx;
    a.vx = a.vx2;
    a.vx2 = tmp;
    tmp = a.vz;
    a.vz = a.vz2;
    a.vz2 = tmp;
  }
  return 0;
}

struct AdjointArgs {
  Params p;
  const float *hist, *res;
  float *glam, *gmun, *gmup, *gb0, *gb1;
  float *vxb, *vzb, *txxb, *tzzb, *txzb, *dvbx, *dvbz, *gbs;
  int B, nz, nx, total, nsteps, z0;
  Coefs c;
  cudaStream_t stream;
};

template <int R>
int run_adjoint(AdjointArgs a) {
  const dim3 block(kBX, kBY);
  const dim3 grid((a.nx + kBX - 1) / kBX, (a.nz + kBY - 1) / kBY, a.B);
  // padded tail steps (t >= nsteps) are skipped in reverse
  for (int t = a.nsteps - 1; t >= 0; --t) {
    adjoint_v_step<R><<<grid, block, 0, a.stream>>>(
        a.p, a.hist, a.vxb, a.vzb, a.txxb, a.tzzb, a.txzb, a.dvbx, a.dvbz,
        a.gbs, a.glam, a.gmun, a.gmup, a.gb0, a.gb1, t, a.total, a.nz, a.nx,
        a.c);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    adjoint_tau_step<R><<<grid, block, 0, a.stream>>>(
        a.p, a.vxb, a.vzb, a.txxb, a.tzzb, a.txzb, a.dvbx, a.dvbz, a.gbs,
        a.res, t, a.total, a.nz, a.nx, a.z0, a.c);
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
// holding zeros on entry. scratch is 7 (B, nz, nx) fields holding zeros:
// vx, vz, the second velocity pair, txx, tzz, txz. wp and wm are the 2r
// taps of the D+ and D- stencils, wc the 2r+1 of the centred one. Returns
// the first CUDA error of a launch, or 0.
int elastic2d_forward(const float* lam, const float* mu, const float* b0,
                      const float* b1, const float* damp, const float* d0,
                      const float* d1, const float* mu01, const float* d01,
                      const float* wav, const float* inj, float* rec,
                      float* hist, float* illum, float* scratch, int B,
                      int nz, int nx, int total, int nsteps, int z0, int r,
                      const float* wp, const float* wm, const float* wc,
                      float ihx, float ihz, float s, float two_s,
                      void* stream) {
  if (r < 1 || r > kMaxR || (hist == NULL) != (illum == NULL) ||
      z0 < 0 || z0 + 2 > nz || nsteps > total)
    return (int)cudaErrorInvalidValue;
  const size_t n = (size_t)B * nz * nx;
  ForwardArgs a = {};
  a.p = make_params(lam, mu, b0, b1, damp, d0, d1, mu01, d01);
  a.wav = wav;
  a.inj = inj;
  a.rec = rec;
  a.hist = hist;
  a.illum = illum;
  a.vx = scratch;
  a.vz = scratch + n;
  a.vx2 = scratch + 2 * n;
  a.vz2 = scratch + 3 * n;
  a.txx = scratch + 4 * n;
  a.tzz = scratch + 5 * n;
  a.txz = scratch + 6 * n;
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
// mu at the nodes, mu01, b0, b1) and scratch 8 (B, nz, nx) fields (vxb, vzb,
// txxb, tzzb, txzb and the three derived fields), all holding zeros on
// entry. Returns the first CUDA error of a launch, or 0.
int elastic2d_adjoint(const float* lam, const float* mu, const float* b0,
                      const float* b1, const float* damp, const float* d0,
                      const float* d1, const float* mu01, const float* d01,
                      const float* hist, const float* res, float* grads,
                      float* scratch, int B, int nz, int nx, int total,
                      int nsteps, int z0, int r, const float* wp,
                      const float* wm, float ihx, float ihz, float s,
                      float two_s, void* stream) {
  if (r < 1 || r > kMaxR || z0 < 0 || z0 + 2 > nz || nsteps > total)
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
  a.vxb = scratch;
  a.vzb = scratch + n;
  a.txxb = scratch + 2 * n;
  a.tzzb = scratch + 3 * n;
  a.txzb = scratch + 4 * n;
  a.dvbx = scratch + 5 * n;
  a.dvbz = scratch + 6 * n;
  a.gbs = scratch + 7 * n;
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
