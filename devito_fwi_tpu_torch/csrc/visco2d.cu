// 2-D viscoacoustic SLS 2nd-order sweeps for Hopper (sm_90a), plain C
// interface for ctypes. Two entry points, each one sweep over all time steps
// of a shot batch, two kernel launches per step on the caller's stream:
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
// (w dt^2 vp^2 at the source's corners) and injw (w) are (B, nz, nx);
// receiver and residual rows are (B, total, 2, nx); the history is
// (B, total, 2, nz, nx).
//
// What bounds it on the card: the history forward writes
// B * total * 2 * nz * nx * 4 bytes (21.9 GB for the 29-shot SMARMN batch)
// and the adjoint reads them back, so both are bound by device-memory
// bandwidth (about 6.5 ms each way at 3.35 TB/s); the modeling forward moves
// almost nothing and is bound by its ~80 float operations per cell and step
// (four eight-tap staggered derivatives and the update).
//
// What the design does about it: one thread per cell, one launch per phase
// per step for the whole batch (blockIdx.z is the shot). L is a derivative
// of b times a derivative, so a step has two phases: the flux phase writes
// b D+x p and b D+z p (forward), or b D+x(C P), b D+z(C P), b D+x(A R),
// b D+z(A R) with P and R formed pointwise at each neighbour (reverse), into
// scratch fields; the update phase reads those fluxes at stencil distance
// and only its own cell of every other field, so it updates the state in
// place (the forward writes pn over pp and swaps the two). Both derivatives
// see zeros beyond the padded grid: the inner one reads zero p (or C P,
// A R), the outer one zero flux. The fields of one step do not fit a block's
// shared memory; neighbours come through L1/L2. Several steps per launch,
// shared-memory tiles and thread-block clusters are the next steps.
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
constexpr int kBX = 32;
constexpr int kBY = 8;

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

// sum_k w[k] * f(i + tap(k)) in tap order, zero beyond 0..n-1, times ih
template <int R, int KIND, class F>
__device__ __forceinline__ float deriv(F f, int i, int n, const float* w,
                                       float ih) {
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < 2 * R; ++k) {
    const int j = i + tap<R, KIND>(k);
    const float v = (j >= 0 && j < n) ? f(j) : 0.0f;
    const float term = w[k] * v;
    acc = k == 0 ? term : acc + term;
  }
  return acc * ih;
}

template <int KIND>
__device__ __forceinline__ const float* weights(const Coefs& c) {
  return KIND == kP ? c.wp : c.wm;
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

// Flux phase of forward step t: the receiver rows of p, then b D+x p and
// b D+z p.
template <int R>
__global__ void flux_step(const float* __restrict__ b,
                          const float* __restrict__ p,
                          float* __restrict__ gx, float* __restrict__ gz,
                          float* __restrict__ rec, int t, int total, int nz,
                          int nx, int z0, Coefs c) {
  const int x = blockIdx.x * kBX + threadIdx.x;
  const int z = blockIdx.y * kBY + threadIdx.y;
  const int s = blockIdx.z;
  if (x >= nx || z >= nz) return;
  const size_t field = (size_t)nz * nx;
  const size_t cell = (size_t)z * nx + x;
  const size_t o = (size_t)s * field + cell;
  const float* ps = p + (size_t)s * field;
  if (z == z0 || z == z0 + 1)
    rec[(((size_t)s * total + t) * 2 + (z - z0)) * nx + x] = p[o];
  const float bc = b[cell];
  gx[o] = bc * ddx<R, kP>(ps, z, x, nx, c);
  gz[o] = bc * ddz<R, kP>(ps, z, x, nz, nx, c);
}

// Update phase of forward step t: L from the fluxes, rn and pn; pn goes over
// pp (the caller swaps p and pp), rn over r.
template <int R, bool HIST>
__global__ void update_step(Params q, const float* __restrict__ gx,
                            const float* __restrict__ gz,
                            const float* __restrict__ p,
                            float* __restrict__ pp, float* __restrict__ r,
                            const float* __restrict__ wav,
                            const float* __restrict__ inj,
                            float* __restrict__ hist,
                            float* __restrict__ illum, int t, int total,
                            int nsteps, int nz, int nx, Coefs c) {
  const int x = blockIdx.x * kBX + threadIdx.x;
  const int z = blockIdx.y * kBY + threadIdx.y;
  const int s = blockIdx.z;
  if (x >= nx || z >= nz) return;
  const size_t field = (size_t)nz * nx;
  const size_t cell = (size_t)z * nx + x;
  const size_t o = (size_t)s * field + cell;
  const float L = ddx<R, kM>(gx + (size_t)s * field, z, x, nx, c) +
                  ddz<R, kM>(gz + (size_t)s * field, z, x, nz, nx, c);
  const float damp = q.damp[cell];
  const float rv = r[o];
  const float rn = damp * ((rv + q.A[cell] * L) - q.B[cell] * rv);
  const float pv = p[o];
  float pn = damp * ((((2.0f * pv) - damp * pp[o]) + q.C[cell] * L) -
                     q.D[cell] * rn);
  pn = pn + wav[t] * inj[o];
  if (HIST) {
    float* h = hist + ((size_t)s * total + t) * 2 * field + cell;
    h[0] = L;
    h[field] = rn;
    if (t < nsteps) illum[o] = illum[o] + pn * pn;
  }
  pp[o] = pn;
  r[o] = rn;
}

// Flux phase of reverse step t: b D+x(C P), b D+z(C P), b D+x(A R) and
// b D+z(A R), with P = damp lp and R = damp (lr - D P) formed at each
// neighbour.
template <int R>
__global__ void adjoint_flux(Params q, const float* __restrict__ lp,
                             const float* __restrict__ lr,
                             float* __restrict__ f1x, float* __restrict__ f1z,
                             float* __restrict__ f2x, float* __restrict__ f2z,
                             int nz, int nx, Coefs c) {
  const int x = blockIdx.x * kBX + threadIdx.x;
  const int z = blockIdx.y * kBY + threadIdx.y;
  const int s = blockIdx.z;
  if (x >= nx || z >= nz) return;
  const size_t field = (size_t)nz * nx;
  const size_t cell = (size_t)z * nx + x;
  const size_t o = (size_t)s * field + cell;
  const float* lps = lp + (size_t)s * field;
  const float* lrs = lr + (size_t)s * field;
  auto cp = [&](size_t j) { return q.C[j] * (q.damp[j] * lps[j]); };
  auto ar = [&](size_t j) {
    const float pj = q.damp[j] * lps[j];
    return q.A[j] * (q.damp[j] * (lrs[j] - q.D[j] * pj));
  };
  const size_t row = (size_t)z * nx;
  const float bc = q.b[cell];
  f1x[o] = bc * deriv<R, kP>([&](int j) { return cp(row + j); }, x, nx,
                             c.wp, c.ihx);
  f1z[o] = bc * deriv<R, kP>([&](int j) { return cp((size_t)j * nx + x); },
                             z, nz, c.wp, c.ihz);
  f2x[o] = bc * deriv<R, kP>([&](int j) { return ar(row + j); }, x, nx,
                             c.wp, c.ihx);
  f2z[o] = bc * deriv<R, kP>([&](int j) { return ar((size_t)j * nx + x); },
                             z, nz, c.wp, c.ihz);
}

// Update phase of reverse step t: the images, then lp, lpp, lr and pendR in
// place (each thread reads only its own cell of them).
template <int R>
__global__ void adjoint_update(Params q, const float* __restrict__ hist,
                               const float* __restrict__ res,
                               const float* __restrict__ wavs2,
                               const float* __restrict__ injw,
                               const float* __restrict__ f1x,
                               const float* __restrict__ f1z,
                               const float* __restrict__ f2x,
                               const float* __restrict__ f2z,
                               float* __restrict__ lp,
                               float* __restrict__ lpp,
                               float* __restrict__ lr,
                               float* __restrict__ pend,
                               float* __restrict__ ga1,
                               float* __restrict__ ga2,
                               float* __restrict__ ga3,
                               float* __restrict__ ga4,
                               float* __restrict__ gsrc, int t, int total,
                               int nz, int nx, int z0, Coefs c) {
  const int x = blockIdx.x * kBX + threadIdx.x;
  const int z = blockIdx.y * kBY + threadIdx.y;
  const int s = blockIdx.z;
  if (x >= nx || z >= nz) return;
  const size_t field = (size_t)nz * nx;
  const size_t cell = (size_t)z * nx + x;
  const size_t o = (size_t)s * field + cell;
  const float* h = hist + ((size_t)s * total + t) * 2 * field;
  const float L = h[cell];
  const float rn = h[field + cell];
  const float damp = q.damp[cell];
  const float lpv = lp[o];
  const float pa = damp * lpv;
  const float ra = damp * (lr[o] - q.D[cell] * pa);
  ga3[o] = ga3[o] + L * pa;
  ga4[o] = ga4[o] - rn * pa;
  ga1[o] = ga1[o] + L * ra;
  ga2[o] = ga2[o] - rn * pend[o];
  gsrc[o] = gsrc[o] + (wavs2[t] * injw[o]) * lpv;
  const size_t so = (size_t)s * field;
  const float lsa_cp = ddx<R, kM>(f1x + so, z, x, nx, c) +
                       ddz<R, kM>(f1z + so, z, x, nz, nx, c);
  const float lsa_ar = ddx<R, kM>(f2x + so, z, x, nx, c) +
                       ddz<R, kM>(f2z + so, z, x, nz, nx, c);
  float lpn = ((2.0f * pa + lsa_cp) + lsa_ar) + lpp[o];
  if (z == z0 || z == z0 + 1)
    lpn = lpn + res[(((size_t)s * total + t) * 2 + (z - z0)) * nx + x];
  lpp[o] = (-damp) * pa;
  lr[o] = ra - q.B[cell] * ra;
  lp[o] = lpn;
  pend[o] = ra;
}

struct ForwardArgs {
  Params q;
  const float *wav, *inj;
  float *rec, *hist, *illum, *pout;
  float *p, *pp, *r, *gx, *gz;
  int B, nz, nx, total, nsteps, z0;
  Coefs c;
  cudaStream_t stream;
};

template <int R, bool HIST>
int run_forward(ForwardArgs a) {
  const dim3 block(kBX, kBY);
  const dim3 grid((a.nx + kBX - 1) / kBX, (a.nz + kBY - 1) / kBY, a.B);
  for (int t = 0; t < a.total; ++t) {
    flux_step<R><<<grid, block, 0, a.stream>>>(a.q.b, a.p, a.gx, a.gz, a.rec,
                                               t, a.total, a.nz, a.nx, a.z0,
                                               a.c);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    update_step<R, HIST><<<grid, block, 0, a.stream>>>(
        a.q, a.gx, a.gz, a.p, a.pp, a.r, a.wav, a.inj, a.hist, a.illum, t,
        a.total, a.nsteps, a.nz, a.nx, a.c);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    float* tmp = a.p;
    a.p = a.pp;
    a.pp = tmp;
    if (a.pout != NULL && t == a.nsteps - 1) {
      err = cudaMemcpyAsync(a.pout, a.p,
                            (size_t)a.B * a.nz * a.nx * sizeof(float),
                            cudaMemcpyDeviceToDevice, a.stream);
      if (err != cudaSuccess) return (int)err;
    }
  }
  return 0;
}

struct AdjointArgs {
  Params q;
  const float *injw, *hist, *res, *wavs2;
  float *ga1, *ga2, *ga3, *ga4, *gsrc;
  float *lp, *lpp, *lr, *pend, *f1x, *f1z, *f2x, *f2z;
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
    adjoint_flux<R><<<grid, block, 0, a.stream>>>(
        a.q, a.lp, a.lr, a.f1x, a.f1z, a.f2x, a.f2z, a.nz, a.nx, a.c);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    adjoint_update<R><<<grid, block, 0, a.stream>>>(
        a.q, a.hist, a.res, a.wavs2, a.injw, a.f1x, a.f1z, a.f2x, a.f2z,
        a.lp, a.lpp, a.lr, a.pend, a.ga1, a.ga2, a.ga3, a.ga4, a.gsrc, t,
        a.total, a.nz, a.nx, a.z0, a.c);
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
// NULL. scratch is 5 (B, nz, nx) fields holding zeros: p, pp, r and the two
// fluxes. wp and wm are the 2r taps of the D+ and D- stencils. Returns the
// first CUDA error of a launch, or 0.
int visco2d_forward(const float* damp, const float* b, const float* A,
                    const float* Bc, const float* C, const float* D,
                    const float* wav, const float* inj, float* rec,
                    float* hist, float* illum, float* pout, float* scratch,
                    int B, int nz, int nx, int total, int nsteps, int z0,
                    int r, const float* wp, const float* wm, float ihx,
                    float ihz, void* stream) {
  if (r < 1 || r > kMaxR || (hist == NULL) != (illum == NULL) ||
      (hist == NULL) == (pout == NULL) || z0 < 0 || z0 + 2 > nz ||
      nsteps < 1 || nsteps > total)
    return (int)cudaErrorInvalidValue;
  const size_t n = (size_t)B * nz * nx;
  ForwardArgs a = {};
  a.q = make_params(damp, b, A, Bc, C, D);
  a.wav = wav;
  a.inj = inj;
  a.rec = rec;
  a.hist = hist;
  a.illum = illum;
  a.pout = pout;
  a.p = scratch;
  a.pp = scratch + n;
  a.r = scratch + 2 * n;
  a.gx = scratch + 3 * n;
  a.gz = scratch + 4 * n;
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
// dt^2 and injw (B, nz, nx) the source weights. grads is 5 (B, nz, nx)
// images (ga1, ga2, ga3, ga4, gsrc) and scratch 8 (B, nz, nx) fields (lp,
// lpp, lr, pendR and the four fluxes), all holding zeros on entry. Returns
// the first CUDA error of a launch, or 0.
int visco2d_adjoint(const float* damp, const float* b, const float* A,
                    const float* Bc, const float* C, const float* D,
                    const float* injw, const float* hist, const float* res,
                    const float* wavs2, float* grads, float* scratch, int B,
                    int nz, int nx, int total, int nsteps, int z0, int r,
                    const float* wp, const float* wm, float ihx, float ihz,
                    void* stream) {
  if (r < 1 || r > kMaxR || z0 < 0 || z0 + 2 > nz || nsteps > total)
    return (int)cudaErrorInvalidValue;
  const size_t n = (size_t)B * nz * nx;
  AdjointArgs a = {};
  a.q = make_params(damp, b, A, Bc, C, D);
  a.injw = injw;
  a.hist = hist;
  a.res = res;
  a.wavs2 = wavs2;
  a.ga1 = grads;
  a.ga2 = grads + n;
  a.ga3 = grads + 2 * n;
  a.ga4 = grads + 3 * n;
  a.gsrc = grads + 4 * n;
  a.lp = scratch;
  a.lpp = scratch + n;
  a.lr = scratch + 2 * n;
  a.pend = scratch + 3 * n;
  a.f1x = scratch + 4 * n;
  a.f1z = scratch + 5 * n;
  a.f2x = scratch + 6 * n;
  a.f2z = scratch + 7 * n;
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
