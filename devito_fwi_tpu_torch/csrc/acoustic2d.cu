// 2-D acoustic OT2 leapfrog sweeps for Hopper (sm_90a), plain C interface
// for ctypes. Three entry points, each one sweep over all time steps of a
// shot batch, one kernel launch per step on the caller's stream:
//
//   acoustic2d_forward(..., dt2 = NULL)  replaces forward_rec_segments
//       (devito_fwi_tpu/ops/pallas_acoustic.py:221, _fwd_rec_kernel :182):
//       records the two receiver rows of u at every step.
//   acoustic2d_forward(..., dt2 != NULL) replaces forward_dt2_segments
//       (pallas_acoustic.py:569, _fwd_dt2_kernel :520): the same forward,
//       plus the d2u/dt2 history un - 2u + up of every step and the
//       illumination sum of un^2 over the steps t < nsteps.
//   acoustic2d_adjoint                    replaces gradient_stream_segments
//       (pallas_acoustic.py:673, _grad_stream_kernel :622): the reverse
//       adjoint sweep over the streamed history, grad += dt2[t] * v, then
//       one final scale by -1/s^2.
//
// Layout: fields are (B, nz, nx) float32 with x contiguous (the transposed
// layout of the JAX kernels); m, two_m_hd = 2m + hd and denom = 1/(m + hd)
// are (nz, nx) and shared by all shots; receiver rows are (B, total, 2, nx)
// on the padded z-planes z0 and z0 + 1; the history is (B, total, nz, nx).
//
// What bounds it on the card: the forward with history writes
// B * total * nz * nx * 4 bytes (11.2 GB for the 29-shot Marmousi batch) and
// the adjoint reads them back, so both are bound by device-memory bandwidth;
// the receivers-only forward moves almost nothing and is bound by the
// ~40 float operations per cell and step. The state of all shots (u, u_prev,
// inj, illum: 4 fields of 283 KB for each of 29 shots, ~33 MB) fits the
// 50 MB L2, so the stencil's neighbour reads are L2/L1 hits and the history
// stream is the only device-memory traffic that grows with the run.
//
// What the design does about it: one thread per cell and one launch per time
// step for the whole batch (blockIdx.z is the shot), so a step is a single
// wide launch and the history is written once, coalesced, as it is produced.
// The per-cell update overwrites u_prev in place (each cell reads its own
// u_prev before writing it and no other thread reads it), so two buffers per
// shot suffice. A field (283 KB) does not fit one block's shared memory, so
// the neighbours come through the caches rather than a resident tile. This
// simple design runs each sweep 10-20x above its bound on the H100 (times
// in PERF.md): the card idles between the 1368 short launches and the
// stencil re-reads every neighbour from L1/L2. Several steps per launch,
// shared-memory tiles and thread-block clusters are the next steps.
//
// Numerics: the arithmetic association of the JAX kernels' _make_lap_t and
// update is kept term for term (shift pair summed before the weight
// multiply, x term first, per-axis dt^2/h^2 scales), and the library is
// compiled with -fmad=false so no multiply-add is contracted: the kernels
// then round exactly like the plain torch twins in ops/cuda_acoustic.py.
// Neighbours beyond the padded grid are zero; under a free surface rows
// 0..r of the z-derivative use the odd-mirrored stencil.
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kMaxR = 8;
constexpr int kBX = 32;
constexpr int kBY = 8;

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

// One forward step t for all shots: up <- un (in place), receiver rows of u,
// and with HIST the history and the illumination.
template <int R, bool FS, bool HIST>
__global__ void forward_step(const float* __restrict__ u,
                             float* __restrict__ up,
                             const float* __restrict__ m,
                             const float* __restrict__ two_m_hd,
                             const float* __restrict__ denom,
                             const float* __restrict__ wav,
                             const float* __restrict__ inj,
                             float* __restrict__ rec,
                             float* __restrict__ dt2,
                             float* __restrict__ illum, int t, int total,
                             int nsteps, int nz, int nx, int z0, Stencil s) {
  const int x = blockIdx.x * kBX + threadIdx.x;
  const int z = blockIdx.y * kBY + threadIdx.y;
  const int b = blockIdx.z;
  if (x >= nx || z >= nz) return;
  const size_t field = (size_t)nz * nx;
  const size_t cell = (size_t)z * nx + x;
  const size_t bt = (size_t)b * total + t;
  const float* ub = u + (size_t)b * field;
  const size_t o = (size_t)b * field + cell;

  const float uc = ub[cell];
  if (z == z0 || z == z0 + 1) rec[(bt * 2 + (z - z0)) * nx + x] = uc;
  const float upc = up[o];
  const float lap = laplacian<R, FS>(ub, z, x, nz, nx, s);
  const float un =
      (lap + two_m_hd[cell] * uc - m[cell] * upc) * denom[cell] +
      wav[t] * inj[o];
  if (HIST) {
    dt2[bt * field + cell] = un - 2.0f * uc + upc;
    if (t < nsteps) illum[o] = illum[o] + un * un;
  }
  up[o] = un;
}

// One reverse step t for all shots: grad += dt2[t] * v, vn <- v_new (in
// place) with the residual rows added on z0 and z0 + 1.
template <int R, bool FS>
__global__ void adjoint_step(const float* __restrict__ v,
                             float* __restrict__ vn,
                             const float* __restrict__ m,
                             const float* __restrict__ two_m_hd,
                             const float* __restrict__ denom,
                             const float* __restrict__ dt2,
                             const float* __restrict__ res,
                             float* __restrict__ grad, int t, int total,
                             int nz, int nx, int z0, Stencil s) {
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
  grad[o] = grad[o] + dt2[bt * field + cell] * vc;
  const float lap = laplacian<R, FS>(vb, z, x, nz, nx, s);
  float vnew = (lap + two_m_hd[cell] * vc - m[cell] * vn[o]) * denom[cell];
  if (z == z0 || z == z0 + 1) vnew = vnew + res[(bt * 2 + (z - z0)) * nx + x];
  vn[o] = vnew;
}

__global__ void scale_inplace(float* __restrict__ a, size_t n, float c) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) a[i] = a[i] * c;
}

Stencil make_stencil(const float* w, int r, float inv_h2x, float inv_h2z) {
  Stencil s = {};
  for (int k = 0; k <= r; ++k) s.w[k] = w[k];
  s.inv_h2x = inv_h2x;
  s.inv_h2z = inv_h2z;
  return s;
}

struct ForwardArgs {
  const float *m, *two_m_hd, *denom, *wav, *inj;
  float *rec, *dt2, *illum, *u, *up;
  int B, nz, nx, total, nsteps, z0;
  Stencil s;
  cudaStream_t stream;
};

template <int R, bool FS, bool HIST>
int run_forward(const ForwardArgs& a) {
  const dim3 block(kBX, kBY);
  const dim3 grid((a.nx + kBX - 1) / kBX, (a.nz + kBY - 1) / kBY, a.B);
  float* u = a.u;
  float* up = a.up;
  for (int t = 0; t < a.total; ++t) {
    forward_step<R, FS, HIST><<<grid, block, 0, a.stream>>>(
        u, up, a.m, a.two_m_hd, a.denom, a.wav, a.inj, a.rec, a.dt2, a.illum,
        t, a.total, a.nsteps, a.nz, a.nx, a.z0, a.s);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    float* tmp = u;
    u = up;
    up = tmp;
  }
  return 0;
}

struct AdjointArgs {
  const float *m, *two_m_hd, *denom, *dt2, *res;
  float *grad, *v, *vn;
  int B, nz, nx, total, nsteps, z0;
  float neg_inv_s2;
  Stencil s;
  cudaStream_t stream;
};

template <int R, bool FS>
int run_adjoint(const AdjointArgs& a) {
  const dim3 block(kBX, kBY);
  const dim3 grid((a.nx + kBX - 1) / kBX, (a.nz + kBY - 1) / kBY, a.B);
  float* v = a.v;
  float* vn = a.vn;
  // padded tail steps (t >= nsteps) are skipped in reverse
  for (int t = a.nsteps - 1; t >= 0; --t) {
    adjoint_step<R, FS><<<grid, block, 0, a.stream>>>(
        v, vn, a.m, a.two_m_hd, a.denom, a.dt2, a.res, a.grad, t, a.total,
        a.nz, a.nx, a.z0, a.s);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    float* tmp = v;
    v = vn;
    vn = tmp;
  }
  const size_t n = (size_t)a.B * a.nz * a.nx;
  const int threads = 256;
  scale_inplace<<<(unsigned)((n + threads - 1) / threads), threads, 0,
                  a.stream>>>(a.grad, n, a.neg_inv_s2);
  return (int)cudaGetLastError();
}

// Dispatch the runtime radius and flags onto the unrolled instantiations.
template <template <int, bool, bool> class F, bool FS, bool HIST, class A>
int dispatch_r(int r, const A& a) {
  switch (r) {
    case 1: return F<1, FS, HIST>::run(a);
    case 2: return F<2, FS, HIST>::run(a);
    case 3: return F<3, FS, HIST>::run(a);
    case 4: return F<4, FS, HIST>::run(a);
    case 5: return F<5, FS, HIST>::run(a);
    case 6: return F<6, FS, HIST>::run(a);
    case 7: return F<7, FS, HIST>::run(a);
    case 8: return F<8, FS, HIST>::run(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int R, bool FS, bool HIST>
struct Fwd {
  static int run(const ForwardArgs& a) { return run_forward<R, FS, HIST>(a); }
};

template <int R, bool FS, bool HIST>
struct Adj {
  static int run(const AdjointArgs& a) { return run_adjoint<R, FS>(a); }
};

}  // namespace

extern "C" {

// Forward sweep over t = 0 .. total-1. dt2 and illum may both be NULL
// (receivers only) or both set (history and illumination). u and up are
// (B, nz, nx) scratch fields holding the start state (zeros). Returns the
// first CUDA error of a launch, or 0.
int acoustic2d_forward(const float* m, const float* two_m_hd,
                       const float* denom, const float* wav, const float* inj,
                       float* rec, float* dt2, float* illum, float* u,
                       float* up, int B, int nz, int nx, int total,
                       int nsteps, int z0, int fs, int r, const float* w,
                       float inv_h2x, float inv_h2z, void* stream) {
  if (r < 1 || r > kMaxR || (dt2 == NULL) != (illum == NULL))
    return (int)cudaErrorInvalidValue;
  ForwardArgs a = {m,  two_m_hd, denom, wav, inj, rec,   dt2,
                   illum, u,     up,    B,   nz,  nx,    total,
                   nsteps, z0,   make_stencil(w, r, inv_h2x, inv_h2z),
                   (cudaStream_t)stream};
  const bool hist = dt2 != NULL;
  if (fs) {
    return hist ? dispatch_r<Fwd, true, true>(r, a)
                : dispatch_r<Fwd, true, false>(r, a);
  }
  return hist ? dispatch_r<Fwd, false, true>(r, a)
              : dispatch_r<Fwd, false, false>(r, a);
}

// Reverse sweep over t = nsteps-1 .. 0, then grad *= neg_inv_s2. grad, v
// and vn are (B, nz, nx) and hold zeros on entry.
int acoustic2d_adjoint(const float* m, const float* two_m_hd,
                       const float* denom, const float* dt2, const float* res,
                       float* grad, float* v, float* vn, int B, int nz,
                       int nx, int total, int nsteps, int z0, int fs, int r,
                       const float* w, float inv_h2x, float inv_h2z,
                       float neg_inv_s2, void* stream) {
  if (r < 1 || r > kMaxR) return (int)cudaErrorInvalidValue;
  AdjointArgs a = {m,  two_m_hd, denom, dt2, res,    grad,
                   v,  vn,       B,     nz,  nx,     total,
                   nsteps, z0,   neg_inv_s2,
                   make_stencil(w, r, inv_h2x, inv_h2z), (cudaStream_t)stream};
  return fs ? dispatch_r<Adj, true, false>(r, a)
            : dispatch_r<Adj, false, false>(r, a);
}

const char* acoustic2d_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
