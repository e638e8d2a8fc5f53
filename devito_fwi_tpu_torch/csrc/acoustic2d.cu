// 2-D acoustic OT2 leapfrog sweeps for Hopper (sm_90a), plain C interface
// for ctypes. Four entry points, each one sweep over all time steps of a
// shot batch, one kernel launch per step on the caller's stream:
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
//       streamed history, grad += dt2[t] * v, then one final scale by
//       -1/s^2.
//   acoustic2d_gradient_segments
//       replaces gradient_segments (pallas_acoustic.py:453, _grad_kernel
//       :361): for each segment from the last to the first, seg forward
//       steps from its saved pair into a per-segment d2u/dt2 scratch, then
//       the seg adjoint steps of that segment over the scratch; one final
//       scale by -1/s^2.
//
// Layout: fields are (B, nz, nx) float32 with x contiguous (the transposed
// layout of the JAX kernels); m, two_m_hd = 2m + hd and denom = 1/(m + hd)
// are (nz, nx) and shared by all shots; receiver rows are (B, total, 2, nx)
// on the padded z-planes z0 and z0 + 1; the history is (B, total, nz, nx);
// the segment pairs are (B, nseg, 2, nz, nx) and the recompute scratch
// (B, seg, nz, nx).
//
// What bounds it on the card: the forward with history writes
// B * total * nz * nx * 4 bytes (11.2 GB for the 29-shot Marmousi batch) and
// the adjoint reads them back, so both are bound by device-memory bandwidth;
// the receivers-only and the checkpoint forwards move almost nothing and are
// bound by the ~40 float operations per cell and step, and so is the
// checkpoint gradient (two stencil sweeps, its scratch of one segment stays
// in L2 for a few shots and streams otherwise). The state of all shots
// (u, u_prev, inj, illum: 4 fields of 283 KB for each of 29 shots, ~33 MB)
// fits the 50 MB L2, so the stencil's neighbour reads are L2/L1 hits.
//
// What the design does about it: one thread per cell and one launch per time
// step for the whole batch (blockIdx.z is the shot), so a step is a single
// wide launch and the history is written once, coalesced, as it is produced.
// The per-cell update overwrites u_prev in place (each cell reads its own
// u_prev before writing it and no other thread reads it), so two buffers per
// shot suffice. A field (283 KB) does not fit one block's shared memory, so
// the neighbours come through the caches rather than a resident tile. This
// simple design runs each sweep 10-20x above its bound on the H100 (times
// in PERF.md): the card idles between the short launches and the stencil
// re-reads every neighbour from L1/L2. Several steps per launch,
// shared-memory tiles and thread-block clusters are the next steps.
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

// One forward step t for all shots: up <- un (in place), and what FLAGS
// asks for: receiver rows of u, the history value at (b, t) of a
// (B, total, nz, nx) buffer, the illumination, the segment-start pair.
template <int R, bool FS, int FLAGS>
__global__ void forward_step(const float* __restrict__ u,
                             float* __restrict__ up,
                             const float* __restrict__ m,
                             const float* __restrict__ two_m_hd,
                             const float* __restrict__ denom,
                             const float* __restrict__ wav,
                             const float* __restrict__ inj,
                             float* __restrict__ rec,
                             float* __restrict__ dt2,
                             float* __restrict__ illum,
                             float* __restrict__ ckpt, int t, int total,
                             int nsteps, int seg, int nseg, int nz, int nx,
                             int z0, Stencil s) {
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
  if ((FLAGS & kRec) && (z == z0 || z == z0 + 1))
    rec[(bt * 2 + (z - z0)) * nx + x] = uc;
  const float upc = up[o];
  if ((FLAGS & kCkpt) && t % seg == 0) {
    const size_t pair = ((size_t)b * nseg + t / seg) * 2 * field + cell;
    ckpt[pair] = uc;
    ckpt[pair + field] = upc;
  }
  const float lap = laplacian<R, FS>(ub, z, x, nz, nx, s);
  const float un =
      (lap + two_m_hd[cell] * uc - m[cell] * upc) * denom[cell] +
      wav[t] * inj[o];
  if (FLAGS & kHist) dt2[bt * field + cell] = un - 2.0f * uc + upc;
  if ((FLAGS & kIllum) && t < nsteps) illum[o] = illum[o] + un * un;
  up[o] = un;
}

// One reverse step for all shots: grad += dt2[b, th] * v (history of
// ht steps), vn <- v_new (in place) with the residual rows of step t added
// on z0 and z0 + 1.
template <int R, bool FS>
__global__ void adjoint_step(const float* __restrict__ v,
                             float* __restrict__ vn,
                             const float* __restrict__ m,
                             const float* __restrict__ two_m_hd,
                             const float* __restrict__ denom,
                             const float* __restrict__ dt2,
                             const float* __restrict__ res,
                             float* __restrict__ grad, int th, int ht, int t,
                             int total, int nz, int nx, int z0, Stencil s) {
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
  grad[o] = grad[o] + dt2[((size_t)b * ht + th) * field + cell] * vc;
  const float lap = laplacian<R, FS>(vb, z, x, nz, nx, s);
  float vnew = (lap + two_m_hd[cell] * vc - m[cell] * vn[o]) * denom[cell];
  if (z == z0 || z == z0 + 1) vnew = vnew + res[(bt * 2 + (z - z0)) * nx + x];
  vn[o] = vnew;
}

// u, up <- the saved pair of segment k of every shot.
__global__ void load_pair(const float* __restrict__ ckpt, float* __restrict__ u,
                          float* __restrict__ up, int nseg, int k,
                          size_t field, size_t n) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const size_t b = i / field;
  const float* pair = ckpt + ((size_t)b * nseg + k) * 2 * field + i % field;
  u[i] = pair[0];
  up[i] = pair[field];
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
  float *rec, *dt2, *illum, *ckpt, *u, *up;
  int B, nz, nx, total, nsteps, seg, nseg, z0;
  Stencil s;
  cudaStream_t stream;
};

// Steps t = 0 .. nt-1 of a forward from the state in (a.u, a.up); the
// wavelet, history and step count come from the arguments, so the
// recompute of one segment is this loop over its own slice.
template <int R, bool FS, int FLAGS>
int forward_steps(const ForwardArgs& a, const float* wav, float* dt2,
                  int total, int nt) {
  const dim3 block(kBX, kBY);
  const dim3 grid((a.nx + kBX - 1) / kBX, (a.nz + kBY - 1) / kBY, a.B);
  float* u = a.u;
  float* up = a.up;
  for (int t = 0; t < nt; ++t) {
    forward_step<R, FS, FLAGS><<<grid, block, 0, a.stream>>>(
        u, up, a.m, a.two_m_hd, a.denom, wav, a.inj, a.rec, dt2, a.illum,
        a.ckpt, t, total, a.nsteps, a.seg, a.nseg, a.nz, a.nx, a.z0, a.s);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    float* tmp = u;
    u = up;
    up = tmp;
  }
  return 0;
}

template <int R, bool FS, int FLAGS>
int run_forward(const ForwardArgs& a) {
  return forward_steps<R, FS, FLAGS>(a, a.wav, a.dt2, a.total, a.total);
}

struct AdjointArgs {
  const float *m, *two_m_hd, *denom, *dt2, *res;
  float *grad, *v, *vn;
  int B, nz, nx, total, nsteps, z0;
  float neg_inv_s2;
  Stencil s;
  cudaStream_t stream;
  // checkpoint route only: forward operands and the segment layout
  const float *wav, *inj, *ckpt;
  float *u, *up;
  int seg, nseg;
};

// Reverse steps t = hi-1 .. lo over a history whose step t sits at
// th = t - t0 of ht steps; the adjoint pair (a.v, a.vn) is swapped in place
// so a later call continues the sweep.
template <int R, bool FS>
int adjoint_steps(AdjointArgs& a, const float* dt2, int t0, int ht, int lo,
                  int hi) {
  const dim3 block(kBX, kBY);
  const dim3 grid((a.nx + kBX - 1) / kBX, (a.nz + kBY - 1) / kBY, a.B);
  for (int t = hi - 1; t >= lo; --t) {
    adjoint_step<R, FS><<<grid, block, 0, a.stream>>>(
        a.v, a.vn, a.m, a.two_m_hd, a.denom, dt2, a.res, a.grad, t - t0, ht,
        t, a.total, a.nz, a.nx, a.z0, a.s);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    float* tmp = a.v;
    a.v = a.vn;
    a.vn = tmp;
  }
  return 0;
}

int scale_grad(const AdjointArgs& a) {
  const size_t n = (size_t)a.B * a.nz * a.nx;
  const int threads = 256;
  scale_inplace<<<(unsigned)((n + threads - 1) / threads), threads, 0,
                  a.stream>>>(a.grad, n, a.neg_inv_s2);
  return (int)cudaGetLastError();
}

template <int R, bool FS>
int run_adjoint(AdjointArgs a) {
  // padded tail steps (t >= nsteps) are skipped in reverse
  const int err = adjoint_steps<R, FS>(a, a.dt2, 0, a.total, 0, a.nsteps);
  return err ? err : scale_grad(a);
}

template <int R, bool FS>
int run_gradient_segments(AdjointArgs a) {
  // a.dt2 is the (B, seg, nz, nx) scratch of one segment
  ForwardArgs f = {a.m,    a.two_m_hd, a.denom, a.wav,  a.inj,
                   nullptr, nullptr,   nullptr, nullptr, a.u,
                   a.up,   a.B,        a.nz,    a.nx,   a.total,
                   a.nsteps, a.seg,    a.nseg,  a.z0,   a.s,
                   a.stream};
  const size_t field = (size_t)a.nz * a.nx;
  const size_t n = (size_t)a.B * field;
  const int threads = 256;
  float* scratch = const_cast<float*>(a.dt2);
  for (int k = a.nseg - 1; k >= 0; --k) {
    const int base = k * a.seg;
    load_pair<<<(unsigned)((n + threads - 1) / threads), threads, 0,
                a.stream>>>(a.ckpt, a.u, a.up, a.nseg, k, field, n);
    int err = (int)cudaGetLastError();
    if (err) return err;
    err = forward_steps<R, FS, kHist>(f, a.wav + base, scratch, a.seg, a.seg);
    if (err) return err;
    const int hi = base + a.seg < a.nsteps ? base + a.seg : a.nsteps;
    err = adjoint_steps<R, FS>(a, scratch, base, a.seg, base, hi);
    if (err) return err;
  }
  return scale_grad(a);
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

}  // namespace

extern "C" {

// Forward sweep over t = 0 .. total-1. dt2 and ckpt may not both be set;
// illum is set exactly when one of them is (history or checkpoint sweep)
// and holds zeros on entry. ckpt is (B, nseg, 2, nz, nx) with
// nseg * seg == total. u and up are (B, nz, nx) scratch fields holding the
// start state (zeros). Returns the first CUDA error of a launch, or 0.
int acoustic2d_forward(const float* m, const float* two_m_hd,
                       const float* denom, const float* wav, const float* inj,
                       float* rec, float* dt2, float* illum, float* ckpt,
                       float* u, float* up, int B, int nz, int nx, int total,
                       int nsteps, int seg, int z0, int fs, int r,
                       const float* w, float inv_h2x, float inv_h2z,
                       void* stream) {
  if (r < 1 || r > kMaxR || (dt2 != NULL && ckpt != NULL) ||
      (illum != NULL) != (dt2 != NULL || ckpt != NULL) || seg < 1 ||
      total % seg != 0)
    return (int)cudaErrorInvalidValue;
  ForwardArgs a = {m,     two_m_hd, denom, wav,         inj,  rec,
                   dt2,   illum,    ckpt,  u,           up,   B,
                   nz,    nx,       total, nsteps,      seg,  total / seg,
                   z0,    make_stencil(w, r, inv_h2x, inv_h2z),
                   (cudaStream_t)stream};
  if (dt2 != NULL) return dispatch_forward<kRec | kHist | kIllum>(fs, r, a);
  if (ckpt != NULL) return dispatch_forward<kRec | kIllum | kCkpt>(fs, r, a);
  return dispatch_forward<kRec>(fs, r, a);
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
  AdjointArgs a = {};
  a.m = m;
  a.two_m_hd = two_m_hd;
  a.denom = denom;
  a.dt2 = dt2;
  a.res = res;
  a.grad = grad;
  a.v = v;
  a.vn = vn;
  a.B = B;
  a.nz = nz;
  a.nx = nx;
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
// over its steps t < nsteps; then grad *= neg_inv_s2. grad, v and vn are
// (B, nz, nx) and hold zeros on entry; u and up are (B, nz, nx) scratch.
int acoustic2d_gradient_segments(
    const float* m, const float* two_m_hd, const float* denom,
    const float* wav, const float* inj, const float* ckpt, const float* res,
    float* scratch, float* grad, float* v, float* vn, float* u, float* up,
    int B, int nz, int nx, int seg, int nseg, int nsteps, int z0, int fs,
    int r, const float* w, float inv_h2x, float inv_h2z, float neg_inv_s2,
    void* stream) {
  if (r < 1 || r > kMaxR || seg < 1 || nseg < 1 || nsteps > seg * nseg)
    return (int)cudaErrorInvalidValue;
  AdjointArgs a = {};
  a.m = m;
  a.two_m_hd = two_m_hd;
  a.denom = denom;
  a.dt2 = scratch;
  a.res = res;
  a.grad = grad;
  a.v = v;
  a.vn = vn;
  a.B = B;
  a.nz = nz;
  a.nx = nx;
  a.total = seg * nseg;
  a.nsteps = nsteps;
  a.z0 = z0;
  a.neg_inv_s2 = neg_inv_s2;
  a.s = make_stencil(w, r, inv_h2x, inv_h2z);
  a.stream = (cudaStream_t)stream;
  a.wav = wav;
  a.inj = inj;
  a.ckpt = ckpt;
  a.u = u;
  a.up = up;
  a.seg = seg;
  a.nseg = nseg;
  return fs ? dispatch_r<Seg, true, 0>(r, a) : dispatch_r<Seg, false, 0>(r, a);
}

const char* acoustic2d_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
