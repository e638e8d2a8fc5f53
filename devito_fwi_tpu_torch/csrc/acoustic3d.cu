// 3-D acoustic OT2 kernels for Hopper (sm_90a), plain C interface for
// ctypes. Four entry points:
//
//   acoustic3d_forward(..., dt2 = NULL, illum = NULL)
//       replaces forward_rec3 (devito_fwi_tpu/ops/pallas_acoustic3d.py:425,
//       _rec3_kernel :354): a streamed 3-D forward over all time steps of a
//       shot batch that records the two receiver z-planes of u at every
//       step.
//   acoustic3d_forward(..., dt2 != NULL, illum != NULL)
//       replaces forward_dt2_stream3 (pallas_acoustic3d.py:274,
//       _fwd3_kernel :190): the same forward, plus the d2u/dt2 history
//       un - 2u + up of every step (the source included) and the
//       illumination sum of un^2.
//   acoustic3d_gradient
//       replaces gradient_stream3 (pallas_acoustic3d.py:571, _grad3_kernel
//       :492): the reverse sweep over that history, grad += dt2[t] * v, v
//       stepped backward, the residual planes added on z0, z0 + 1 of the
//       new v, on the forwards' march; one final scale by -1/s^2.
//   acoustic3d_step
//       replaces step3 (devito_fwi_tpu/ops/pallas_acoustic3.py:120,
//       _step3_kernel :68): one leapfrog step
//       un = (s2 lap(u) + (2m + hd) u - m up) / (m + hd) of one
//       (nx, ny, nz) field, zero-Dirichlet, for the eager saved-history
//       route (ops/acoustic.py's step hook).
//
// Layouts. The streamed sweeps keep the JAX kernels' transposed layout
// (B, ny, nz, nx) with x contiguous: the two receiver z-planes of a y-plane
// are two contiguous rows. m, two_m_hd = 2m + hd and denom = 1/(m + hd) are
// (ny, nz, nx) and shared by all shots; the wavelet is (B, nsteps); the
// source planes (B, 2, nz, nx) are added on the y-planes iy[b], iy[b] + 1;
// receiver and residual slabs are (B, nsteps, ny, 2, nx); the history is
// (B, nsteps, ny, nz, nx), 2.79e9 elements at bench config 5 (4 shots of
// 128^3 over 333 steps), so every offset is 64-bit. The step kernel keeps
// the model's (nx, ny, nz) layout with z contiguous.
//
// What bounds it on the card: the forward with history writes
// B * nsteps * ny * nz * nx * 4 bytes (11.2 GB at config 5) and the reverse
// sweep reads them back, so both are bound by device-memory bandwidth
// (~3.3 ms each at 3.35 TB/s); the receivers-only forward moves little
// beyond its state and is bound by the ~55 float operations per cell and
// step (~2.3 ms at 67 TFLOP/s). Taken a step at a time, a sweep's floor is
// its state through device memory once a step: the state of a batch (u and
// up, 8.4 MB a field and shot) does not fit the 50 MB L2 at four shots.
//
// The sweeps (march): the first design ran one thread a cell
// (32 x 8 in x, z at one y) and one launch a step, every neighbour read
// through L1/L2: the y taps a plane (64 KB) apart and the z taps a row
// apart, up to ~17 values a cell re-read from L2 or device memory, and the
// shot the slowest grid axis, so the three parameter fields came in once a
// shot. The march: a block owns a kMX x kMZ (x, z) tile of one shot and
// walks y over a chunk of planes. Each thread keeps its column's 2R + 1
// values of u along y in a register queue, so the y taps come from
// registers and each u value is read once a step (plus the chunk's R-plane
// lead-ins on each side, and the xz halo of each plane, read from L2); the
// plane's tile and its R halo sit in shared memory (two planes, alternating,
// one barrier a plane) for the x and z taps. up, the parameters and the
// illumination are read at the cell's own place only, the next plane's halo
// and operands, and the queue's front, one plane ahead in registers, at
// three blocks an SM (40 registers a thread). un overwrites up in place (read
// only at the cell's own place). The shots are the grid's fastest axis, so
// the parameters of a tile stay in L2 across its shots, and the y-chunks
// (``ylen`` planes each, chosen by the wrapper) fill the card: 4 shots of
// 128^3 are only 128 tiles. 3B + 3 shot fields a step for the modeling
// sweep (u, up read, up written, the three parameters once), 6B + 3 with
// the history (its write, the illumination's read and write). The reverse
// sweep is the same march in reverse mode: v in the queue and the shared
// planes, v_prev, the history value and grad read at the cell one plane
// ahead, v_prev overwritten by the new v and grad written, the residual
// rows added on z0, z0 + 1: 6B + 3 shot fields a step, against the first
// design's 9B. Its reads (the history slot, grad, v_prev) wait where the
// forward's history is a write, so it runs at two blocks an SM without
// spills and over twice as many y-chunks as fill the card once. Times
// against these floors are in PERF.md (kernel table, rows 8-10). The step
// kernel (step_kernel) is one thread per cell.
//
// Numerics: each kernel keeps its own TPU counterpart's association. The
// streamed sweeps fold dt^2 into the per-axis scales (ih2 = s^2/h^2) and
// update as (lap + two_m_hd u - m up) denom, the source added after; the
// step kernel scales lap with unscaled 1/h^2 and multiplies by s2, as the
// eager update does. Both sum each shift pair before the weight multiply
// and add the x, then the y, then the z term. The library is compiled with
// -fmad=false so no multiply-add is contracted: the kernels round exactly
// like their plain torch twins (ops/cuda_acoustic3d.py,
// ops/cuda_acoustic3.py). Neighbours beyond the grid are zero; under a free
// surface rows 0..r of the z-derivative use the odd-mirrored stencil.
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kMaxR = 8;
constexpr int kBX = 32;
constexpr int kBZ = 8;

struct Stencil {
  float w[kMaxR + 1];
  float ih2x;
  float ih2y;
  float ih2z;
};

// Unscaled second derivative along an axis of stride ``stride`` at index i
// of n: w0 u + sum_k w_k (u[i + k] + u[i - k]), zero beyond the axis.
template <int R>
__device__ __forceinline__ float d2_axis(const float* __restrict__ u,
                                         size_t cell, int i, int n,
                                         size_t stride, const Stencil& s) {
  float acc = s.w[0] * u[cell];
#pragma unroll
  for (int k = 1; k <= R; ++k) {
    const float sp = (i + k < n) ? u[cell + (size_t)k * stride] : 0.0f;
    const float sm = (i - k >= 0) ? u[cell - (size_t)k * stride] : 0.0f;
    acc = acc + s.w[k] * (sp + sm);
  }
  return acc;
}

// The march's tile: kMX x kMZ (x, z) columns of one shot,
// one thread a column.
constexpr int kMX = 32;
constexpr int kMZ = 16;
constexpr int kMThreads = kMX * kMZ;
// blocks an SM that the march's launch bounds ask for: the forwards at
// three (40 registers a thread), the reverse at two (49 registers, where
// forty spill its extra prefetched operands; tools/probe_reverses.py)
constexpr int kMarchBlocks = 3;
constexpr int kReverseBlocks = 2;

// A plane of the tile and its R halo along x and z (no corners) in shared
// memory; two planes, alternating.
template <int R>
struct MarchTile {
  static constexpr int SX = kMX + 2 * R;   // a plane: SZ rows x SX
  static constexpr int SZ = kMZ + 2 * R;
  static constexpr int kHalo = 2 * R * (kMX + kMZ);
  static constexpr int kNH = (kHalo + kMThreads - 1) / kMThreads;
  static constexpr int kFloats = 2 * SX * SZ;
};
static_assert(MarchTile<kMaxR>::kFloats * sizeof(float) <= 48 * 1024,
              "static shared memory");

// The plane-local place (lx, lz) of halo cell j: R rows above and below the
// tile, then R columns left and right of it.
template <int R>
__device__ __forceinline__ void halo_cell(int j, int& lx, int& lz) {
  if (j < 2 * R * kMX) {
    const int row = j / kMX;
    lx = R + j % kMX;
    lz = row < R ? row : kMZ + row;
  } else {
    const int j2 = j - 2 * R * kMX;
    const int col = j2 % (2 * R);
    lx = col < R ? col : kMX + col;
    lz = R + j2 / (2 * R);
  }
}

// The march's modes: modelling (the receiver rows), modelling with the
// history and the illumination, and the reverse sweep.
constexpr int kRec = 0;
constexpr int kHist = 1;
constexpr int kReverse = 2;

// Step t over the planes y0 .. y0 + ylen - 1 of one (x, z) tile of one
// shot (blockIdx.x the shot, .y the x tile, .z the z tile and the
// y-chunk): up <- un in place. Forward (kRec, kHist): u and up the state,
// the source planes added, the receiver rows of u, and with kHist the
// history value and the illumination. kReverse: u = v and up = vn of the
// adjoint, grad += hist[b, t] v, the residual rows added on z0 and z0 + 1
// of the new v. The y taps come from each thread's register queue of its
// column, the x and z taps from the plane's tile in shared memory.
template <int R, bool FS, int MODE>
__global__ void __launch_bounds__(kMThreads, MODE == kReverse
                                                 ? kReverseBlocks
                                                 : kMarchBlocks)
march(const float* __restrict__ u, float* __restrict__ up,
      const float* __restrict__ m, const float* __restrict__ two_m_hd,
      const float* __restrict__ denom, const float* __restrict__ wav,
      const float* __restrict__ injp, const int* __restrict__ iy,
      float* __restrict__ rec, float* __restrict__ dt2,
      float* __restrict__ illum, const float* __restrict__ hist,
      const float* __restrict__ res, float* __restrict__ grad, int t,
      int nsteps, int ny, int nz, int nx, int z0, int ylen, Stencil s) {
  constexpr bool HIST = MODE == kHist;
  constexpr bool REV = MODE == kReverse;
  using T = MarchTile<R>;
  constexpr int SX = T::SX;
  constexpr int kNH = T::kNH;
  __shared__ float planes[T::kFloats];
  const int b = blockIdx.x;           // the shots of a tile adjoin
  const int xt = blockIdx.y * kMX;
  const int nzt = (nz + kMZ - 1) / kMZ;
  const int zt = (blockIdx.z % nzt) * kMZ;
  const int y0 = (blockIdx.z / nzt) * ylen;
  const int y1 = min(y0 + ylen, ny);
  const int tid = threadIdx.x;
  const int tx = tid % kMX;
  const int tz = tid / kMX;
  const int x = xt + tx;
  const int z = zt + tz;
  const bool own = x < nx && z < nz;
  const size_t plane = (size_t)nz * nx;
  const size_t field = (size_t)ny * plane;
  const size_t off = (size_t)b * field;
  const float* ub = u + off;
  const size_t col = own ? (size_t)z * nx + x : 0;
  const size_t bt = (size_t)b * nsteps + t;
  const int iyb = REV ? 0 : iy[b];
  const float wt = REV ? 0.0f : wav[bt];

  // this thread's halo cells: the place in a plane's tile and the cell in a
  // plane (-1 beyond the grid or past the halo)
  int hl[kNH], hg[kNH];
#pragma unroll
  for (int i = 0; i < kNH; ++i) {
    const int j = tid + i * kMThreads;
    int lx = 0, lz = 0;
    if (j < T::kHalo) halo_cell<R>(j, lx, lz);
    const int gx = xt - R + lx;
    const int gz = zt - R + lz;
    hl[i] = j < T::kHalo ? lz * SX + lx : -1;
    hg[i] = j < T::kHalo && gx >= 0 && gx < nx && gz >= 0 && gz < nz
                ? gz * nx + gx
                : -1;
  }

  // the halo of plane y and the operands of the thread's cell on it, loaded
  // one plane ahead of their use (iln the illumination or the gradient, hn
  // the history value)
  float hv[kNH];
  float upn = 0.0f, mn = 0.0f, an = 0.0f, dn = 0.0f, iln = 0.0f, hn = 0.0f;
  auto fetch = [&](int y) {
    const size_t py = (size_t)y * plane;
#pragma unroll
    for (int i = 0; i < kNH; ++i) hv[i] = hg[i] >= 0 ? ub[py + hg[i]] : 0.0f;
    if (own) {
      upn = up[off + py + col];
      mn = m[py + col];
      an = two_m_hd[py + col];
      dn = denom[py + col];
      if (HIST) iln = illum[off + py + col];
      if (REV) {
        iln = grad[off + py + col];
        hn = hist[bt * field + py + col];
      }
    }
  };

  // the queue: u of the column on planes y - R .. y + R; the chunk's
  // lead-in planes y0 - R .. y0 + R - 1 first (zero beyond the grid), and
  // its front, plane y + R, loaded one plane ahead into qn
  auto column = [&](int yy) {
    return own && yy >= 0 && yy < ny ? ub[(size_t)yy * plane + col] : 0.0f;
  };
  float q[2 * R + 1];
  q[0] = 0.0f;
#pragma unroll
  for (int k = 0; k < 2 * R; ++k) q[k + 1] = column(y0 - R + k);
  float qn = column(y0 + R);
  fetch(y0);
  for (int y = y0; y < y1; ++y) {
#pragma unroll
    for (int k = 0; k < 2 * R; ++k) q[k] = q[k + 1];
    q[2 * R] = qn;
    if (y + 1 < y1) qn = column(y + 1 + R);
    float* sp = planes + (y & 1) * SX * T::SZ;
    sp[(tz + R) * SX + tx + R] = q[R];
#pragma unroll
    for (int i = 0; i < kNH; ++i)
      if (hl[i] >= 0) sp[hl[i]] = hv[i];
    const float upc = upn, mc = mn, ac = an, dc = dn, ilc = iln, hc = hn;
    if (y + 1 < y1) fetch(y + 1);
    // one barrier a plane: the next plane's tile goes to the other buffer
    __syncthreads();
    if (!own) continue;
    const float* c = sp + (tz + R) * SX + tx + R;
    const float uc = q[R];
    float accx = s.w[0] * c[0];
#pragma unroll
    for (int k = 1; k <= R; ++k) accx = accx + s.w[k] * (c[k] + c[-k]);
    float accy = s.w[0] * uc;
#pragma unroll
    for (int k = 1; k <= R; ++k)
      accy = accy + s.w[k] * (q[R + k] + q[R - k]);
    float accz = s.w[0] * c[0];
    if (FS && z <= R) {
      // free-surface rows: plain +k term, then the odd mirror (zero at z = 0)
#pragma unroll
      for (int k = 1; k <= R; ++k) {
        accz = accz + s.w[k] * c[k * SX];
        const int i = z - k;
        if (i > 0) {
          accz = accz + s.w[k] * c[-k * SX];
        } else if (i < 0) {
          accz = accz - s.w[k] * c[(k - 2 * z) * SX];  // row -i
        }
      }
    } else {
#pragma unroll
      for (int k = 1; k <= R; ++k)
        accz = accz + s.w[k] * (c[k * SX] + c[-k * SX]);
    }
    const float lap = accx * s.ih2x + accy * s.ih2y + accz * s.ih2z;
    float un = (lap + ac * uc - mc * upc) * dc;
    const size_t cell = (size_t)y * plane + col;
    if (REV) {
      grad[off + cell] = ilc + hc * uc;
      if (z == z0 || z == z0 + 1)
        un = un + res[((bt * ny + y) * 2 + (z - z0)) * nx + x];
    } else {
      const int p = y - iyb;
      if (p == 0 || p == 1)
        un = un + wt * injp[(((size_t)b * 2 + p) * nz + z) * nx + x];
      if (z == z0 || z == z0 + 1)
        rec[((bt * ny + y) * 2 + (z - z0)) * nx + x] = uc;
      if (HIST) {
        dt2[bt * field + cell] = un - 2.0f * uc + upc;
        illum[off + cell] = ilc + un * un;
      }
    }
    up[off + cell] = un;
  }
}

__global__ void scale_inplace(float* __restrict__ a, size_t n, float c) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) a[i] = a[i] * c;
}

// One leapfrog step of an (nx, ny, nz) field, z contiguous: the eager
// update's association, lap = x term, then + y term, then + z term, each
// scaled by its unscaled 1/h^2, and s2 * lap.
template <int R>
__global__ void step_kernel(const float* __restrict__ u,
                            const float* __restrict__ up,
                            const float* __restrict__ m,
                            const float* __restrict__ hd,
                            const float* __restrict__ inv_mhd,
                            float* __restrict__ out, int nx, int ny, int nz,
                            float s2, Stencil s) {
  const int z = blockIdx.x * kBX + threadIdx.x;
  const int y = blockIdx.y * kBZ + threadIdx.y;
  const int x = blockIdx.z;
  if (z >= nz || y >= ny) return;
  const size_t cell = ((size_t)x * ny + y) * nz + z;
  const float accx = d2_axis<R>(u, cell, x, nx, (size_t)ny * nz, s);
  const float accy = d2_axis<R>(u, cell, y, ny, (size_t)nz, s);
  const float accz = d2_axis<R>(u, cell, z, nz, 1, s);
  float lap = accx * s.ih2x;
  lap = lap + accy * s.ih2y;
  lap = lap + accz * s.ih2z;
  const float mc = m[cell];
  out[cell] = (s2 * lap + (2.0f * mc + hd[cell]) * u[cell] - mc * up[cell]) *
              inv_mhd[cell];
}

Stencil make_stencil(const float* w, int r, float ih2x, float ih2y,
                     float ih2z) {
  Stencil s = {};
  for (int k = 0; k <= r; ++k) s.w[k] = w[k];
  s.ih2x = ih2x;
  s.ih2y = ih2y;
  s.ih2z = ih2z;
  return s;
}

struct SweepArgs {
  const float *m, *two_m_hd, *denom, *wav, *injp, *hist, *res;
  const int* iy;
  float *rec, *dt2, *illum, *grad, *a, *b;
  int B, ny, nz, nx, nsteps, z0, ylen;
  float neg_inv_s2;
  Stencil s;
  cudaStream_t stream;
};

// One march launch a step: blockIdx.x the shot, .y the x tile, .z the z
// tile and the y-chunk of ylen planes; the state ping-pongs over a and b.
// The forwards walk t up, the reverse walks it down and then scales grad
// by -1/s^2 in a launch of its own.
template <int R, bool FS, int MODE>
int run_march(const SweepArgs& a) {
  const int nzt = (a.nz + kMZ - 1) / kMZ;
  const int chunks = (a.ny + a.ylen - 1) / a.ylen;
  const dim3 grid(a.B, (a.nx + kMX - 1) / kMX, nzt * chunks);
  float* u = a.a;
  float* up = a.b;
  for (int k = 0; k < a.nsteps; ++k) {
    const int t = MODE == kReverse ? a.nsteps - 1 - k : k;
    march<R, FS, MODE><<<grid, kMThreads, 0, a.stream>>>(
        u, up, a.m, a.two_m_hd, a.denom, a.wav, a.injp, a.iy, a.rec, a.dt2,
        a.illum, a.hist, a.res, a.grad, t, a.nsteps, a.ny, a.nz, a.nx, a.z0,
        a.ylen, a.s);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    float* tmp = u;
    u = up;
    up = tmp;
  }
  if (MODE != kReverse) return 0;
  const size_t n = (size_t)a.B * a.ny * a.nz * a.nx;
  const int threads = 256;
  scale_inplace<<<(unsigned)((n + threads - 1) / threads), threads, 0,
                  a.stream>>>(a.grad, n, a.neg_inv_s2);
  return (int)cudaGetLastError();
}

// Dispatch the runtime radius and free-surface flag onto the unrolled
// instantiations.
template <int MODE>
int dispatch(int r, int fs, const SweepArgs& a) {
#define ACOUSTIC3D_CASE(RR)                                             \
  case RR:                                                              \
    return fs ? run_march<RR, true, MODE>(a) : run_march<RR, false, MODE>(a);
  switch (r) {
    ACOUSTIC3D_CASE(1)
    ACOUSTIC3D_CASE(2)
    ACOUSTIC3D_CASE(3)
    ACOUSTIC3D_CASE(4)
    ACOUSTIC3D_CASE(5)
    ACOUSTIC3D_CASE(6)
    ACOUSTIC3D_CASE(7)
    ACOUSTIC3D_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef ACOUSTIC3D_CASE
}

// What the march takes: a positive grid of fewer than 2^31 cells a plane,
// at most (2^31 - 1, 65535, 65535) blocks, a positive chunk length.
bool march_shape_ok(int r, int B, int ny, int nz, int nx, int nsteps, int z0,
                    int ylen) {
  if (r < 1 || r > kMaxR || B < 1 || ny < 1 || nz < 2 || nx < 1 ||
      nsteps < 0 || ylen < 1 || z0 < 0 || z0 + 2 > nz ||
      (long long)nz * nx >= (1LL << 31))
    return false;
  const long long nzt = (nz + kMZ - 1) / kMZ;
  const long long chunks = (ny + (long long)ylen - 1) / ylen;
  return (nx + kMX - 1) / kMX <= 65535 && nzt * chunks <= 65535;
}

}  // namespace

extern "C" {

// Forward sweep over t = 0 .. nsteps-1 from the zero state in u, up
// ((B, ny, nz, nx) scratch holding zeros), each step marched over y-chunks
// of ylen planes. rec is (B, nsteps, ny, 2, nx). dt2 (B, nsteps, ny, nz,
// nx) and illum (B, ny, nz, nx, zeros on entry) are both set or both NULL.
// Returns the first CUDA error of a launch, or 0.
int acoustic3d_forward(const float* m, const float* two_m_hd,
                       const float* denom, const float* wav,
                       const float* injp, const int* iy, float* rec,
                       float* dt2, float* illum, float* u, float* up, int B,
                       int ny, int nz, int nx, int nsteps, int z0, int fs,
                       int r, int ylen, const float* w, float ih2x,
                       float ih2y, float ih2z, void* stream) {
  if (!march_shape_ok(r, B, ny, nz, nx, nsteps, z0, ylen) ||
      (dt2 == NULL) != (illum == NULL))
    return (int)cudaErrorInvalidValue;
  SweepArgs a = {};
  a.m = m;
  a.two_m_hd = two_m_hd;
  a.denom = denom;
  a.wav = wav;
  a.injp = injp;
  a.iy = iy;
  a.rec = rec;
  a.dt2 = dt2;
  a.illum = illum;
  a.a = u;
  a.b = up;
  a.B = B;
  a.ny = ny;
  a.nz = nz;
  a.nx = nx;
  a.nsteps = nsteps;
  a.z0 = z0;
  a.ylen = ylen;
  a.s = make_stencil(w, r, ih2x, ih2y, ih2z);
  a.stream = (cudaStream_t)stream;
  return dt2 != NULL ? dispatch<kHist>(r, fs, a) : dispatch<kRec>(r, fs, a);
}

// Reverse sweep over t = nsteps-1 .. 0 of the history dt2
// (B, nsteps, ny, nz, nx) with the residual slabs res (B, nsteps, ny, 2,
// nx), each step marched over y-chunks of ylen planes, then grad *=
// neg_inv_s2. grad, v and vn are (B, ny, nz, nx) and hold zeros on entry.
int acoustic3d_gradient(const float* m, const float* two_m_hd,
                        const float* denom, const float* dt2,
                        const float* res, float* grad, float* v, float* vn,
                        int B, int ny, int nz, int nx, int nsteps, int z0,
                        int fs, int r, int ylen, const float* w, float ih2x,
                        float ih2y, float ih2z, float neg_inv_s2,
                        void* stream) {
  if (!march_shape_ok(r, B, ny, nz, nx, nsteps, z0, ylen))
    return (int)cudaErrorInvalidValue;
  SweepArgs a = {};
  a.m = m;
  a.two_m_hd = two_m_hd;
  a.denom = denom;
  a.hist = dt2;
  a.res = res;
  a.grad = grad;
  a.a = v;
  a.b = vn;
  a.B = B;
  a.ny = ny;
  a.nz = nz;
  a.nx = nx;
  a.nsteps = nsteps;
  a.z0 = z0;
  a.ylen = ylen;
  a.neg_inv_s2 = neg_inv_s2;
  a.s = make_stencil(w, r, ih2x, ih2y, ih2z);
  a.stream = (cudaStream_t)stream;
  return dispatch<kReverse>(r, fs, a);
}

// One leapfrog step of (nx, ny, nz) fields into out (no free surface).
int acoustic3d_step(const float* u, const float* up, const float* m,
                    const float* hd, const float* inv_mhd, float* out,
                    int nx, int ny, int nz, float s2, int r, const float* w,
                    float ih2x, float ih2y, float ih2z, void* stream) {
  if (r < 1 || r > kMaxR || nx < 1 || nx > 65535 || ny < 1 || nz < 1)
    return (int)cudaErrorInvalidValue;
  const Stencil s = make_stencil(w, r, ih2x, ih2y, ih2z);
  const dim3 block(kBX, kBZ);
  const dim3 grid((nz + kBX - 1) / kBX, (ny + kBZ - 1) / kBZ, nx);
  cudaStream_t st = (cudaStream_t)stream;
  switch (r) {
#define ACOUSTIC3D_STEP(RR)                                                \
  case RR:                                                                 \
    step_kernel<RR><<<grid, block, 0, st>>>(u, up, m, hd, inv_mhd, out, nx, \
                                            ny, nz, s2, s);                 \
    break;
    ACOUSTIC3D_STEP(1)
    ACOUSTIC3D_STEP(2)
    ACOUSTIC3D_STEP(3)
    ACOUSTIC3D_STEP(4)
    ACOUSTIC3D_STEP(5)
    ACOUSTIC3D_STEP(6)
    ACOUSTIC3D_STEP(7)
    ACOUSTIC3D_STEP(8)
#undef ACOUSTIC3D_STEP
  }
  return (int)cudaGetLastError();
}

const char* acoustic3d_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
