// 2-D TTI (tilted transverse isotropy) sweeps for Hopper (sm_90a), plain C
// interface for ctypes. Three entry points, each one sweep over all time
// steps of a shot batch on the caller's stream (the forward two kernel
// launches a step, the reverse one):
//
//   tti2d_forward(..., udt2 != NULL)
//       replaces forward_dt2_pallas (devito_fwi_tpu/ops/pallas_tti.py:539,
//       _fwd_dt2_kernel :297): the coupled (u, v) forward that records, at
//       every step, rows z0 and z0 + 1 of u + v before the update and
//       writes the d2/dt2 histories un - 2u + up and vn - 2v + vp.
//   tti2d_forward(..., starts != NULL)
//       replaces forward_ckpt_pallas (pallas_tti.py:446, _fwd_kernel :151):
//       the same forward, writing (u, u_prev, v, v_prev) at the start of
//       every segment instead of the histories.
//   tti2d_adjoint
//       replaces gradient_stream_pallas (pallas_tti.py:590,
//       _grad_stream_kernel :353): the coupled adjoint (du, dv) walked from
//       step nsteps-1 down to 0 over the streamed histories, accumulating
//       grad + udt2 du + vdt2 dv (unscaled) and adding the residual rows to
//       both adjoint fields on rows z0, z0 + 1 after the update.
//   tti2d_jacobian_adjoint
//       replaces jacobian_adjoint_pallas (pallas_tti.py:494, _grad_kernel
//       :204): for each segment from the last, the forward steps recomputed
//       from its start state into a one-segment history in device memory,
//       then the segment's adjoint steps as in tti2d_adjoint.
//
// The operators (x = axis 0, the contiguous one; z = axis 1), with D1 the
// centred first derivative of radius R/2 and D2 the second derivative of
// radius R, both zero beyond the padded grid:
//   gz(f)  = -(sin th D1x f + cos th D1z f)
//   gzz(f) = -(D1x(sin th gz(f)) + D1z(cos th gz(f)))
//   gxx(f) = (D2x f + D2z f) - gzz(f)
// Forward:  un = (s2 (eh gxx(u) + dh gzz(v)) + (2m + hd) u - m up) / (m+hd)
//                + wav[t] inj
//           vn = (s2 (dh gxx(u) + gzz(v)) + (2m + hd) v - m vp) / (m+hd)
//                + wav[t] inj
// Reverse:  du' = (s2 gxx(eh du + dh dv) + (2m + hd) du - m dun) / (m+hd)
//           dv' = (s2 gzz(dh du + dv) + (2m + hd) dv - m dvn) / (m+hd)
// with 1/(m+hd) and 2m+hd precomputed by the caller.
//
// Layout: fields are (B, nz, nx) float32 with x contiguous (the transposed
// layout of the JAX kernels); the seven coefficient fields m, 2m+hd,
// 1/(m+hd), eh = 1+2eps, dh = sqrt(1+2delta), sin th, cos th are (nz, nx)
// and shared by all shots; the source patterns inj (w dt^2/m at each shot's
// corners) are (B, nz, nx); wav is (total + 1,) with dt^2 in slot 0 and the
// wavelet of step t in slot t + 1; receiver and residual rows are
// (B, total, 2, nx); the histories (B, total, nz, nx) each; the segment
// starts (B, nseg, 4, nz, nx).
//
// What bounds it on the card: the streamed forward writes
// 2 * B * total * nz * nx * 4 bytes of history (7.15 GB for 8 marmousi-tti2d
// shots) and the reverse reads them back, about 2.1 ms each way at
// 3.35 TB/s, about as long as their ~131 float operations per cell and step
// at 67 TFLOP/s (space order 8); the checkpoint pair moves little and is
// bound by its operations (the recompute sweep and the reverse). Taken a
// step at a time, a sweep's floor is its state through device memory once
// a step: the fields of 8 shots (2.3 MB a field) fit the 50 MB L2 only in
// part, and every step's history slot is new.
//
// The forwards (fwd_gz, fwd_update): one thread per cell, one launch per
// phase per step for the whole batch (blockIdx.z is the shot). gzz
// differentiates sin th gz and cos th gz, where gz is itself a stencil of
// the field, so a step has two phases: the gz phase writes the products
// sin th gz and cos th gz of u and v into four scratch fields; the update
// phase takes their D1s, the Laplacian and the update, reads only its own
// cell of the previous fields and writes the new field over them (the host
// then swaps the two pointers). Both D1s see zeros beyond the padded grid:
// the product field's neighbour outside the grid is 0, not gz
// extrapolated. Neighbours come through L1/L2. Per step that is 24 batch
// fields (the products written and read back, the dense source pattern
// read, the seven coefficients once a shot), 26 with the histories.
//
// The reverse (adjoint_fused): the first design ran the forwards' two
// phases, 29 batch fields a step (the four products of a = eh du + dh dv
// and b = dh du + dv written and read back, a and b formed again from four
// loads at every tap, nine coefficient reads once a shot). The fused
// step is one launch: a block owns a 32 x 16 (x, z) tile of one shot, the
// shots the grid's fastest axis, so a tile's coefficients stay in L2
// across its shots. It forms a and b once a cell on the tile and an R ring
// in shared memory (of the ring's corners only the R1 x R1 next to the
// tile, R1 = R/2, which the products read), then the four products on the
// tile and an R1 ring along their axis (zero at ring cells beyond the
// grid, as the two-phase kernels' product fields were), then at the tile's
// cells the gradient term and the update: du, dv, dun, dvn, both history
// slots and grad read, grad, dun and dvn written: 10 batch fields and the
// seven coefficients once a step. Forming a and b once a cell gives the
// bits of forming them at each tap. The checkpoint route's reverse
// (tti2d_jacobian_adjoint) runs the same step after each segment's
// recompute. Times against these floors are in PERF.md (rows 14-17).
//
// Numerics: each kernel keeps the Pallas kernels' association term for term
// (D1 summed tap by tap from its first non-zero weight, then times 1/h; D2
// as w0 f + sum_k wk (f[+k] + f[-k]), then times (1/h)^2 formed in double
// from the float 1/h; the x term first), and the library is compiled with
// -fmad=false, so the kernels round exactly like the plain torch twins in
// ops/cuda_tti.py. Offsets into the histories, rows and starts are 64-bit.
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kMaxR = 8;
constexpr int kBX = 32;
constexpr int kBY = 8;

struct Coefs {
  float w1[kMaxR + 1];  // centred first derivative, 2 * (R/2) + 1 taps
  float w2[kMaxR + 1];  // second derivative, w2[0] and the R one-sided taps
  float ihx, ihz;       // 1/h
  float ihx2, ihz2;     // (1/h)^2 of the float 1/h, rounded once
};

struct Params {
  const float *m, *two_m_hd, *inv_mhd, *eh, *dh, *st, *ct;
};

// sum over the non-zero weights of w1 in tap order (the first term starts
// the sum), zero beyond 0..n-1, times ih
template <int R1, class F>
__device__ __forceinline__ float d1(F f, int i, int n, const float* w1,
                                    float ih) {
  float acc = 0.0f;
  bool first = true;
#pragma unroll
  for (int k = 0; k <= 2 * R1; ++k) {
    if (w1[k] != 0.0f) {
      const int j = i + k - R1;
      const float v = (j >= 0 && j < n) ? f(j) : 0.0f;
      const float term = w1[k] * v;
      acc = first ? term : acc + term;
      first = false;
    }
  }
  return acc * ih;
}

// w2[0] f(i) + sum_k w2[k] (f(i+k) + f(i-k)), zero beyond 0..n-1, times ih2
template <int R, class F>
__device__ __forceinline__ float d2(F f, int i, int n, const float* w2,
                                    float ih2) {
  float acc = w2[0] * f(i);
#pragma unroll
  for (int k = 1; k <= R; ++k) {
    const float a = (i + k < n) ? f(i + k) : 0.0f;
    const float b = (i - k >= 0) ? f(i - k) : 0.0f;
    acc = acc + w2[k] * (a + b);
  }
  return acc * ih2;
}

// D1 along x / z at (z, x) of a cell function g(j) of the shot's flat index
template <int R1, class G>
__device__ __forceinline__ float d1x(G g, int z, int x, int nx,
                                     const Coefs& c) {
  const size_t row = (size_t)z * nx;
  return d1<R1>([&](int j) { return g(row + j); }, x, nx, c.w1, c.ihx);
}

template <int R1, class G>
__device__ __forceinline__ float d1z(G g, int z, int x, int nz, int nx,
                                     const Coefs& c) {
  return d1<R1>([&](int j) { return g((size_t)j * nx + x); }, z, nz, c.w1,
                c.ihz);
}

// the Laplacian D2x + D2z, the x term first
template <int R, class G>
__device__ __forceinline__ float lap(G g, int z, int x, int nz, int nx,
                                     const Coefs& c) {
  const size_t row = (size_t)z * nx;
  const float lx = d2<R>([&](int j) { return g(row + j); }, x, nx, c.w2,
                         c.ihx2);
  const float lz = d2<R>([&](int j) { return g((size_t)j * nx + x); }, z, nz,
                         c.w2, c.ihz2);
  return lx + lz;
}

// gzz from the product fields ps = sin th gz, pc = cos th gz of one shot
template <int R1>
__device__ __forceinline__ float gzz(const float* __restrict__ ps,
                                     const float* __restrict__ pc, int z,
                                     int x, int nz, int nx, const Coefs& c) {
  const float a = d1x<R1>([&](size_t j) { return ps[j]; }, z, x, nx, c);
  const float b = d1z<R1>([&](size_t j) { return pc[j]; }, z, x, nz, nx, c);
  return -(a + b);
}

// the products sin th gz(f), cos th gz(f) at the cell
template <int R1, class G>
__device__ __forceinline__ void gz_products(G g, float sth, float cth,
                                            int z, int x, int nz, int nx,
                                            const Coefs& c, float* ps,
                                            float* pc) {
  const float gz = -(sth * d1x<R1>(g, z, x, nx, c) +
                     cth * d1z<R1>(g, z, x, nz, nx, c));
  *ps = sth * gz;
  *pc = cth * gz;
}

#define CELL_INDEX                                       \
  const int x = blockIdx.x * kBX + threadIdx.x;          \
  const int z = blockIdx.y * kBY + threadIdx.y;          \
  const int s = blockIdx.z;                              \
  if (x >= nx || z >= nz) return;                        \
  const size_t field = (size_t)nz * nx;                  \
  const size_t cell = (size_t)z * nx + x;                \
  const size_t so = (size_t)s * field;                   \
  const size_t o = so + cell;

// gz phase of forward step t: the receiver rows of u + v and the segment
// start (when asked for), then the four product fields of u and v.
template <int R1>
__global__ void fwd_gz(Params q, const float* __restrict__ u,
                       const float* __restrict__ up,
                       const float* __restrict__ v,
                       const float* __restrict__ vp, float* __restrict__ psu,
                       float* __restrict__ pcu, float* __restrict__ psv,
                       float* __restrict__ pcv, float* __restrict__ rec,
                       float* __restrict__ starts, int t, int total, int seg,
                       int nz, int nx, int z0, Coefs c) {
  CELL_INDEX
  if (rec != NULL && (z == z0 || z == z0 + 1))
    rec[(((size_t)s * total + t) * 2 + (z - z0)) * nx + x] = u[o] + v[o];
  if (starts != NULL && t % seg == 0) {
    float* p = starts + ((size_t)s * (total / seg) + t / seg) * 4 * field +
               cell;
    p[0] = u[o];
    p[field] = up[o];
    p[2 * field] = v[o];
    p[3 * field] = vp[o];
  }
  const float sth = q.st[cell];
  const float cth = q.ct[cell];
  const float* us = u + so;
  const float* vs = v + so;
  gz_products<R1>([&](size_t j) { return us[j]; }, sth, cth, z, x, nz, nx, c,
                  psu + o, pcu + o);
  gz_products<R1>([&](size_t j) { return vs[j]; }, sth, cth, z, x, nz, nx, c,
                  psv + o, pcv + o);
}

// Update phase of forward step t: un over up and vn over vp (the caller
// swaps u and up, v and vp); with DT2 the histories at slot th of htotal.
template <int R, bool DT2>
__global__ void fwd_update(Params q, const float* __restrict__ u,
                           float* __restrict__ up,
                           const float* __restrict__ v,
                           float* __restrict__ vp,
                           const float* __restrict__ psu,
                           const float* __restrict__ pcu,
                           const float* __restrict__ psv,
                           const float* __restrict__ pcv,
                           const float* __restrict__ wav,
                           const float* __restrict__ inj,
                           float* __restrict__ udt2, float* __restrict__ vdt2,
                           int t, int th, int htotal, int nz, int nx,
                           Coefs c) {
  constexpr int R1 = R / 2;
  CELL_INDEX
  const float* us = u + so;
  const float gxx_u =
      lap<R>([&](size_t j) { return us[j]; }, z, x, nz, nx, c) -
      gzz<R1>(psu + so, pcu + so, z, x, nz, nx, c);
  const float gzz_v = gzz<R1>(psv + so, pcv + so, z, x, nz, nx, c);
  const float s2 = wav[0];
  const float wt = wav[t + 1];
  const float m = q.m[cell];
  const float tm = q.two_m_hd[cell];
  const float im = q.inv_mhd[cell];
  const float eh = q.eh[cell];
  const float dh = q.dh[cell];
  const float uo = u[o], upo = up[o], vo = v[o], vpo = vp[o];
  const float injo = inj[o];
  const float un =
      (((s2 * (eh * gxx_u + dh * gzz_v)) + tm * uo) - m * upo) * im +
      wt * injo;
  const float vn =
      (((s2 * (dh * gxx_u + gzz_v)) + tm * vo) - m * vpo) * im + wt * injo;
  if (DT2) {
    const size_t h = ((size_t)s * htotal + th) * field + cell;
    udt2[h] = (un - 2.0f * uo) + upo;
    vdt2[h] = (vn - 2.0f * vo) + vpo;
  }
  up[o] = un;
  vp[o] = vn;
}

// The fused reverse step's tile (adjoint_fused): kATX x kATZ (x, z) cells
// of one shot, kAThreads threads, kCells cells a thread. 32 x 16 at one
// cell a thread puts four blocks on an SM (32 registers a thread) and
// twice the blocks of 32 x 32 in flight, which outweighs its larger ring
// (tools/probe_reverses.py).
constexpr int kATX = 32;
constexpr int kATZ = 16;
constexpr int kAThreads = 512;
constexpr int kCells = kATX * kATZ / kAThreads;
static_assert(kATX * kATZ % kAThreads == 0, "whole cells a thread");

// Shared memory of the fused reverse step: a and b on the tile and an R
// ring (the ring's corners only R1 deep are formed), the products of both
// along x on the tile's rows and an R1 ring in x, along z on its columns
// and an R1 ring in z.
template <int R>
struct AdjTile {
  static constexpr int R1 = R / 2;
  static constexpr int SX = kATX + 2 * R;     // a, b: SZ rows x SX
  static constexpr int SZ = kATZ + 2 * R;
  static constexpr int PXW = kATX + 2 * R1;   // x products: kATZ x PXW
  static constexpr int PZH = kATZ + 2 * R1;   // z products: PZH x kATX
  static constexpr int kFloats =
      2 * SX * SZ + 2 * kATZ * PXW + 2 * PZH * kATX;
};
static_assert(AdjTile<kMaxR>::kFloats * sizeof(float) <= 48 * 1024,
              "static shared memory");

// D1 of R1 taps along stride ``st`` of a shared-memory array at p: the
// non-zero weights in tap order (the first term starts the sum), times ih
template <int R1>
__device__ __forceinline__ float sd1(const float* p, int st,
                                     const float* w1, float ih) {
  float acc = 0.0f;
  bool first = true;
#pragma unroll
  for (int k = 0; k <= 2 * R1; ++k) {
    if (w1[k] != 0.0f) {
      const float term = w1[k] * p[(k - R1) * st];
      acc = first ? term : acc + term;
      first = false;
    }
  }
  return acc * ih;
}

// D2 of R taps along stride ``st`` at p: w2[0] f + sum_k w2[k] (f[+k] +
// f[-k]), times ih2
template <int R>
__device__ __forceinline__ float sd2(const float* p, int st,
                                     const float* w2, float ih2) {
  float acc = w2[0] * p[0];
#pragma unroll
  for (int k = 1; k <= R; ++k) acc = acc + w2[k] * (p[k * st] + p[-k * st]);
  return acc * ih2;
}

// Reverse step th (a history slot of htotal; t the residual row of
// rtotal) over one tile of one shot, fused: the gradient term, then a =
// eh du + dh dv and b = dh du + dv once a cell into shared memory, their
// gz products, and the update of du over dun and dv over dvn at the
// tile's cells (read there only; the caller swaps the pointers), the
// residual rows added on z0, z0 + 1. Zero beyond the padded grid: a and
// b, and the products, so that each D1 and D2 sees the two-phase
// kernels' zeros.
template <int R>
__global__ void __launch_bounds__(kAThreads)
adjoint_fused(Params q, const float* __restrict__ du, float* __restrict__ dun,
              const float* __restrict__ dv, float* __restrict__ dvn,
              const float* __restrict__ udt2, const float* __restrict__ vdt2,
              float* __restrict__ grad, const float* __restrict__ res,
              int th, int htotal, int t, int rtotal, float s2, int nz,
              int nx, int z0, Coefs c) {
  using T = AdjTile<R>;
  constexpr int R1 = T::R1;
  constexpr int SX = T::SX;
  constexpr int PXW = T::PXW;
  __shared__ float sm[T::kFloats];
  float* sa = sm;                          // a
  float* sb = sa + SX * T::SZ;             // b
  float* psa = sb + SX * T::SZ;            // sin th gz(a), x products
  float* psb = psa + kATZ * PXW;           // sin th gz(b)
  float* pca = psb + kATZ * PXW;           // cos th gz(a), z products
  float* pcb = pca + T::PZH * kATX;        // cos th gz(b)
  const int b = blockIdx.x;                // the shots of a tile adjoin
  const int xt = blockIdx.y * kATX;
  const int zt = blockIdx.z * kATZ;
  const int tid = threadIdx.x;
  const size_t field = (size_t)nz * nx;
  const size_t off = (size_t)b * field;
  const size_t hoff = ((size_t)b * htotal + th) * field;

  // 0. the tile's own operands, kCells a thread, read first: their loads'
  // latency hides under phases 1 and 2
  float gr[kCells], hu[kCells], hv[kCells], dn[kCells], en[kCells];
#pragma unroll
  for (int i = 0; i < kCells; ++i) {
    const int k = tid + i * kAThreads;
    const int gx = xt + k % kATX;
    const int gz = zt + k / kATX;
    gr[i] = hu[i] = hv[i] = dn[i] = en[i] = 0.0f;
    if (gx < nx && gz < nz) {
      const size_t cell = (size_t)gz * nx + gx;
      gr[i] = grad[off + cell];
      hu[i] = udt2[hoff + cell];
      hv[i] = vdt2[hoff + cell];
      dn[i] = dun[off + cell];
      en[i] = dvn[off + cell];
    }
  }

  // 1. a and b on the tile and its R ring, zero beyond the grid; of the
  // ring's corners only the R1 x R1 next to the tile, which the products
  // of the R1 ring read
  for (int k = tid; k < SX * T::SZ; k += kAThreads) {
    const int lx = k % SX;
    const int lz = k / SX;
    const int ox = lx < R ? R - lx : max(lx - (R + kATX - 1), 0);
    const int oz = lz < R ? R - lz : max(lz - (R + kATZ - 1), 0);
    if (ox > 0 && oz > 0 && (ox > R1 || oz > R1)) continue;
    const int gx = xt - R + lx;
    const int gz = zt - R + lz;
    float av = 0.0f, bv = 0.0f;
    if (gx >= 0 && gx < nx && gz >= 0 && gz < nz) {
      const size_t cell = (size_t)gz * nx + gx;
      const float e = q.eh[cell];
      const float d = q.dh[cell];
      const float u = du[off + cell];
      const float v = dv[off + cell];
      av = e * u + d * v;
      bv = d * u + v;
    }
    sa[k] = av;
    sb[k] = bv;
  }
  __syncthreads();

  // 2. the products sin th gz and cos th gz of a and b: on the tile's rows
  // and an R1 ring in x (sin along x; cos too on the tile), then on the
  // R1 rows above and below the tile (cos); zero beyond the grid
  constexpr int kNX = kATZ * PXW;
  for (int k = tid; k < kNX + 2 * R1 * kATX; k += kAThreads) {
    int px, pz;                            // place in the x-product strip
    if (k < kNX) {
      px = k % PXW;
      pz = k / PXW;
    } else {
      const int j = k - kNX;
      px = R1 + j % kATX;
      pz = j / kATX;
      pz = pz < R1 ? pz - R1 : pz - R1 + kATZ;
    }
    const int gx = xt - R1 + px;
    const int gz = zt + pz;
    const bool xrow = k < kNX;
    const bool zcol = px >= R1 && px < R1 + kATX;
    float sA = 0.0f, sB = 0.0f, cA = 0.0f, cB = 0.0f;
    if (gx >= 0 && gx < nx && gz >= 0 && gz < nz) {
      const size_t cell = (size_t)gz * nx + gx;
      const float sth = q.st[cell];
      const float cth = q.ct[cell];
      const int ci = (pz + R) * SX + px + R - R1;
      const float ga = -(sth * sd1<R1>(sa + ci, 1, c.w1, c.ihx) +
                         cth * sd1<R1>(sa + ci, SX, c.w1, c.ihz));
      const float gb = -(sth * sd1<R1>(sb + ci, 1, c.w1, c.ihx) +
                         cth * sd1<R1>(sb + ci, SX, c.w1, c.ihz));
      sA = sth * ga;
      sB = sth * gb;
      cA = cth * ga;
      cB = cth * gb;
    }
    if (xrow) {
      psa[pz * PXW + px] = sA;
      psb[pz * PXW + px] = sB;
    }
    if (zcol) {
      const int zi = (pz + R1) * kATX + px - R1;
      pca[zi] = cA;
      pcb[zi] = cB;
    }
  }
  __syncthreads();

  // 3. the gradient term and the update at the tile's cells
  const float* rs = res + ((size_t)b * rtotal + t) * 2 * nx;
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
    const float duo = du[o];
    const float dvo = dv[o];
    grad[o] = (gr[i] + hu[i] * duo) + hv[i] * dvo;
    const float* ac = sa + (tz + R) * SX + tx + R;
    const float lap = sd2<R>(ac, 1, c.w2, c.ihx2) +
                      sd2<R>(ac, SX, c.w2, c.ihz2);
    const int xi = tz * PXW + tx + R1;
    const int zi = (tz + R1) * kATX + tx;
    const float gzz_a = -(sd1<R1>(psa + xi, 1, c.w1, c.ihx) +
                          sd1<R1>(pca + zi, kATX, c.w1, c.ihz));
    const float gzz_b = -(sd1<R1>(psb + xi, 1, c.w1, c.ihx) +
                          sd1<R1>(pcb + zi, kATX, c.w1, c.ihz));
    const float h0 = lap - gzz_a;
    const float m = q.m[cell];
    const float tm = q.two_m_hd[cell];
    const float im = q.inv_mhd[cell];
    float an = (((s2 * h0) + tm * duo) - m * dn[i]) * im;
    float bn = (((s2 * gzz_b) + tm * dvo) - m * en[i]) * im;
    if (gz == z0 || gz == z0 + 1) {
      const float r = rs[(gz - z0) * nx + gx];
      an = an + r;
      bn = bn + r;
    }
    dun[o] = an;
    dvn[o] = bn;
  }
}

// The start state of segment k into (u, up, v, vp).
__global__ void load_start(const float* __restrict__ starts, int k, int nseg,
                           float* __restrict__ u, float* __restrict__ up,
                           float* __restrict__ v, float* __restrict__ vp,
                           int nz, int nx) {
  CELL_INDEX
  const float* p = starts + ((size_t)s * nseg + k) * 4 * field + cell;
  u[o] = p[0];
  up[o] = p[field];
  v[o] = p[2 * field];
  vp[o] = p[3 * field];
}

struct State {
  Params q;
  const float *wav, *inj, *starts_in, *res, *udt2_in, *vdt2_in;
  float *rec, *udt2, *vdt2, *starts, *grad;
  float *u, *up, *v, *vp;          // forward state
  float *du, *dun, *dv, *dvn;      // adjoint state
  float *p1, *p2, *p3, *p4;        // the forward's product fields
  int B, nz, nx, total, seg, nseg, nsteps, z0;
  float s2;
  Coefs c;
  cudaStream_t stream;
};

template <class T>
void swap_ptr(T*& a, T*& b) {
  T* tmp = a;
  a = b;
  b = tmp;
}

// One forward step: t indexes the wavelet, the rows and the starts; th the
// history slot of htotal.
template <int R, bool DT2>
int forward_step(State& a, int t, float* rec, float* starts, float* udt2,
                 float* vdt2, int th, int htotal) {
  const dim3 block(kBX, kBY);
  const dim3 grid((a.nx + kBX - 1) / kBX, (a.nz + kBY - 1) / kBY, a.B);
  fwd_gz<R / 2><<<grid, block, 0, a.stream>>>(
      a.q, a.u, a.up, a.v, a.vp, a.p1, a.p2, a.p3, a.p4, rec, starts, t,
      a.total, a.seg, a.nz, a.nx, a.z0, a.c);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fwd_update<R, DT2><<<grid, block, 0, a.stream>>>(
      a.q, a.u, a.up, a.v, a.vp, a.p1, a.p2, a.p3, a.p4, a.wav, a.inj, udt2,
      vdt2, t, th, htotal, a.nz, a.nx, a.c);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  swap_ptr(a.u, a.up);
  swap_ptr(a.v, a.vp);
  return 0;
}

// One reverse step, one fused launch: th is the history slot of htotal, t
// the residual row.
template <int R>
int adjoint_step(State& a, const float* udt2, const float* vdt2, int th,
                 int htotal, int t) {
  const dim3 grid(a.B, (a.nx + kATX - 1) / kATX, (a.nz + kATZ - 1) / kATZ);
  adjoint_fused<R><<<grid, kAThreads, 0, a.stream>>>(
      a.q, a.du, a.dun, a.dv, a.dvn, udt2, vdt2, a.grad, a.res, th, htotal,
      t, a.nseg * a.seg, a.s2, a.nz, a.nx, a.z0, a.c);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  swap_ptr(a.du, a.dun);
  swap_ptr(a.dv, a.dvn);
  return 0;
}

template <int R>
struct Forward {
  static int run(State a) {
    for (int t = 0; t < a.total; ++t) {
      const int err = a.udt2 != NULL
          ? forward_step<R, true>(a, t, a.rec, NULL, a.udt2, a.vdt2, t,
                                  a.total)
          : forward_step<R, false>(a, t, a.rec, a.starts, NULL, NULL, 0, 1);
      if (err) return err;
    }
    return 0;
  }
};

template <int R>
struct Adjoint {
  static int run(State a) {
    // padded tail steps (t >= nsteps) are skipped in reverse
    for (int t = a.nsteps - 1; t >= 0; --t) {
      const int err = adjoint_step<R>(a, a.udt2_in, a.vdt2_in, t, a.total, t);
      if (err) return err;
    }
    return 0;
  }
};

template <int R>
struct JacobianAdjoint {
  static int run(State a) {
    const dim3 block(kBX, kBY);
    const dim3 grid((a.nx + kBX - 1) / kBX, (a.nz + kBY - 1) / kBY, a.B);
    for (int k = a.nseg - 1; k >= 0; --k) {
      const int base = k * a.seg;
      load_start<<<grid, block, 0, a.stream>>>(a.starts_in, k, a.nseg, a.u,
                                               a.up, a.v, a.vp, a.nz, a.nx);
      cudaError_t e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
      for (int i = 0; i < a.seg; ++i) {
        const int err = forward_step<R, true>(a, base + i, NULL, NULL,
                                              a.udt2, a.vdt2, i, a.seg);
        if (err) return err;
      }
      for (int j = a.seg - 1; j >= 0; --j) {
        if (base + j >= a.nsteps) continue;
        const int err = adjoint_step<R>(a, a.udt2, a.vdt2, j, a.seg,
                                        base + j);
        if (err) return err;
      }
    }
    return 0;
  }
};

// Dispatch the runtime radius onto the unrolled instantiations.
template <template <int> class F>
int dispatch_r(int r, const State& a) {
  switch (r) {
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

bool make_state(State* a, const float* m, const float* two_m_hd,
                const float* inv_mhd, const float* eh, const float* dh,
                const float* st, const float* ct, int B, int nz, int nx,
                int z0, int r, const float* w1, const float* w2, float ihx,
                float ihz, float ihx2, float ihz2, void* stream) {
  if (r < 2 || r > kMaxR || B < 1 || nz < 2 || nx < 1 || z0 < 0 ||
      z0 + 2 > nz)
    return false;
  *a = State();
  Params q = {m, two_m_hd, inv_mhd, eh, dh, st, ct};
  a->q = q;
  for (int k = 0; k <= 2 * (r / 2); ++k) a->c.w1[k] = w1[k];
  for (int k = 0; k <= r; ++k) a->c.w2[k] = w2[k];
  a->c.ihx = ihx;
  a->c.ihz = ihz;
  a->c.ihx2 = ihx2;
  a->c.ihz2 = ihz2;
  a->B = B;
  a->nz = nz;
  a->nx = nx;
  a->z0 = z0;
  a->stream = (cudaStream_t)stream;
  return true;
}

// The fused reverse step's grid (shots, x tiles, z tiles) within CUDA's
// (2^31 - 1, 65535, 65535) blocks.
bool adjoint_grid_ok(int nz, int nx) {
  return (nx + kATX - 1) / kATX <= 65535 && (nz + kATZ - 1) / kATZ <= 65535;
}

}  // namespace

extern "C" {

// Forward sweep over t = 0 .. total-1 from zero fields. rec is
// (B, total, 2, nx). Exactly one of udt2 (with vdt2, each
// (B, total, nz, nx)) and starts ((B, total/seg, 4, nz, nx), written at
// t = k seg) is not NULL. scratch is 8 (B, nz, nx) fields holding zeros:
// u, up, v, vp and the four product fields. w1 holds the 2(r/2)+1 first-
// derivative weights, w2 the r+1 second-derivative ones. Returns the first
// CUDA error of a launch, or 0.
int tti2d_forward(const float* m, const float* two_m_hd,
                  const float* inv_mhd, const float* eh, const float* dh,
                  const float* st, const float* ct, const float* wav,
                  const float* inj, float* rec, float* udt2, float* vdt2,
                  float* starts, float* scratch, int B, int nz, int nx,
                  int total, int seg, int z0, int r, const float* w1,
                  const float* w2, float ihx, float ihz, float ihx2,
                  float ihz2, void* stream) {
  State a;
  if (!make_state(&a, m, two_m_hd, inv_mhd, eh, dh, st, ct, B, nz, nx, z0,
                  r, w1, w2, ihx, ihz, ihx2, ihz2, stream) ||
      (udt2 == NULL) != (vdt2 == NULL) || (udt2 == NULL) == (starts == NULL)
      || seg < 1 || total < 1 || total % seg != 0)
    return (int)cudaErrorInvalidValue;
  const size_t n = (size_t)B * nz * nx;
  a.wav = wav;
  a.inj = inj;
  a.rec = rec;
  a.udt2 = udt2;
  a.vdt2 = vdt2;
  a.starts = starts;
  a.u = scratch;
  a.up = scratch + n;
  a.v = scratch + 2 * n;
  a.vp = scratch + 3 * n;
  a.p1 = scratch + 4 * n;
  a.p2 = scratch + 5 * n;
  a.p3 = scratch + 6 * n;
  a.p4 = scratch + 7 * n;
  a.total = total;
  a.seg = seg;
  a.nseg = total / seg;
  return dispatch_r<Forward>(r, a);
}

// Reverse sweep over t = nsteps-1 .. 0 of histories udt2, vdt2 of total
// steps each, with the residual rows res (B, total, 2, nx) and s2 = dt^2.
// grad (B, nz, nx) and scratch, 4 (B, nz, nx) fields (du, dun, dv, dvn),
// hold zeros on entry; grad receives the unscaled sum. Returns the first
// CUDA error of a launch, or 0.
int tti2d_adjoint(const float* m, const float* two_m_hd,
                  const float* inv_mhd, const float* eh, const float* dh,
                  const float* st, const float* ct, const float* udt2,
                  const float* vdt2, const float* res, float* grad,
                  float* scratch, int B, int nz, int nx, int total,
                  int nsteps, int z0, int r, const float* w1,
                  const float* w2, float ihx, float ihz, float ihx2,
                  float ihz2, float s2, void* stream) {
  State a;
  if (!make_state(&a, m, two_m_hd, inv_mhd, eh, dh, st, ct, B, nz, nx, z0,
                  r, w1, w2, ihx, ihz, ihx2, ihz2, stream) ||
      !adjoint_grid_ok(nz, nx) || nsteps < 1 || nsteps > total)
    return (int)cudaErrorInvalidValue;
  const size_t n = (size_t)B * nz * nx;
  a.udt2_in = udt2;
  a.vdt2_in = vdt2;
  a.res = res;
  a.grad = grad;
  a.du = scratch;
  a.dun = scratch + n;
  a.dv = scratch + 2 * n;
  a.dvn = scratch + 3 * n;
  a.total = total;
  a.seg = total;
  a.nseg = 1;
  a.nsteps = nsteps;
  a.s2 = s2;
  return dispatch_r<Adjoint>(r, a);
}

// Checkpoint-route reverse sweep: for k = nseg-1 .. 0 the seg forward steps
// of segment k from starts (B, nseg, 4, nz, nx) into the one-segment
// histories hist (2, B, seg, nz, nx), then its reverse steps t < nsteps
// with the residual rows res (B, nseg*seg, 2, nx). wav is
// (nseg*seg + 1,) as in tti2d_forward. grad (B, nz, nx) and scratch, 12
// (B, nz, nx) fields (du, dun, dv, dvn, u, up, v, vp and the forward's four
// product fields), hold zeros on entry. Returns the first CUDA error, or 0.
int tti2d_jacobian_adjoint(const float* m, const float* two_m_hd,
                           const float* inv_mhd, const float* eh,
                           const float* dh, const float* st, const float* ct,
                           const float* wav, const float* inj,
                           const float* starts, const float* res,
                           float* grad, float* hist, float* scratch, int B,
                           int nz, int nx, int seg, int nseg, int nsteps,
                           int z0, int r, const float* w1, const float* w2,
                           float ihx, float ihz, float ihx2, float ihz2,
                           float s2, void* stream) {
  State a;
  if (!make_state(&a, m, two_m_hd, inv_mhd, eh, dh, st, ct, B, nz, nx, z0,
                  r, w1, w2, ihx, ihz, ihx2, ihz2, stream) ||
      !adjoint_grid_ok(nz, nx) || seg < 1 || nseg < 1 || nsteps < 1 ||
      nsteps > seg * nseg)
    return (int)cudaErrorInvalidValue;
  const size_t n = (size_t)B * nz * nx;
  a.wav = wav;
  a.inj = inj;
  a.starts_in = starts;
  a.res = res;
  a.grad = grad;
  a.udt2 = hist;
  a.vdt2 = hist + (size_t)seg * n;
  a.du = scratch;
  a.dun = scratch + n;
  a.dv = scratch + 2 * n;
  a.dvn = scratch + 3 * n;
  a.u = scratch + 4 * n;
  a.up = scratch + 5 * n;
  a.v = scratch + 6 * n;
  a.vp = scratch + 7 * n;
  a.p1 = scratch + 8 * n;
  a.p2 = scratch + 9 * n;
  a.p3 = scratch + 10 * n;
  a.p4 = scratch + 11 * n;
  a.total = seg * nseg;
  a.seg = seg;
  a.nseg = nseg;
  a.nsteps = nsteps;
  a.s2 = s2;
  return dispatch_r<JacobianAdjoint>(r, a);
}

const char* tti2d_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
