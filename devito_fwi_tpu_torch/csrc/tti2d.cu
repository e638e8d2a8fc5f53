// 2-D TTI (tilted transverse isotropy) sweeps for Hopper (sm_90a), plain C
// interface for ctypes. Three entry points, each one sweep over all time
// steps of a shot batch on the caller's stream, one fused kernel launch a
// step:
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
// and shared by all shots; the source pattern inj (w dt^2/m at each shot's
// corners, at most four cells a shot) comes as each shot's non-zero cells
// (src_cell, src_val); wav is (total + 1,) with dt^2 in slot 0 and the
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
// Both directions have one shape: a first field pair (f, g), the forward's
// (u, v) and the reverse's (a, b) = (eh du + dh dv, dh du + dv), whose
// gxx(f) = lap(f) - gzz(f) and gzz(g) drive the update. The first design
// ran each step as two launches, one thread a cell: a gz phase that wrote
// the four products sin th gz and cos th gz of f and g to scratch fields
// and an update phase that read them back, with neighbours through L1/L2
// and, in the forward, the dense source pattern read at every cell: 26B
// shot fields a forward step with the histories (24B with the starts), 29B
// a reverse step, the coefficients once a shot.
//
// The fused step (forward_fused, adjoint_fused) is one launch: a block
// owns a kTX x kTZ (x, z) tile of one shot, the shots the grid's fastest
// axis, so a tile's coefficients stay in L2 across its shots. It forms f
// and g once a cell on the tile and an R ring in shared memory (of the
// ring's corners only the R1 x R1 next to the tile, R1 = R/2, which the
// products read), then the four products on the tile and an R1 ring along
// their axis (zero at ring cells beyond the grid, as the two-phase
// kernels' product fields were), then at the tile's cells the update.
// The forward reads u, v (its ring), up and vp and writes un over up and
// vn over vp (read only at the cell's own place; the host swaps the
// pointers): 6B shot fields a step and the seven coefficients once, 8B + 7
// with the two history writes; its receiver rows of u + v come from the
// tile in shared memory, and the source adds only at the shot's source
// cells (adding wav[t] * 0 at the others, as the pattern did, changes no
// value, only the sign of a zero). The reverse also reads both history
// slots and grad and writes grad: 10B + 7. Forming f and g once a cell
// gives the bits of forming them at each tap. The histories are written
// and read with streaming stores and loads, so that the step's state keeps
// its place in L2 (tools/probe_reverses.py). The checkpoint route runs
// the fused forward for each segment's recompute and the fused reverse
// after it. Times against these floors are in PERF.md (rows 14-17).
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

#define CELL_INDEX                                       \
  const int x = blockIdx.x * kBX + threadIdx.x;          \
  const int z = blockIdx.y * kBY + threadIdx.y;          \
  const int s = blockIdx.z;                              \
  if (x >= nx || z >= nz) return;                        \
  const size_t field = (size_t)nz * nx;                  \
  const size_t cell = (size_t)z * nx + x;                \
  const size_t o = (size_t)s * field + cell;

// The fused step's tile (forward_fused, adjoint_fused): kTX x kTZ (x, z)
// cells of one shot, kThreads threads, kCells cells a thread. 32 x 16 at
// one cell a thread puts four blocks on an SM (32 registers a thread) and
// twice the blocks of 32 x 32 in flight, which outweighs its larger ring
// (tools/probe_reverses.py).
constexpr int kTX = 32;
constexpr int kTZ = 16;
constexpr int kThreads = 512;
constexpr int kCells = kTX * kTZ / kThreads;
static_assert(kTX * kTZ % kThreads == 0, "whole cells a thread");

// Shared memory of the fused step: the field pair f, g on the tile and an
// R ring (the ring's corners only R1 deep are formed), the products of
// both along x on the tile's rows and an R1 ring in x, along z on its
// columns and an R1 ring in z.
template <int R>
struct FusedTile {
  static constexpr int R1 = R / 2;
  static constexpr int SX = kTX + 2 * R;      // f, g: SZ rows x SX
  static constexpr int SZ = kTZ + 2 * R;
  static constexpr int PXW = kTX + 2 * R1;    // x products: kTZ x PXW
  static constexpr int PZH = kTZ + 2 * R1;    // z products: PZH x kTX
  static constexpr int kFloats =
      2 * SX * SZ + 2 * kTZ * PXW + 2 * PZH * kTX;
};
static_assert(FusedTile<kMaxR>::kFloats * sizeof(float) <= 48 * 1024,
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

// The fused step's shared memory, carved from one static array.
template <int R>
struct Smem {
  using T = FusedTile<R>;
  float* sf;   // f on the tile and its R ring
  float* sg;   // g
  float* psf;  // sin th gz(f), x products
  float* psg;  // sin th gz(g)
  float* pcf;  // cos th gz(f), z products
  float* pcg;  // cos th gz(g)
  __device__ explicit Smem(float* sm)
      : sf(sm), sg(sm + T::SX * T::SZ), psf(sg + T::SX * T::SZ),
        psg(psf + kTZ * T::PXW), pcf(psg + kTZ * T::PXW),
        pcg(pcf + T::PZH * kTX) {}
};

// 1. The pair (f, g) on the tile at (xt, zt) and its R ring, zero beyond
// the grid; of the ring's corners only the R1 x R1 next to the tile, which
// the products of the R1 ring read. pair(cell, f, g) forms both at a cell
// of the grid.
template <int R, class Pair>
__device__ __forceinline__ void ring_pair(const Smem<R>& s, Pair pair,
                                          int xt, int zt, int nz, int nx) {
  using T = FusedTile<R>;
  constexpr int R1 = T::R1;
  constexpr int SX = T::SX;
  for (int k = threadIdx.x; k < SX * T::SZ; k += kThreads) {
    const int lx = k % SX;
    const int lz = k / SX;
    const int ox = lx < R ? R - lx : max(lx - (R + kTX - 1), 0);
    const int oz = lz < R ? R - lz : max(lz - (R + kTZ - 1), 0);
    if (ox > 0 && oz > 0 && (ox > R1 || oz > R1)) continue;
    const int gx = xt - R + lx;
    const int gz = zt - R + lz;
    float fv = 0.0f, gv = 0.0f;
    if (gx >= 0 && gx < nx && gz >= 0 && gz < nz)
      pair((size_t)gz * nx + gx, fv, gv);
    s.sf[k] = fv;
    s.sg[k] = gv;
  }
}

// 2. The products sin th gz and cos th gz of f and g: on the tile's rows
// and an R1 ring in x (sin along x; cos too on the tile), then on the R1
// rows above and below the tile (cos); zero beyond the grid.
template <int R>
__device__ __forceinline__ void ring_products(const Smem<R>& s,
                                              const Params& q, int xt,
                                              int zt, int nz, int nx,
                                              const Coefs& c) {
  using T = FusedTile<R>;
  constexpr int R1 = T::R1;
  constexpr int SX = T::SX;
  constexpr int PXW = T::PXW;
  constexpr int kNX = kTZ * PXW;
  for (int k = threadIdx.x; k < kNX + 2 * R1 * kTX; k += kThreads) {
    int px, pz;                            // place in the x-product strip
    if (k < kNX) {
      px = k % PXW;
      pz = k / PXW;
    } else {
      const int j = k - kNX;
      px = R1 + j % kTX;
      pz = j / kTX;
      pz = pz < R1 ? pz - R1 : pz - R1 + kTZ;
    }
    const int gx = xt - R1 + px;
    const int gz = zt + pz;
    const bool xrow = k < kNX;
    const bool zcol = px >= R1 && px < R1 + kTX;
    float sF = 0.0f, sG = 0.0f, cF = 0.0f, cG = 0.0f;
    if (gx >= 0 && gx < nx && gz >= 0 && gz < nz) {
      const size_t cell = (size_t)gz * nx + gx;
      const float sth = q.st[cell];
      const float cth = q.ct[cell];
      const int ci = (pz + R) * SX + px + R - R1;
      const float gf = -(sth * sd1<R1>(s.sf + ci, 1, c.w1, c.ihx) +
                         cth * sd1<R1>(s.sf + ci, SX, c.w1, c.ihz));
      const float gg = -(sth * sd1<R1>(s.sg + ci, 1, c.w1, c.ihx) +
                         cth * sd1<R1>(s.sg + ci, SX, c.w1, c.ihz));
      sF = sth * gf;
      sG = sth * gg;
      cF = cth * gf;
      cG = cth * gg;
    }
    if (xrow) {
      s.psf[pz * PXW + px] = sF;
      s.psg[pz * PXW + px] = sG;
    }
    if (zcol) {
      const int zi = (pz + R1) * kTX + px - R1;
      s.pcf[zi] = cF;
      s.pcg[zi] = cG;
    }
  }
}

// 3. At tile cell (tx, tz): gxx(f) = lap(f) - gzz(f) and gzz(g), from the
// shared arrays only.
template <int R>
__device__ __forceinline__ void tile_operators(const Smem<R>& s, int tx,
                                               int tz, const Coefs& c,
                                               float* gxx_f, float* gzz_g) {
  using T = FusedTile<R>;
  constexpr int R1 = T::R1;
  constexpr int SX = T::SX;
  const float* fc = s.sf + (tz + R) * SX + tx + R;
  const float lap = sd2<R>(fc, 1, c.w2, c.ihx2) + sd2<R>(fc, SX, c.w2, c.ihz2);
  const int xi = tz * T::PXW + tx + R1;
  const int zi = (tz + R1) * kTX + tx;
  const float gzz_f = -(sd1<R1>(s.psf + xi, 1, c.w1, c.ihx) +
                        sd1<R1>(s.pcf + zi, kTX, c.w1, c.ihz));
  *gzz_g = -(sd1<R1>(s.psg + xi, 1, c.w1, c.ihx) +
             sd1<R1>(s.pcg + zi, kTX, c.w1, c.ihz));
  *gxx_f = lap - gzz_f;
}

// Forward step t over one tile of one shot, fused: f = u, g = v. At the
// tile's cells the receiver rows of u + v (rows z0, z0 + 1, before the
// update) and, without DT2, the segment start (u, up, v, vp) when t is a
// multiple of seg; then un over up and vn over vp (read there only; the
// caller swaps the pointers), the source added at the shot's cells among
// its K listed ones; with DT2 the histories at slot th of htotal.
template <int R, bool DT2>
__global__ void __launch_bounds__(kThreads)
forward_fused(Params q, const float* __restrict__ u, float* __restrict__ up,
              const float* __restrict__ v, float* __restrict__ vp,
              const float* __restrict__ wav, const int* __restrict__ src_cell,
              const float* __restrict__ src_val, int K,
              float* __restrict__ rec, float* __restrict__ udt2,
              float* __restrict__ vdt2, float* __restrict__ starts, int t,
              int th, int htotal, int total, int seg, int nz, int nx, int z0,
              Coefs c) {
  using T = FusedTile<R>;
  __shared__ float sm[T::kFloats];
  const Smem<R> s(sm);
  const int b = blockIdx.x;                // the shots of a tile adjoin
  const int xt = blockIdx.y * kTX;
  const int zt = blockIdx.z * kTZ;
  const int tid = threadIdx.x;
  const size_t field = (size_t)nz * nx;
  const size_t off = (size_t)b * field;
  const int* cells_b = src_cell + (size_t)b * K;
  const float* vals_b = src_val + (size_t)b * K;

  // 0. the tile's previous fields, kCells a thread, read first: their
  // loads' latency hides under phases 1 and 2
  float po[kCells], qo[kCells];
#pragma unroll
  for (int i = 0; i < kCells; ++i) {
    const int k = tid + i * kThreads;
    const int gx = xt + k % kTX;
    const int gz = zt + k / kTX;
    po[i] = qo[i] = 0.0f;
    if (gx < nx && gz < nz) {
      const size_t cell = (size_t)gz * nx + gx;
      po[i] = up[off + cell];
      qo[i] = vp[off + cell];
    }
  }
  // does a source cell of the shot fall on the tile? Most tiles hold none.
  bool mine = false;
  for (int j = tid; j < K; j += kThreads) {
    const int cl = cells_b[j];
    if (cl >= 0) {
      const int cz = cl / nx;
      const int cx = cl - cz * nx;
      mine = mine || (cz >= zt && cz < zt + kTZ && cx >= xt && cx < xt + kTX);
    }
  }

  ring_pair<R>(s, [&](size_t cell, float& f, float& g) {
    f = u[off + cell];
    g = v[off + cell];
  }, xt, zt, nz, nx);
  const bool src = __syncthreads_or(mine);
  ring_products<R>(s, q, xt, zt, nz, nx, c);
  __syncthreads();

  // 3. the records and the update at the tile's cells
  const float s2 = wav[0];
  const float wt = wav[t + 1];
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
    const int si = (tz + R) * T::SX + tx + R;
    const float uo = s.sf[si];
    const float vo = s.sg[si];
    if (rec != NULL && (gz == z0 || gz == z0 + 1))
      rec[(bt * 2 + (gz - z0)) * nx + gx] = uo + vo;
    if (!DT2 && starts != NULL && t % seg == 0) {
      float* p = starts + ((size_t)b * (total / seg) + t / seg) * 4 * field +
                 cell;
      p[0] = uo;
      p[field] = po[i];
      p[2 * field] = vo;
      p[3 * field] = qo[i];
    }
    float gxx_u, gzz_v;
    tile_operators<R>(s, tx, tz, c, &gxx_u, &gzz_v);
    const float m = q.m[cell];
    const float tm = q.two_m_hd[cell];
    const float im = q.inv_mhd[cell];
    const float eh = q.eh[cell];
    const float dh = q.dh[cell];
    float un =
        (((s2 * (eh * gxx_u + dh * gzz_v)) + tm * uo) - m * po[i]) * im;
    float vn = (((s2 * (dh * gxx_u + gzz_v)) + tm * vo) - m * qo[i]) * im;
    if (src) {
      for (int j = 0; j < K; ++j) {
        if (cells_b[j] == cell) {
          un = un + wt * vals_b[j];
          vn = vn + wt * vals_b[j];
        }
      }
    }
    if (DT2) {
      const size_t h = ((size_t)b * htotal + th) * field + cell;
      __stcs(udt2 + h, (un - 2.0f * uo) + po[i]);
      __stcs(vdt2 + h, (vn - 2.0f * vo) + qo[i]);
    }
    up[o] = un;
    vp[o] = vn;
  }
}

// Reverse step th (a history slot of htotal; t the residual row of
// rtotal) over one tile of one shot, fused: the gradient term, then f = a
// = eh du + dh dv and g = b = dh du + dv, and the update of du over dun and
// dv over dvn at the tile's cells (read there only; the caller swaps the
// pointers), the residual rows added on z0, z0 + 1.
template <int R>
__global__ void __launch_bounds__(kThreads)
adjoint_fused(Params q, const float* __restrict__ du, float* __restrict__ dun,
              const float* __restrict__ dv, float* __restrict__ dvn,
              const float* __restrict__ udt2, const float* __restrict__ vdt2,
              float* __restrict__ grad, const float* __restrict__ res,
              int th, int htotal, int t, int rtotal, float s2, int nz,
              int nx, int z0, Coefs c) {
  using T = FusedTile<R>;
  __shared__ float sm[T::kFloats];
  const Smem<R> s(sm);
  const int b = blockIdx.x;                // the shots of a tile adjoin
  const int xt = blockIdx.y * kTX;
  const int zt = blockIdx.z * kTZ;
  const int tid = threadIdx.x;
  const size_t field = (size_t)nz * nx;
  const size_t off = (size_t)b * field;
  const size_t hoff = ((size_t)b * htotal + th) * field;

  // 0. the tile's own operands, kCells a thread, read first: their loads'
  // latency hides under phases 1 and 2
  float gr[kCells], hu[kCells], hv[kCells], dn[kCells], en[kCells];
#pragma unroll
  for (int i = 0; i < kCells; ++i) {
    const int k = tid + i * kThreads;
    const int gx = xt + k % kTX;
    const int gz = zt + k / kTX;
    gr[i] = hu[i] = hv[i] = dn[i] = en[i] = 0.0f;
    if (gx < nx && gz < nz) {
      const size_t cell = (size_t)gz * nx + gx;
      gr[i] = grad[off + cell];
      hu[i] = __ldcs(udt2 + hoff + cell);
      hv[i] = __ldcs(vdt2 + hoff + cell);
      dn[i] = dun[off + cell];
      en[i] = dvn[off + cell];
    }
  }

  ring_pair<R>(s, [&](size_t cell, float& f, float& g) {
    const float e = q.eh[cell];
    const float d = q.dh[cell];
    const float a = du[off + cell];
    const float w = dv[off + cell];
    f = e * a + d * w;
    g = d * a + w;
  }, xt, zt, nz, nx);
  __syncthreads();
  ring_products<R>(s, q, xt, zt, nz, nx, c);
  __syncthreads();

  // 3. the gradient term and the update at the tile's cells
  const float* rs = res + ((size_t)b * rtotal + t) * 2 * nx;
#pragma unroll
  for (int i = 0; i < kCells; ++i) {
    const int k = tid + i * kThreads;
    const int tx = k % kTX;
    const int tz = k / kTX;
    const int gx = xt + tx;
    const int gz = zt + tz;
    if (gx >= nx || gz >= nz) continue;
    const size_t cell = (size_t)gz * nx + gx;
    const size_t o = off + cell;
    const float duo = du[o];
    const float dvo = dv[o];
    grad[o] = (gr[i] + hu[i] * duo) + hv[i] * dvo;
    float h0, gzz_b;
    tile_operators<R>(s, tx, tz, c, &h0, &gzz_b);
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
  const float *wav, *src_val, *starts_in, *res, *udt2_in, *vdt2_in;
  const int* src_cell;
  float *rec, *udt2, *vdt2, *starts, *grad;
  float *u, *up, *v, *vp;          // forward state
  float *du, *dun, *dv, *dvn;      // adjoint state
  int K, B, nz, nx, total, seg, nseg, nsteps, z0;
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

// The fused step's grid: (shots, x tiles, z tiles).
dim3 fused_grid(const State& a) {
  return dim3(a.B, (a.nx + kTX - 1) / kTX, (a.nz + kTZ - 1) / kTZ);
}

// One forward step, one fused launch: t indexes the wavelet, the rows and
// the starts; th the history slot of htotal.
template <int R, bool DT2>
int forward_step(State& a, int t, float* rec, float* starts, float* udt2,
                 float* vdt2, int th, int htotal) {
  forward_fused<R, DT2><<<fused_grid(a), kThreads, 0, a.stream>>>(
      a.q, a.u, a.up, a.v, a.vp, a.wav, a.src_cell, a.src_val, a.K, rec,
      udt2, vdt2, starts, t, th, htotal, a.total, a.seg, a.nz, a.nx, a.z0,
      a.c);
  const cudaError_t err = cudaGetLastError();
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
  adjoint_fused<R><<<fused_grid(a), kThreads, 0, a.stream>>>(
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

// What the fused step takes: a radius of 2 .. kMaxR, a positive grid of
// fewer than 2^31 cells a shot whose (shots, x tiles, z tiles) launch grid
// is within CUDA's (2^31 - 1, 65535, 65535) blocks, receiver rows inside it.
bool make_state(State* a, const float* m, const float* two_m_hd,
                const float* inv_mhd, const float* eh, const float* dh,
                const float* st, const float* ct, int B, int nz, int nx,
                int z0, int r, const float* w1, const float* w2, float ihx,
                float ihz, float ihx2, float ihz2, void* stream) {
  if (r < 2 || r > kMaxR || B < 1 || nz < 2 || nx < 1 || z0 < 0 ||
      z0 + 2 > nz || (long long)nz * nx >= (1LL << 31) ||
      (nx + kTX - 1) / kTX > 65535 || (nz + kTZ - 1) / kTZ > 65535)
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

}  // namespace

extern "C" {

// Forward sweep over t = 0 .. total-1 from zero fields. rec is
// (B, total, 2, nx). Exactly one of udt2 (with vdt2, each
// (B, total, nz, nx)) and starts ((B, total/seg, 4, nz, nx), written at
// t = k seg) is not NULL. The source pattern comes as its non-zero cells:
// src_cell (B, K) int32 z * nx + x (-1 pads) and src_val (B, K) their
// values. scratch is 4 (B, nz, nx) fields holding zeros: u, up, v, vp.
// w1 holds the 2(r/2)+1 first-derivative weights, w2 the r+1
// second-derivative ones. Returns the first CUDA error of a launch, or 0.
int tti2d_forward(const float* m, const float* two_m_hd,
                  const float* inv_mhd, const float* eh, const float* dh,
                  const float* st, const float* ct, const float* wav,
                  const int* src_cell, const float* src_val, int K,
                  float* rec, float* udt2, float* vdt2, float* starts,
                  float* scratch, int B, int nz, int nx, int total, int seg,
                  int z0, int r, const float* w1, const float* w2, float ihx,
                  float ihz, float ihx2, float ihz2, void* stream) {
  State a;
  if (!make_state(&a, m, two_m_hd, inv_mhd, eh, dh, st, ct, B, nz, nx, z0,
                  r, w1, w2, ihx, ihz, ihx2, ihz2, stream) || K < 1 ||
      (udt2 == NULL) != (vdt2 == NULL) || (udt2 == NULL) == (starts == NULL)
      || seg < 1 || total < 1 || total % seg != 0)
    return (int)cudaErrorInvalidValue;
  const size_t n = (size_t)B * nz * nx;
  a.wav = wav;
  a.src_cell = src_cell;
  a.src_val = src_val;
  a.K = K;
  a.rec = rec;
  a.udt2 = udt2;
  a.vdt2 = vdt2;
  a.starts = starts;
  a.u = scratch;
  a.up = scratch + n;
  a.v = scratch + 2 * n;
  a.vp = scratch + 3 * n;
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
      nsteps < 1 || nsteps > total)
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
// with the residual rows res (B, nseg*seg, 2, nx). wav and the source
// lists are as in tti2d_forward, wav (nseg*seg + 1,). grad (B, nz, nx) and
// scratch, 8 (B, nz, nx) fields (du, dun, dv, dvn, u, up, v, vp), hold
// zeros on entry. Returns the first CUDA error, or 0.
int tti2d_jacobian_adjoint(const float* m, const float* two_m_hd,
                           const float* inv_mhd, const float* eh,
                           const float* dh, const float* st, const float* ct,
                           const float* wav, const int* src_cell,
                           const float* src_val, int K, const float* starts,
                           const float* res, float* grad, float* hist,
                           float* scratch, int B, int nz, int nx, int seg,
                           int nseg, int nsteps, int z0, int r,
                           const float* w1, const float* w2, float ihx,
                           float ihz, float ihx2, float ihz2, float s2,
                           void* stream) {
  State a;
  if (!make_state(&a, m, two_m_hd, inv_mhd, eh, dh, st, ct, B, nz, nx, z0,
                  r, w1, w2, ihx, ihz, ihx2, ihz2, stream) || K < 1 ||
      seg < 1 || nseg < 1 || nsteps < 1 || nsteps > seg * nseg)
    return (int)cudaErrorInvalidValue;
  const size_t n = (size_t)B * nz * nx;
  a.wav = wav;
  a.src_cell = src_cell;
  a.src_val = src_val;
  a.K = K;
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
