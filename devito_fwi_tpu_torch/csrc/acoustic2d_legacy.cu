// The whole-nt 2-D acoustic OT2 forward of the legacy Pallas kernel, for
// Hopper (sm_90a), plain C interface for ctypes. One entry point, one
// launch a sweep over the nt - 2 steps of a shot batch, on the caller's
// stream:
//
//   acoustic2d_legacy_forward
//       replaces forward_rows (devito_fwi_tpu/ops/pallas_legacy.py:107,
//       _kernel :25): at every step t = 0 .. nt-3 it records rows z0 and
//       z0 + 1 of u (time t + 1 of the modeling) and steps u forward with
//       the shot's source; rows nt-2 and nt-1 of the record are zeros (the
//       Pallas kernel leaves them unwritten).
//
// Layout: the coefficients m, two_m_hd = 2m + hd and denom = 1/(m + hd)
// are (nz, nx4) with x contiguous and nx4 = nx rounded up to 4, zero in
// the padding lanes, shared by all shots; the wavelet is (nt - 2,), one for
// all shots; the source is a list of each shot's non-zero pattern cells
// (B, K) as z * nx + x (-1 where a shot has fewer) with their values; the
// record is (B, nt, 2, nx).
//
// What bounds it on the card: it moves almost nothing (the record, 120 MB
// for 29 SMARMN shots, and the operands once), so it is bound by its 8r + 8
// float operations per cell and step (33 for the stencil at r = 4, 7 for
// the update and the injection): 1.66 ms for the 29-shot SMARMN forward at
// 67 TFLOP/s, about twice that as separate (non-FMA) instructions.
//
// What the design does about it: the Pallas kernel's point, the whole time
// loop inside one program with the fields resident on chip, becomes one
// thread-block cluster a shot. The cluster's blocks split the (nz, nx)
// field along z into slabs of `rows` rows (the last may be shorter); each
// block keeps two u buffers of its slab in shared memory, u(t) and u(t-1),
// each with r halo rows above and below and zero columns left and right,
// and overwrites the owner's u(t-1) cell with u(t+1) (no other thread reads
// it). A step: wait at the cluster barrier; record rows z0, z0+1 (their
// owner); copy the r halo rows from the blocks that own them, out of their
// current buffer, through distributed shared memory; sync the block;
// update every owned cell into the other buffer; sync; arrive. Remote
// reads go only to the buffer that no block writes until every block has
// arrived again, so one cluster barrier a step is enough. Rows beyond the
// grid stay zero and still enter the sum (c * 0), as the Pallas kernel's
// zero-filled shifts do. A thread updates four x-adjacent cells
// (float4) down a strip of rows, two rows an iteration (eight
// independent sums), its z taps from a register queue of 2r + 2 rows, so
// a cell costs about three shared loads, not 4r + 2. The
// three coefficient fields, shared by all shots, are read through L2 each
// step (214 KB a block, 25 MB a step at SMARMN's 29 shots): with two u
// buffers (171 KB) they do not fit a block's shared memory at a cluster of
// 4, and clusters of 8, which hold them, run the shots in two waves (the
// probe's times in PERF.md). The source is added by the thread that
// updates its cell.
//
// Numerics: the legacy kernel's own association, not the segment kernels':
// the constants fold dt^2 in and are rounded once to float32 on the host
// (c0 = w0 (dt^2/hx^2 + dt^2/hz^2), cx[k] = wk dt^2/hx^2, cz[k] =
// wk dt^2/hz^2); the stencil adds c0 u first and then, for k = 1..r, four
// separate products in the order x+k, x-k, z+k, z-k (the shift pair is not
// summed before the multiply); un = ((lap + two_m_hd u) - m up) * denom,
// then u = un + wav[t] inj at the listed cells (elsewhere the dense
// pattern's zero would change no value, only the sign of a zero). The
// library is compiled with -fmad=false, so no multiply-add is contracted
// and the kernel rounds exactly like its plain torch twin in
// ops/cuda_legacy.py.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxR = 8;
constexpr int kMaxCluster = 8;
constexpr int kThreads = 512;

struct Coeffs {
  float c0;
  float cx[kMaxR + 1];
  float cz[kMaxR + 1];
};

struct Shape {
  int nz, nx, nx4, rows, stride, nt, z0, K;
};

// The slab's sources: cell (z, x) and value, nsrc of them.
struct Sources {
  const int* z;
  const int* x;
  const float* v;
  int n;
};

__device__ __forceinline__ float lane(const float4& v, int l) {
  return l == 0 ? v.x : l == 1 ? v.y : l == 2 ? v.z : v.w;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// One row z (buffer row lr) of four x-adjacent cells x0 .. x0+3: the z taps
// q[C - R .. C + R] (row lr at q[C]), the x taps from `col` (the column
// x0 of `cur`), u(t-1) in `out` overwritten with u(t+1), the source added
// at its cells when `hit`.
template <int R, int C, int N>
__device__ __forceinline__ void update_row(
    const float4 (&q)[N], const float* __restrict__ col,
    float* __restrict__ out, int z, int lr, int x0,
    const float* __restrict__ m, const float* __restrict__ two_m_hd,
    const float* __restrict__ denom, const Shape& s, const Coeffs& c,
    float wt, bool hit, const Sources& src) {
  constexpr int P = (R + 3) / 4 * 4;
  const int S = s.stride;
  // row lr at x0 - P .. x0 + 3 + P
  float w[4 + 2 * P];
#pragma unroll
  for (int i = 0; i < P / 4; ++i) {
    const float4 l4 = ld4(col + lr * S - P + 4 * i);
    const float4 r4 = ld4(col + lr * S + 4 + 4 * i);
    w[4 * i] = l4.x;
    w[4 * i + 1] = l4.y;
    w[4 * i + 2] = l4.z;
    w[4 * i + 3] = l4.w;
    w[P + 4 + 4 * i] = r4.x;
    w[P + 5 + 4 * i] = r4.y;
    w[P + 6 + 4 * i] = r4.z;
    w[P + 7 + 4 * i] = r4.w;
  }
  w[P] = q[C].x;
  w[P + 1] = q[C].y;
  w[P + 2] = q[C].z;
  w[P + 3] = q[C].w;
  const size_t g = (size_t)z * s.nx4 + x0;
  const float4 mm = ldg4(m + g);
  const float4 tm = ldg4(two_m_hd + g);
  const float4 dn = ldg4(denom + g);
  const float4 up = ld4(out + lr * S);
  float un[4];
#pragma unroll
  for (int l = 0; l < 4; ++l) {
    const float uc = w[P + l];
    float acc = c.c0 * uc;
#pragma unroll
    for (int k = 1; k <= R; ++k) {
      acc = acc + c.cx[k] * w[P + l + k];
      acc = acc + c.cx[k] * w[P + l - k];
      acc = acc + c.cz[k] * lane(q[C + k], l);
      acc = acc + c.cz[k] * lane(q[C - k], l);
    }
    un[l] = ((acc + lane(tm, l) * uc) - lane(mm, l) * lane(up, l)) *
            lane(dn, l);
  }
  if (hit) {
    for (int e = 0; e < src.n; ++e) {
      if (src.z[e] != z) continue;
#pragma unroll
      for (int l = 0; l < 4; ++l)
        if (src.x[e] == x0 + l) un[l] = un[l] + wt * src.v[e];
    }
  }
  // lanes past nx stay zero
  *reinterpret_cast<float4*>(out + lr * S) =
      make_float4(x0 < s.nx ? un[0] : 0.0f, x0 + 1 < s.nx ? un[1] : 0.0f,
                  x0 + 2 < s.nx ? un[2] : 0.0f, x0 + 3 < s.nx ? un[3] : 0.0f);
}

// Update the slab's rows [z_lo, z_hi): read u(t) from `cur` (buffer row
// z - z_lo + R, column P + x), overwrite u(t-1) in `nxt` with u(t+1).
// Threads take (strip, 4-column chunk) items, as many strips side by side
// as the threads allow, each strip marched down its rows two at a time
// with the z taps in a register queue.
template <int R>
__device__ __forceinline__ void march(
    int z_lo, int z_hi, const float* __restrict__ cur,
    float* __restrict__ nxt, const float* __restrict__ m,
    const float* __restrict__ two_m_hd, const float* __restrict__ denom,
    const Shape& s, const Coeffs& c, float wt, const Sources& src) {
  constexpr int P = (R + 3) / 4 * 4;
  const int nrows = z_hi - z_lo;
  const int nxc = s.nx4 >> 2;
  const int side = min(nrows, max(1, kThreads / nxc));
  const int hs = (nrows + side - 1) / side;
  const int items = ((nrows + hs - 1) / hs) * nxc;
  const int S = s.stride;
  for (int it = threadIdx.x; it < items; it += kThreads) {
    const int strip = it / nxc;
    const int j = it - strip * nxc;
    const int a = z_lo + strip * hs;
    const int b = min(a + hs, z_hi);
    const int x0 = 4 * j;
    bool hit = false;
    for (int e = 0; e < src.n; ++e)
      hit |= (src.x[e] >> 2) == j && src.z[e] >= a && src.z[e] < b;
    const float* col = cur + P + x0;
    float* out = nxt + P + x0;
    int lr = a - z_lo + R;
    // q[k] holds buffer row lr - R + k, k = 0 .. 2R + 1: two rows an
    // iteration, eight independent sums a thread
    float4 q[2 * R + 2];
#pragma unroll
    for (int k = 0; k < 2 * R; ++k) q[k + 2] = ld4(col + (lr - R + k) * S);
    for (int z = a; z < b; z += 2, lr += 2) {
#pragma unroll
      for (int k = 0; k < 2 * R; ++k) q[k] = q[k + 2];
      const bool two = z + 1 < b;
      q[2 * R] = ld4(col + (lr + R) * S);
      q[2 * R + 1] = two ? ld4(col + (lr + R + 1) * S)
                         : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      update_row<R, R>(q, col, out, z, lr, x0, m, two_m_hd, denom, s, c, wt,
                       hit, src);
      if (two)
        update_row<R, R + 1>(q, col, out, z + 1, lr + 1, x0, m, two_m_hd,
                             denom, s, c, wt, hit, src);
    }
  }
}

// One shot a cluster (blockIdx.y), its slab the block's cluster rank.
template <int R>
__global__ void __launch_bounds__(kThreads, 1)
    legacy_sweep(const float* __restrict__ m,
                 const float* __restrict__ two_m_hd,
                 const float* __restrict__ denom,
                 const float* __restrict__ wav,
                 const int* __restrict__ src_cells,
                 const float* __restrict__ src_vals,
                 float* __restrict__ rec, Shape s, Coeffs c) {
  constexpr int P = (R + 3) / 4 * 4;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.y;
  const int z_lo = rank * s.rows;
  const int z_hi = min(s.nz, z_lo + s.rows);
  const int S = s.stride;
  const int buf = (s.rows + 2 * R) * S;
  float* bufs[2] = {smem, smem + buf};
  int* src_z = reinterpret_cast<int*>(smem + 2 * buf);
  int* src_x = src_z + s.K;
  float* src_v = reinterpret_cast<float*>(src_x + s.K);
  __shared__ int nsrc;

  // zero both buffers (halo rows beyond the grid and the padding columns
  // stay zero); this slab's sources
  for (int i = threadIdx.x; i < 2 * buf / 4; i += kThreads)
    smem4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (threadIdx.x == 0) {
    int n = 0;
    for (int e = 0; e < s.K; ++e) {
      const int cell = src_cells[(size_t)b * s.K + e];
      if (cell < 0) continue;
      const int z = cell / s.nx;
      if (z < z_lo || z >= z_hi) continue;
      src_z[n] = z;
      src_x[n] = cell - z * s.nx;
      src_v[n] = src_vals[(size_t)b * s.K + e];
      ++n;
    }
    nsrc = n;
  }
  __syncthreads();
  const Sources src = {src_z, src_x, src_v, nsrc};
  cluster_arrive();

  const int nxc = s.nx4 >> 2;
  for (int t = 0; t < s.nt - 2; ++t) {
    float* cur = bufs[t & 1];
    float* nxt = bufs[(t & 1) ^ 1];
    cluster_wait();
    // the record: rows z0, z0 + 1 of u(t) from their owner
    for (int p = 0; p < 2; ++p) {
      const int zr = s.z0 + p;
      if (zr < z_lo || zr >= z_hi) continue;
      const float* row = cur + (zr - z_lo + R) * S + P;
      float* dst = rec + (((size_t)b * s.nt + t) * 2 + p) * s.nx;
      for (int x = threadIdx.x; x < s.nx; x += kThreads) {
        dst[x] = row[x];
        if (t == 0) {
          rec[(((size_t)b * s.nt + s.nt - 2) * 2 + p) * s.nx + x] = 0.0f;
          rec[(((size_t)b * s.nt + s.nt - 1) * 2 + p) * s.nx + x] = 0.0f;
        }
      }
    }
    // the halo rows, out of their owners' current buffers
    for (int i = threadIdx.x; i < 2 * R * nxc; i += kThreads) {
      const int h = i / nxc;
      const int j = i - h * nxc;
      const int g = h < R ? z_lo - R + h : z_hi + h - R;
      if (g < 0 || g >= s.nz) continue;
      const int owner = g / s.rows;
      const float* remote = cluster.map_shared_rank(
          cur + (g - owner * s.rows + R) * S + P + 4 * j, owner);
      *reinterpret_cast<float4*>(cur + (g - z_lo + R) * S + P + 4 * j) =
          ld4(remote);
    }
    __syncthreads();
    march<R>(z_lo, z_hi, cur, nxt, m, two_m_hd, denom, s, c, wav[t], src);
    __syncthreads();
    cluster_arrive();
  }
  // no block leaves while another may still read its shared memory
  cluster_wait();
}

struct Args {
  const float *m, *two_m_hd, *denom, *wav;
  const int* src_cells;
  const float* src_vals;
  float* rec;
  int B, cluster, smem;
  Shape s;
  Coeffs c;
  cudaStream_t stream;
};

cudaLaunchConfig_t config(int B, int cluster, int smem, cudaStream_t stream,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, B, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Clusters of `cluster` blocks with `smem` bytes each that the card holds
// at once, after the kernel is allowed that much shared memory.
template <int R>
int max_clusters(int cluster, int smem, int* active) {
  cudaError_t err = cudaFuncSetAttribute(
      legacy_sweep<R>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config(1, cluster, smem, 0, attr);
  err = cudaOccupancyMaxActiveClusters(active, (const void*)legacy_sweep<R>,
                                       &cfg);
  return (int)err;
}

template <int R>
int run(const Args& a) {
  int active = 0;
  const int err = max_clusters<R>(a.cluster, a.smem, &active);
  if (err) return err;
  if (active < 1) return (int)cudaErrorInvalidConfiguration;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      config(a.B, a.cluster, a.smem, a.stream, attr);
  const cudaError_t lerr = cudaLaunchKernelEx(
      &cfg, legacy_sweep<R>, a.m, a.two_m_hd, a.denom, a.wav,
      a.src_cells, a.src_vals, a.rec, a.s, a.c);
  if (lerr != cudaSuccess) return (int)lerr;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Forward sweep over t = 0 .. nt-3, one launch: B clusters of `cluster`
// blocks, each block `rows` rows of the (nz, nx) field, `stride` floats a
// row of its buffers, `smem` bytes of shared memory (the launch plan of
// ops/cuda_legacy.py). m, two_m_hd and denom are (nz, nx4); cx and cz
// hold r + 1 host floats (entry 0 unused). Returns the first CUDA error of
// the launch, cudaErrorInvalidConfiguration when no cluster fits the card,
// or 0.
int acoustic2d_legacy_forward(const float* m, const float* two_m_hd,
                              const float* denom, const float* wav,
                              const int* src_cells,
                              const float* src_vals, float* rec, int B,
                              int nz, int nx, int nx4, int nt, int z0, int K,
                              int r, int cluster, int rows, int stride,
                              int threads, int smem, const float* cx,
                              const float* cz, float c0, void* stream) {
  if (r < 1 || r > kMaxR || nt < 3 || B < 1 || B > 65535 || z0 < 0 ||
      z0 + 2 > nz || K < 1 || nx4 < nx || nx4 % 4 != 0 || cluster < 1 ||
      cluster > kMaxCluster || rows < 1 || (cluster - 1) * rows >= nz ||
      cluster * rows < nz || threads != kThreads ||
      stride < nx4 + 2 * ((r + 3) / 4 * 4))
    return (int)cudaErrorInvalidValue;
  Args a = {m, two_m_hd, denom, wav, src_cells, src_vals, rec,
            B, cluster, smem,
            {nz, nx, nx4, rows, stride, nt, z0, K},
            {}, (cudaStream_t)stream};
  a.c.c0 = c0;
  for (int k = 0; k <= r; ++k) {
    a.c.cx[k] = cx[k];
    a.c.cz[k] = cz[k];
  }
  switch (r) {
    case 1: return run<1>(a);
    case 2: return run<2>(a);
    case 3: return run<3>(a);
    case 4: return run<4>(a);
    case 5: return run<5>(a);
    case 6: return run<6>(a);
    case 7: return run<7>(a);
    default: return run<8>(a);
  }
}

// The clusters the card holds at once for this launch (into *active).
int acoustic2d_legacy_max_clusters(int r, int cluster, int smem,
                                   int* active) {
  if (r < 1 || r > kMaxR || cluster < 1 || cluster > kMaxCluster)
    return (int)cudaErrorInvalidValue;
  switch (r) {
    case 1: return max_clusters<1>(cluster, smem, active);
    case 2: return max_clusters<2>(cluster, smem, active);
    case 3: return max_clusters<3>(cluster, smem, active);
    case 4: return max_clusters<4>(cluster, smem, active);
    case 5: return max_clusters<5>(cluster, smem, active);
    case 6: return max_clusters<6>(cluster, smem, active);
    case 7: return max_clusters<7>(cluster, smem, active);
    default: return max_clusters<8>(cluster, smem, active);
  }
}

const char* acoustic2d_legacy_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
