// The whole-nt 2-D acoustic OT2 forward of the legacy Pallas kernel, for
// Hopper (sm_90a), plain C interface for ctypes. One entry point, one sweep
// over the nt - 2 steps of a shot batch, one kernel launch per step on the
// caller's stream:
//
//   acoustic2d_legacy_forward
//       replaces forward_rows (devito_fwi_tpu/ops/pallas_legacy.py:107,
//       _kernel :25): at every step t = 0 .. nt-3 it records rows z0 and
//       z0 + 1 of u (time t + 1 of the modeling) and steps u forward with a
//       dense source pattern; rows nt-2 and nt-1 of the record are zeros
//       (the Pallas kernel leaves them unwritten).
//
// Layout: fields are (B, nz, nx) float32 with x contiguous (the transposed
// layout of the port's other 2-D kernels, where the Pallas kernel keeps
// (nx, nz)), so the two receiver rows are contiguous; m, two_m_hd = 2m + hd
// and denom = 1/(m + hd) are (nz, nx) and shared by all shots; the wavelet
// is (nt - 2,), one for all shots; inj is the per-shot dense pattern
// (B, nz, nx); the record is (B, nt, 2, nx).
//
// What bounds it on the card: it moves almost nothing (the record, 120 MB
// for 29 SMARMN shots, and the operands once), so it is bound by its 8r + 8
// float operations per cell and step (33 for the stencil at r = 4, 7 for
// the update and the injection): 1.66 ms for the 29-shot SMARMN forward at
// 67 TFLOP/s. The state of all shots (u, u_prev, inj: 3 fields of 283 KB
// for each of 29 shots, ~25 MB) fits the 50 MB L2.
//
// What the design does about it: one thread per cell and one launch per
// step for the whole batch (blockIdx.z is the shot), as csrc/acoustic2d.cu
// does; the update overwrites u_prev in place (each cell reads its own
// u_prev before writing it, no other thread reads it), so two buffers a
// shot suffice. The neighbours come through the caches. The Pallas kernel's
// point, the whole time loop inside one program with the fields resident
// on chip, becomes on Hopper a persistent cooperative kernel with one
// grid-wide sync a step; that is later work, and this simple design sits
// on the per-launch floor (times in PERF.md).
//
// Numerics: the legacy kernel's own association, not the segment kernels':
// the constants fold dt^2 in and are rounded once to float32 on the host
// (c0 = w0 (dt^2/hx^2 + dt^2/hz^2), cx[k] = wk dt^2/hx^2, cz[k] =
// wk dt^2/hz^2); the stencil adds c0 u first and then, for k = 1..r, four
// separate products in the order x+k, x-k, z+k, z-k (the shift pair is not
// summed before the multiply); un = ((lap + two_m_hd u) - m up) * denom,
// then u = un + wav[t] inj. Neighbours beyond the padded grid are zero and
// still enter the sum (c * 0), as the Pallas kernel's zero-filled shifts
// do. The library is compiled with -fmad=false, so no multiply-add is
// contracted and the kernel rounds exactly like its plain torch twin in
// ops/cuda_legacy.py.
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kMaxR = 8;
constexpr int kBX = 32;
constexpr int kBY = 8;

struct Coeffs {
  float c0;
  float cx[kMaxR + 1];
  float cz[kMaxR + 1];
};

// One step t for all shots: rows z0, z0+1 of u into the record, then
// up <- u_next (in place). At t == 0 the record's rows nt-2 and nt-1 are
// zeroed too.
template <int R>
__global__ void legacy_step(const float* __restrict__ u,
                            float* __restrict__ up,
                            const float* __restrict__ m,
                            const float* __restrict__ two_m_hd,
                            const float* __restrict__ denom,
                            const float* __restrict__ wav,
                            const float* __restrict__ inj,
                            float* __restrict__ rec, int t, int nt, int nz,
                            int nx, int z0, Coeffs c) {
  const int x = blockIdx.x * kBX + threadIdx.x;
  const int z = blockIdx.y * kBY + threadIdx.y;
  const int b = blockIdx.z;
  if (x >= nx || z >= nz) return;
  const size_t field = (size_t)nz * nx;
  const size_t row = (size_t)z * nx;
  const size_t cell = row + x;
  const float* ub = u + (size_t)b * field;
  const size_t o = (size_t)b * field + cell;

  const float uc = ub[cell];
  if (z == z0 || z == z0 + 1) {
    const int plane = z - z0;
    rec[(((size_t)b * nt + t) * 2 + plane) * nx + x] = uc;
    if (t == 0) {
      rec[(((size_t)b * nt + nt - 2) * 2 + plane) * nx + x] = 0.0f;
      rec[(((size_t)b * nt + nt - 1) * 2 + plane) * nx + x] = 0.0f;
    }
  }
  float acc = c.c0 * uc;
#pragma unroll
  for (int k = 1; k <= R; ++k) {
    const float xp = (x + k < nx) ? ub[row + x + k] : 0.0f;
    const float xm = (x - k >= 0) ? ub[row + x - k] : 0.0f;
    const float zp = (z + k < nz) ? ub[cell + (size_t)k * nx] : 0.0f;
    const float zm = (z - k >= 0) ? ub[cell - (size_t)k * nx] : 0.0f;
    acc = acc + c.cx[k] * xp;
    acc = acc + c.cx[k] * xm;
    acc = acc + c.cz[k] * zp;
    acc = acc + c.cz[k] * zm;
  }
  const float un =
      ((acc + two_m_hd[cell] * uc) - m[cell] * up[o]) * denom[cell];
  up[o] = un + wav[t] * inj[o];
}

struct Args {
  const float *m, *two_m_hd, *denom, *wav, *inj;
  float *rec, *u, *up;
  int B, nz, nx, nt, z0;
  Coeffs c;
  cudaStream_t stream;
};

template <int R>
int run(const Args& a) {
  const dim3 block(kBX, kBY);
  const dim3 grid((a.nx + kBX - 1) / kBX, (a.nz + kBY - 1) / kBY, a.B);
  float* u = a.u;
  float* up = a.up;
  for (int t = 0; t < a.nt - 2; ++t) {
    legacy_step<R><<<grid, block, 0, a.stream>>>(
        u, up, a.m, a.two_m_hd, a.denom, a.wav, a.inj, a.rec, t, a.nt, a.nz,
        a.nx, a.z0, a.c);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    float* tmp = u;
    u = up;
    up = tmp;
  }
  return 0;
}

}  // namespace

extern "C" {

// Forward sweep over t = 0 .. nt-3. u and up are (B, nz, nx) scratch fields
// holding zeros on entry; cx and cz hold r + 1 host floats (entry 0 unused).
// Returns the first CUDA error of a launch, or 0.
int acoustic2d_legacy_forward(const float* m, const float* two_m_hd,
                              const float* denom, const float* wav,
                              const float* inj, float* rec, float* u,
                              float* up, int B, int nz, int nx, int nt,
                              int z0, int r, const float* cx, const float* cz,
                              float c0, void* stream) {
  if (r < 1 || r > kMaxR || nt < 3 || B < 1 || B > 65535 || z0 < 0 ||
      z0 + 2 > nz)
    return (int)cudaErrorInvalidValue;
  Args a = {m, two_m_hd, denom, wav, inj, rec, u, up, B, nz, nx, nt, z0,
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

const char* acoustic2d_legacy_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
