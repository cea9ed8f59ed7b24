// PPPM ad force gather (K3): per slot of the tile binning, the gradient of
// the order-5 B-spline interpolant of the potential, (gx, gy, gz) =
// sum over the 5x5x5 stencil of (w'x wy wz, wx w'y wz, wx wy w'z) u, read
// from the xy-wrap-padded z-binned potential (LAMMPS fieldforce_ad).
//
// Replaces the TPU kernel in lammps_user_conp2_tpu/ops/pallas/pppm_gather.py,
// gather3_tiles_pallas (body _kernel).
//
// What bounds it on this card: 125 potential reads per slot.  The padded
// z-binned potential is ~36 MB at the 100k cell and stays in the 50 MB L2;
// slots of one tile sit in consecutive threads and read overlapping
// stencils, so most reads hit L1/L2.
//
// Design: one thread per slot, reading its stencil straight from the
// z-binned rows at its tile's origin (no im2col patch copies: the TPU
// kernel needed them as MXU operands).  The weights and derivative weights
// are evaluated by Horner in the order of ops/pppm.py _horner_w/_horner_dw;
// the z sums are formed first, then the x/y combination.  Each thread
// writes its own output row: no atomics, deterministic.  Empty slots read
// the tile origin and are never gathered by an atom.
#include <cstdint>

#include "common.cuh"

namespace conp2 {

constexpr int GA_TB = 128;
constexpr int GA_P = 5;

__global__ void __launch_bounds__(GA_TB)
gather3_kernel(const float* __restrict__ up, const float* __restrict__ rows,
               const float* __restrict__ cf, int t_tiles, int cap, int tlx,
               int tly, int nty, int ntz, int ez, int upy,
               float* __restrict__ out) {
  __shared__ float s_cf[GA_P * GA_P];
  if (threadIdx.x < GA_P * GA_P) s_cf[threadIdx.x] = cf[threadIdx.x];
  __syncthreads();
  const int64_t s = static_cast<int64_t>(blockIdx.x) * GA_TB + threadIdx.x;
  if (s >= static_cast<int64_t>(t_tiles) * cap) return;
  const int t = static_cast<int>(s / cap);
  const int c = static_cast<int>(s % cap);
  const int tz = t % ntz;
  const int ty = (t / ntz) % nty;
  const int tx = t / (ntz * nty);
  const float* r = rows + static_cast<int64_t>(t) * 8 * cap + c;
  float w[3][GA_P], dw[3][GA_P];
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    const float d = r[(3 + ax) * cap];
#pragma unroll
    for (int a = 0; a < GA_P; ++a) {
      float v = 0.f;
#pragma unroll
      for (int l = GA_P - 1; l >= 0; --l) v = v * d + s_cf[a * GA_P + l];
      float dv = 0.f;
#pragma unroll
      for (int l = GA_P - 1; l >= 1; --l) {
        dv = dv * d + static_cast<float>(l) * s_cf[a * GA_P + l];
      }
      w[ax][a] = v;
      dw[ax][a] = dv;
    }
  }
  const int x0 = tx * tlx + static_cast<int>(r[0]);
  const int y0 = ty * tly + static_cast<int>(r[cap]);
  const int z0 = static_cast<int>(r[2 * cap]);
  float gx = 0.f, gy = 0.f, gz = 0.f;
#pragma unroll
  for (int a = 0; a < GA_P; ++a) {
#pragma unroll
    for (int b = 0; b < GA_P; ++b) {
      const float* u = up + ((static_cast<int64_t>(x0 + a) * upy + (y0 + b)) *
                                 ntz + tz) * ez + z0;
      float sz = 0.f, sdz = 0.f;
#pragma unroll
      for (int k = 0; k < GA_P; ++k) {
        const float v = __ldg(u + k);
        sz += w[2][k] * v;
        sdz += dw[2][k] * v;
      }
      gx += dw[0][a] * w[1][b] * sz;
      gy += w[0][a] * dw[1][b] * sz;
      gz += w[0][a] * w[1][b] * sdz;
    }
  }
  out[3 * s] = gx;
  out[3 * s + 1] = gy;
  out[3 * s + 2] = gz;
}

}  // namespace conp2

extern "C" {

// out (T*cap, 3) float32 in slot order.  Returns cudaGetLastError().
int conp2_gather3_f32(const float* up, const float* rows, const float* cf,
                      int t_tiles, int cap, int tlx, int tly, int nty,
                      int ntz, int ez, int upy, float* out, void* stream) {
  if (t_tiles <= 0 || cap <= 0 || ez <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t nslots = static_cast<int64_t>(t_tiles) * cap;
  const int nblocks = static_cast<int>((nslots + conp2::GA_TB - 1) /
                                       conp2::GA_TB);
  conp2::gather3_kernel<<<nblocks, conp2::GA_TB, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      up, rows, cf, t_tiles, cap, tlx, tly, nty, ntz, ez, upy, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
