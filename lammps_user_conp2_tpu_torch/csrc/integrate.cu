// K10: one half step of the velocity-Verlet / Nose-Hoover chain integrator
// (models/integrate.py: Integrator.thermostat_half, kick, drift) in one pass
// over the rows:
//
//   first half   NHC half (each thermostat in turn) -> kick -> drift
//   second half  kick -> NHC half            (no SHAKE)
//                kick | RATTLE (K8) | NHC half   (SHAKE: two launches)
//
// Replaces no TPU kernel: the JAX package leaves the integrator to XLA,
// which fuses it.  On the card the plain version is ~75 tiny PyTorch kernels
// per NHC half (the group's 2 KE, the chain's scalar updates as 0-d tensor
// ops, the scaling) and ~155 graph nodes per step, each costing its launch
// and the gap after it.  What bounds the work: reading v, f, x, the masses
// and row flags once and writing v and x once, ~0.25 MB at the 3,776-atom
// deck: under 0.1 us at 3.35 TB/s.  What bounds the kernel: the launch, the
// block reduction and the serial chain of tchain links in float64 (a few
// dependent exp() calls), a few microseconds in all.
//
// Design:
// - One CTA of IH_ONE_TB threads at the decks' sizes: each thread sums its
//   rows (stride IH_ONE_TB) in float64, warps reduce by a fixed butterfly,
//   warp 0 reduces the warps' sums in the same way; one thread runs every
//   thermostat's chain in float64 and rounds xi / vxi to float32; each
//   thermostat's velocity scale goes through shared memory; the same
//   threads then scale, kick and drift their rows.
// - Above the row count the wrapper sets (ops/kernels/integrate_kernel.py
//   ONE_CTA_MAX_ROWS), two launches: integrate_sums_kernel writes each
//   CTA's sums to its own slots; integrate_apply_kernel has every CTA
//   re-sum the slots in one fixed order, run the same chains (so all agree
//   bit for bit), and scale, kick and drift its own rows; CTA 0 writes xi
//   and vxi.  With no thermostat half in the call, integrate_apply_kernel
//   alone.
// - Thermostats in sequence, as the plain version applies them: a row's
//   thermostat bits P select its sum, and thermostat t reads the 2 KE of
//   its rows after the scales of the thermostats before it,
//   sum over P with bit t of S[P] * prod(scale_s^2, s < t, bit s in P), so
//   one pass over the rows serves every thermostat, overlapping groups
//   included.  At most IH_MAX_T thermostats (2^T - 1 sums).
// - No atomics, every row written once, every sum in a fixed order: two
//   launches on the same input give the same bits, and the graphed step
//   the eager step's.
// - The kick (v + dtfm f, dtfm = (dt/2) ftm2v / m formed once at setup as
//   Integrator.kick forms it), the drift (x + dt v, dt rounded to float32
//   as PyTorch rounds a Python scalar) and the scaling (v * scale, the
//   scale rounded to float32) are formed with round-to-nearest intrinsics
//   and no FMA contraction: op for op the plain version's float32
//   arithmetic.  Only the chain's scalars differ from the plain float32
//   version, being formed in float64 (within float32 rounding of the plain
//   version run in float64).
#include <cstdint>

#include "common.cuh"

namespace conp2 {

constexpr int IH_MAX_T = 4;          // thermostats per call
constexpr int IH_MAX_CHAIN = 16;     // links per chain
constexpr int IH_ONE_TB = 1024;      // threads of the one-CTA form
constexpr int IH_GRID_TB = 256;      // threads per CTA of the split form
constexpr int IH_MOBILE = 1 << 30;   // row flag: an integrated (mobile) row

struct IhArgs {
  const float* v;        // (N, 3)
  const float* f;        // (N, 3)
  const float* x;        // (N, 3)
  const float* dtfm;     // (N,) (dt/2) ftm2v / m
  const float* mass;     // (N,)
  const int* bits;       // (N,) bit t: thermostat t's group; IH_MOBILE
  const double* par;     // (T, 4): dof, kT, Q_1 = dof kT damp^2, Q_k
  const float* xi;       // (T, M)
  const float* vxi;      // (T, M)
  float* v_out;
  float* x_out;          // written only with drift
  float* xi_out;         // written only with T > 0
  float* vxi_out;
  double* part;          // (G, 2^T - 1): the split form's per-CTA sums
  int n, nt, m;
  int kick_first, kick_last, drift;
  float dt;
  double dt2, dt4, dt8, mvv2e;
};

__device__ __forceinline__ float3 ih_kick(float3 v, float d, const float* f,
                                          int i) {
  v.x = __fadd_rn(v.x, __fmul_rn(d, f[3 * i]));
  v.y = __fadd_rn(v.y, __fmul_rn(d, f[3 * i + 1]));
  v.z = __fadd_rn(v.z, __fmul_rn(d, f[3 * i + 2]));
  return v;
}

// row i's velocity where the thermostats read it: kicked first if asked
__device__ __forceinline__ float3 ih_v_in(const IhArgs& a, int i, int b) {
  float3 v = make_float3(a.v[3 * i], a.v[3 * i + 1], a.v[3 * i + 2]);
  if (a.kick_first && (b & IH_MOBILE)) v = ih_kick(v, a.dtfm[i], a.f, i);
  return v;
}

// add row i's m v^2 (float64) to the sum of its thermostat bits
template <int T, int NP>
__device__ __forceinline__ void ih_accumulate(const IhArgs& a, int i,
                                              double (&acc)[NP]) {
  const int b = a.bits[i];
  const int p = b & ((1 << T) - 1);
  if (p == 0) return;
  const float3 v = ih_v_in(a, i, b);
  const double vx = v.x, vy = v.y, vz = v.z;
  const double e = static_cast<double>(a.mass[i]) * (vx * vx + vy * vy +
                                                     vz * vz);
#pragma unroll
  for (int k = 0; k < NP; ++k) acc[k] += (p == k + 1) ? e : 0.0;
}

__device__ __forceinline__ double ih_warp_sum(double s) {
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// the CTA's NP sums into out[], in a fixed order (lane butterflies, then
// warp 0 over the warps' sums); every thread returns after out is written
template <int NP, int TB>
__device__ void ih_block_sum(const double (&acc)[NP], double* warp_buf,
                             double* out) {
  constexpr int NW = TB / 32;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    const double s = ih_warp_sum(acc[k]);
    if (lane == 0) warp_buf[k * NW + w] = s;
  }
  __syncthreads();
  if (w == 0) {
    for (int k = 0; k < NP; ++k) {
      const double s = ih_warp_sum(lane < NW ? warp_buf[k * NW + lane] : 0.0);
      if (lane == 0) out[k] = s;
    }
  }
  __syncthreads();
}

// every thermostat's chain in turn (nhc_half_step, Martyna-Tuckerman-Klein,
// one loop), in float64, from S[P - 1], the unscaled 2 KE / mvv2e of the
// rows with thermostat bits P.  One thread.  Writes each thermostat's
// velocity scale as float32 to scale_f, and xi, vxi if ``write``.
template <int T>
__device__ void ih_chains(const IhArgs& a, const double* S, float* scale_f,
                          bool write) {
  double sc[T > 0 ? T : 1];
  const int m = a.m;
  for (int t = 0; t < T; ++t) {
    double ke2 = 0.0;
    for (int p = 1; p < (1 << T); ++p) {
      if (!(p >> t & 1)) continue;
      double w = S[p - 1];
      for (int s = 0; s < t; ++s) {
        if (p >> s & 1) w *= sc[s] * sc[s];
      }
      ke2 += w;
    }
    ke2 *= a.mvv2e;
    const double dof = a.par[4 * t], kt = a.par[4 * t + 1];
    const double q0 = a.par[4 * t + 2], qk = a.par[4 * t + 3];
    double vx[IH_MAX_CHAIN], g[IH_MAX_CHAIN];
    for (int k = 0; k < m; ++k) vx[k] = a.vxi[t * m + k];
    // inward: every force from the chain as it came in
    g[0] = (ke2 - dof * kt) / q0;
    for (int k = 1; k < m; ++k) {
      g[k] = ((k == 1 ? q0 : qk) * (vx[k - 1] * vx[k - 1]) - kt) / qk;
    }
    vx[m - 1] += g[m - 1] * a.dt4;
    for (int k = m - 2; k >= 0; --k) {
      const double ef = exp(-a.dt8 * vx[k + 1]);
      vx[k] = (vx[k] * ef + g[k] * a.dt4) * ef;
    }
    const double scale = exp(-a.dt2 * vx[0]);
    ke2 = ke2 * scale * scale;
    if (write) {
      for (int k = 0; k < m; ++k) {
        a.xi_out[t * m + k] =
            static_cast<float>(a.xi[t * m + k] + a.dt2 * vx[k]);
      }
    }
    // outward
    g[0] = (ke2 - dof * kt) / q0;
    for (int k = 0; k < m - 1; ++k) {
      const double ef = exp(-a.dt8 * vx[k + 1]);
      vx[k] = (vx[k] * ef + g[k] * a.dt4) * ef;
      g[k + 1] = ((k == 0 ? q0 : qk) * (vx[k] * vx[k]) - kt) / qk;
    }
    vx[m - 1] += g[m - 1] * a.dt4;
    if (write) {
      for (int k = 0; k < m; ++k) {
        a.vxi_out[t * m + k] = static_cast<float>(vx[k]);
      }
    }
    sc[t] = scale;
    scale_f[t] = static_cast<float>(scale);
  }
}

// row i scaled by its thermostats, kicked and drifted as asked; written once
template <int T>
__device__ __forceinline__ void ih_apply(const IhArgs& a, int i,
                                         const float* scale_f) {
  const int b = a.bits[i];
  float3 v = ih_v_in(a, i, b);
#pragma unroll
  for (int t = 0; t < T; ++t) {
    if (b >> t & 1) {
      v.x = __fmul_rn(v.x, scale_f[t]);
      v.y = __fmul_rn(v.y, scale_f[t]);
      v.z = __fmul_rn(v.z, scale_f[t]);
    }
  }
  const bool mobile = b & IH_MOBILE;
  if (a.kick_last && mobile) v = ih_kick(v, a.dtfm[i], a.f, i);
  a.v_out[3 * i] = v.x;
  a.v_out[3 * i + 1] = v.y;
  a.v_out[3 * i + 2] = v.z;
  if (a.drift) {
    float x0 = a.x[3 * i], x1 = a.x[3 * i + 1], x2 = a.x[3 * i + 2];
    if (mobile) {
      x0 = __fadd_rn(x0, __fmul_rn(a.dt, v.x));
      x1 = __fadd_rn(x1, __fmul_rn(a.dt, v.y));
      x2 = __fadd_rn(x2, __fmul_rn(a.dt, v.z));
    }
    a.x_out[3 * i] = x0;
    a.x_out[3 * i + 1] = x1;
    a.x_out[3 * i + 2] = x2;
  }
}

template <int T>
__host__ __device__ constexpr int ih_np() {
  return T > 0 ? (1 << T) - 1 : 1;
}

// the one-CTA form: sums, chains and rows in one launch (T >= 1)
template <int T>
__global__ void __launch_bounds__(IH_ONE_TB) integrate_half_kernel(IhArgs a) {
  constexpr int NP = ih_np<T>();
  __shared__ double warp_buf[NP * (IH_ONE_TB / 32)];
  __shared__ double sums[NP];
  __shared__ float scale_f[IH_MAX_T];
  double acc[NP];
#pragma unroll
  for (int k = 0; k < NP; ++k) acc[k] = 0.0;
  for (int i = threadIdx.x; i < a.n; i += IH_ONE_TB) {
    ih_accumulate<T, NP>(a, i, acc);
  }
  ih_block_sum<NP, IH_ONE_TB>(acc, warp_buf, sums);
  if (threadIdx.x == 0) ih_chains<T>(a, sums, scale_f, true);
  __syncthreads();
  for (int i = threadIdx.x; i < a.n; i += IH_ONE_TB) {
    ih_apply<T>(a, i, scale_f);
  }
}

// the split form's first launch: CTA c's sums over rows [c rows, (c+1) rows)
template <int T>
__global__ void __launch_bounds__(IH_GRID_TB)
    integrate_sums_kernel(IhArgs a, int rows) {
  constexpr int NP = ih_np<T>();
  __shared__ double warp_buf[NP * (IH_GRID_TB / 32)];
  __shared__ double sums[NP];
  double acc[NP];
#pragma unroll
  for (int k = 0; k < NP; ++k) acc[k] = 0.0;
  const int i0 = blockIdx.x * rows;
  const int i1 = min(a.n, i0 + rows);
  for (int i = i0 + threadIdx.x; i < i1; i += IH_GRID_TB) {
    ih_accumulate<T, NP>(a, i, acc);
  }
  ih_block_sum<NP, IH_GRID_TB>(acc, warp_buf, sums);
  if (threadIdx.x < NP) {
    a.part[blockIdx.x * NP + threadIdx.x] = sums[threadIdx.x];
  }
}

// the split form's second launch (or the only one, T = 0): every CTA sums
// the g CTAs' slots in one fixed order and runs the chains; then its rows
template <int T>
__global__ void __launch_bounds__(IH_GRID_TB)
    integrate_apply_kernel(IhArgs a, int rows, int g) {
  constexpr int NP = ih_np<T>();
  __shared__ double sums[NP];
  __shared__ float scale_f[IH_MAX_T];
  if constexpr (T > 0) {
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    for (int k = w; k < NP; k += IH_GRID_TB / 32) {
      double s = 0.0;
      for (int c = lane; c < g; c += 32) s += a.part[c * NP + k];
      s = ih_warp_sum(s);
      if (lane == 0) sums[k] = s;
    }
    __syncthreads();
    if (threadIdx.x == 0) ih_chains<T>(a, sums, scale_f, blockIdx.x == 0);
    __syncthreads();
  }
  const int i0 = blockIdx.x * rows;
  const int i1 = min(a.n, i0 + rows);
  for (int i = i0 + threadIdx.x; i < i1; i += IH_GRID_TB) {
    ih_apply<T>(a, i, scale_f);
  }
}

template <int T>
int ih_launch(const IhArgs& a, int split, int rows, cudaStream_t st) {
  if constexpr (T > 0) {
    if (!split) {
      integrate_half_kernel<T><<<1, IH_ONE_TB, 0, st>>>(a);
      return static_cast<int>(cudaGetLastError());
    }
  }
  const int g = (a.n + rows - 1) / rows;
  if constexpr (T > 0) {
    integrate_sums_kernel<T><<<g, IH_GRID_TB, 0, st>>>(a, rows);
    const int err = static_cast<int>(cudaGetLastError());
    if (err) return err;
  }
  integrate_apply_kernel<T><<<g, IH_GRID_TB, 0, st>>>(a, rows, g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace conp2

extern "C" {

// One half step over n rows (see the top of the file).  nt thermostats
// (0 to IH_MAX_T; 0: no NHC half in this call) with chains of m links;
// kick_first / kick_last: the kick before / after the thermostats; drift:
// x_out = x + dt v after them.  split: 0 the one-CTA form (nt >= 1), 1 the
// two-launch form over CTAs of ``rows`` rows, whose per-CTA sums go to
// part ((n + rows - 1) / rows x (2^nt - 1) doubles).  Returns
// cudaGetLastError() (cudaErrorInvalidValue for arguments out of range).
int conp2_integrate_half_f32(
    const float* v, const float* f, const float* x, const float* dtfm,
    const float* mass, const int* bits, const double* par, const float* xi,
    const float* vxi, int n, int nt, int m, int kick_first, int kick_last,
    int drift, float dt, double dt2, double dt4, double dt8, double mvv2e,
    int split, int rows, double* part, float* v_out, float* x_out,
    float* xi_out, float* vxi_out, void* stream) {
  if (n <= 0) return 0;
  if (nt < 0 || nt > conp2::IH_MAX_T || m < 1 || m > conp2::IH_MAX_CHAIN ||
      rows <= 0 || rows % conp2::IH_GRID_TB) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const conp2::IhArgs a{v,      f,          x,         dtfm,      mass,
                        bits,   par,        xi,        vxi,       v_out,
                        x_out,  xi_out,     vxi_out,   part,      n,
                        nt,     m,          kick_first, kick_last, drift,
                        dt,     dt2,        dt4,       dt8,       mvv2e};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (nt) {
    case 0: return conp2::ih_launch<0>(a, 1, rows, st);
    case 1: return conp2::ih_launch<1>(a, split, rows, st);
    case 2: return conp2::ih_launch<2>(a, split, rows, st);
    case 3: return conp2::ih_launch<3>(a, split, rows, st);
    default: return conp2::ih_launch<4>(a, split, rows, st);
  }
}

}  // extern "C"
