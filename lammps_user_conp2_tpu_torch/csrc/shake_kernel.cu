// SHAKE positions (K7) and RATTLE velocities (K8) over the constraint
// clusters: a fixed number of Gauss-Seidel sweeps over each cluster's
// constraint slots (LAMMPS fix shake semantics, the JAX package's
// models/shake.py XLA path: SH_ITERS sweeps, no relaxation factor, no early
// exit).
//
// Replaces the TPU kernels in lammps_user_conp2_tpu/ops/pallas/shake_kernel.py,
// shake_positions_pallas (body _shake_kernel) and rattle_velocities_pallas
// (body _rattle_kernel).
//
// What bounds them on this card: at the ionic-liquid cell (M = 320 clusters
// of K = 3 atoms and C = 3 constraints) one call moves ~60 KB (positions
// read twice, written once, velocity corrections written, the cluster
// tables) and does ~0.6 MFLOP: a bound of tens of nanoseconds against
// 3.35 TB/s and 67 TFLOP/s.  The real limit is the serial chain of
// SH_ITERS x C dependent slot updates in each thread (each update needs the
// previous one's positions), plus the launch itself.  320 threads fill
// about 3 of the 132 SMs; that is the shape of the work, not a defect.
//
// Design: one thread per cluster, templated on (K, C) so every loop
// unrolls and the cluster (K x 3 coordinates, C reference vectors) stays in
// registers; cluster-local columns are selected by predicated moves, not by
// the TPU kernel's one-hot arithmetic.  One launch does the whole call: the
// thread gathers its atoms' rows, forms the reference vectors, runs every
// sweep and writes its valid rows of the outputs (the wrapper pre-fills
// them for unconstrained atoms).  Each atom is in exactly one cluster: no
// atomics, no shared memory.  Every update is formed op for op as the plain
// PyTorch version forms it, with round-to-nearest intrinsics and no FMA
// contraction, and the minimum image is d - L * rint(d / L) (round half to
// even, as torch.round), so kernel and plain version agree to rounding of
// the reciprocal in the minimum image's division at most.
#include <cstdint>

#include "common.cuh"

namespace conp2 {

constexpr int SH_TB = 128;
constexpr int SH_ITERS = 12;   // the JAX package's fixed sweep count
constexpr float SH_DENOM_MIN = 1e-12f;

struct ShBox {
  float len[3];
  float inv[3];            // 1 / len
  int periodic[3];
};

// (a0 b0 + a1 b1) + a2 b2, rounded op by op
__device__ __forceinline__ float dot3_rn(const float (&a)[3],
                                         const float (&b)[3]) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a[0], b[0]), __fmul_rn(a[1], b[1])),
                   __fmul_rn(a[2], b[2]));
}

// v[col][ax] for a runtime cluster-local column, without local memory
template <int K>
__device__ __forceinline__ float pick(const float (&v)[K][3], int col,
                                      int ax) {
  float r = v[0][ax];
#pragma unroll
  for (int k = 1; k < K; ++k) r = (col == k) ? v[k][ax] : r;
  return r;
}

template <int K>
__device__ __forceinline__ int pick_int(const int (&v)[K], int col) {
  int r = v[0];
#pragma unroll
  for (int k = 1; k < K; ++k) r = (col == k) ? v[k] : r;
  return r;
}

template <int K>
__device__ __forceinline__ float pick1(const float (&v)[K], int col) {
  float r = v[0];
#pragma unroll
  for (int k = 1; k < K; ++k) r = (col == k) ? v[k] : r;
  return r;
}

// cols[i] -= invm_i * corr ; cols[j] += invm_j * corr, as the plain version
template <int K>
__device__ __forceinline__ void apply_corr(float (&c)[K][3], int si, int sj,
                                           float imi, float imj, float mult,
                                           const float (&dir)[3]) {
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    const float corr = __fmul_rn(mult, dir[ax]);
    const float ti = __fmul_rn(imi, corr);
    const float tj = __fmul_rn(imj, corr);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (k == si) c[k][ax] = __fsub_rn(c[k][ax], ti);
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (k == sj) c[k][ax] = __fadd_rn(c[k][ax], tj);
    }
  }
}

template <int K, int C>
__global__ void __launch_bounds__(SH_TB)
shake_kernel(const float* __restrict__ xn, const float* __restrict__ xo,
             const int* __restrict__ atoms, const uint8_t* __restrict__ amask,
             const int* __restrict__ ci, const int* __restrict__ cj,
             const float* __restrict__ invm, const float* __restrict__ dist2,
             const uint8_t* __restrict__ cmask, int m, float dt, ShBox box, float* __restrict__ x,
             float* __restrict__ dv) {
  const int c = blockIdx.x * SH_TB + threadIdx.x;
  if (c >= m) return;
  int at[K];
  float im[K];
  float xc[K][3];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    at[k] = atoms[c * K + k];
    im[k] = invm[c * K + k];
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) xc[k][ax] = xn[3 * at[k] + ax];
  }
  int si[C], sj[C];
  bool cm[C];
  float d2[C], imi[C], imj[C], isum2[C], ro[C][3];
#pragma unroll
  for (int s = 0; s < C; ++s) {
    si[s] = ci[c * C + s];
    sj[s] = cj[c * C + s];
    cm[s] = cmask[c * C + s] != 0;
    d2[s] = dist2[c * C + s];
    imi[s] = pick1<K>(im, si[s]);
    imj[s] = pick1<K>(im, sj[s]);
    isum2[s] = __fmul_rn(2.0f, __fadd_rn(imi[s], imj[s]));
    // reference bond vectors from the pre-drift positions
    const int ai = pick_int<K>(at, si[s]);
    const int aj = pick_int<K>(at, sj[s]);
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      ro[s][ax] = min_image_rn(__fsub_rn(xo[3 * ai + ax], xo[3 * aj + ax]),
                               box.len[ax], box.inv[ax], box.periodic[ax]);
    }
  }
  for (int it = 0; it < SH_ITERS; ++it) {
#pragma unroll
    for (int s = 0; s < C; ++s) {
      float rn[3];
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) {
        rn[ax] = min_image_rn(__fsub_rn(pick<K>(xc, si[s], ax),
                                        pick<K>(xc, sj[s], ax)),
                              box.len[ax], box.inv[ax], box.periodic[ax]);
      }
      const float diff = __fsub_rn(dot3_rn(rn, rn), d2[s]);
      const float denom = __fmul_rn(isum2[s], dot3_rn(rn, ro[s]));
      const float den = fabsf(denom) > SH_DENOM_MIN ? denom : SH_DENOM_MIN;
      float lam = __fdiv_rn(diff, den);
      lam = cm[s] ? lam : 0.0f;
      apply_corr<K>(xc, si[s], sj[s], imi[s], imj[s], lam, ro[s]);
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (amask[c * K + k] == 0) continue;
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      const int o = 3 * at[k] + ax;
      x[o] = xc[k][ax];
      dv[o] = __fdiv_rn(__fsub_rn(xc[k][ax], xn[o]), dt);
    }
  }
}

template <int K, int C>
__global__ void __launch_bounds__(SH_TB)
rattle_kernel(const float* __restrict__ xp, const float* __restrict__ vp,
              const int* __restrict__ atoms,
              const uint8_t* __restrict__ amask, const int* __restrict__ ci,
              const int* __restrict__ cj, const float* __restrict__ invm,
              const uint8_t* __restrict__ cmask, int m, ShBox box,
              float* __restrict__ vout) {
  const int c = blockIdx.x * SH_TB + threadIdx.x;
  if (c >= m) return;
  int at[K];
  float im[K];
  float vc[K][3];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    at[k] = atoms[c * K + k];
    im[k] = invm[c * K + k];
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) vc[k][ax] = vp[3 * at[k] + ax];
  }
  int si[C], sj[C];
  bool cm[C];
  float imi[C], imj[C], den[C], r[C][3];
#pragma unroll
  for (int s = 0; s < C; ++s) {
    si[s] = ci[c * C + s];
    sj[s] = cj[c * C + s];
    cm[s] = cmask[c * C + s] != 0;
    imi[s] = pick1<K>(im, si[s]);
    imj[s] = pick1<K>(im, sj[s]);
    const int ai = pick_int<K>(at, si[s]);
    const int aj = pick_int<K>(at, sj[s]);
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      r[s][ax] = min_image_rn(__fsub_rn(xp[3 * ai + ax], xp[3 * aj + ax]),
                              box.len[ax], box.inv[ax], box.periodic[ax]);
    }
    const float d = __fmul_rn(__fadd_rn(imi[s], imj[s]), dot3_rn(r[s], r[s]));
    den[s] = d > SH_DENOM_MIN ? d : SH_DENOM_MIN;
  }
  for (int it = 0; it < SH_ITERS; ++it) {
#pragma unroll
    for (int s = 0; s < C; ++s) {
      float vij[3];
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) {
        vij[ax] = __fsub_rn(pick<K>(vc, si[s], ax), pick<K>(vc, sj[s], ax));
      }
      float mu = __fdiv_rn(dot3_rn(vij, r[s]), den[s]);
      mu = cm[s] ? mu : 0.0f;
      apply_corr<K>(vc, si[s], sj[s], imi[s], imj[s], mu, r[s]);
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (amask[c * K + k] == 0) continue;
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) vout[3 * at[k] + ax] = vc[k][ax];
  }
}

}  // namespace conp2

// one case per (K, C): K in 2..4 atoms, C in 1..6 constraint slots
#define CONP2_SHAKE_CASES(X) \
  X(2, 1) X(2, 2) X(2, 3) X(2, 4) X(2, 5) X(2, 6) \
  X(3, 1) X(3, 2) X(3, 3) X(3, 4) X(3, 5) X(3, 6) \
  X(4, 1) X(4, 2) X(4, 3) X(4, 4) X(4, 5) X(4, 6)

extern "C" {

// x, dv (N, 3) float32: x pre-filled with x_new and dv with zeros by the
// caller; the kernel writes the constrained rows.  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for an unsupported (K, C).
int conp2_shake_positions_f32(const float* xn, const float* xo,
                              const int* atoms, const uint8_t* amask,
                              const int* ci, const int* cj, const float* invm,
                              const float* dist2, const uint8_t* cmask, int m,
                              int k, int c, float dt, float lx, float ly,
                              float lz, int px, int py, int pz, float* x,
                              float* dv, void* stream) {
  if (m <= 0) return 0;
  const conp2::ShBox box{{lx, ly, lz}, {1.0f / lx, 1.0f / ly, 1.0f / lz},
                            {px, py, pz}};
  const int nblocks = (m + conp2::SH_TB - 1) / conp2::SH_TB;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CONP2_SHAKE_LAUNCH(KK, CC)                                          \
  if (k == KK && c == CC) {                                                 \
    conp2::shake_kernel<KK, CC><<<nblocks, conp2::SH_TB, 0, st>>>(          \
        xn, xo, atoms, amask, ci, cj, invm, dist2, cmask, m, dt, box, x,    \
        dv);                                                                \
    return static_cast<int>(cudaGetLastError());                            \
  }
  CONP2_SHAKE_CASES(CONP2_SHAKE_LAUNCH)
#undef CONP2_SHAKE_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

// vout (N, 3) float32, pre-filled with v by the caller; the kernel writes
// the constrained rows.  Returns cudaGetLastError().
int conp2_rattle_velocities_f32(const float* xp, const float* vp,
                                const int* atoms, const uint8_t* amask,
                                const int* ci, const int* cj,
                                const float* invm, const uint8_t* cmask,
                                int m, int k, int c, float lx, float ly,
                                float lz, int px, int py, int pz, float* vout,
                                void* stream) {
  if (m <= 0) return 0;
  const conp2::ShBox box{{lx, ly, lz}, {1.0f / lx, 1.0f / ly, 1.0f / lz},
                            {px, py, pz}};
  const int nblocks = (m + conp2::SH_TB - 1) / conp2::SH_TB;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CONP2_RATTLE_LAUNCH(KK, CC)                                         \
  if (k == KK && c == CC) {                                                 \
    conp2::rattle_kernel<KK, CC><<<nblocks, conp2::SH_TB, 0, st>>>(         \
        xp, vp, atoms, amask, ci, cj, invm, cmask, m, box, vout);           \
    return static_cast<int>(cudaGetLastError());                            \
  }
  CONP2_SHAKE_CASES(CONP2_RATTLE_LAUNCH)
#undef CONP2_RATTLE_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
