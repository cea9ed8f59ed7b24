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
// of K = 3 atoms and C = 3 constraints, 3,776 rows) one call moves ~60 KB
// and does ~0.6 MFLOP: a roofline bound of tens of nanoseconds, below the
// cost of one launch.  What sets the time is the serial chain of
// SH_ITERS x C dependent slot updates in each thread (each update needs the
// previous one's positions), the two dependent load rounds before it and
// the launch itself.  So the design shortens the chain and the rounds, and
// makes the call one launch.
//
// Design:
// - One launch per call writes every row once.  Blocks [0, ceil(M / SH_TB))
//   run one thread per cluster and write its valid rows; the blocks after
//   them copy the free rows (atoms in no cluster's valid columns) from the
//   input, a thread per row of the free-row table built at setup
//   (ops/kernels/shake_kernel.py free_rows).  SHAKE's dv there is
//   (x - x) (1 / dt), the plain version's formula.  No copy or fill before
//   the kernel, no row written twice, padding columns never written.
// - Packed cluster records (pack_records): the atom ids, the amask bits, the
//   slot code (si | sj << 2 | cmask << 4 per slot), per slot (imi, imj,
//   2 (imi + imj), d^2) and the slots' imi + imj, every constant formed in
//   float32 at setup as the earlier kernel formed it per call.  Two load
//   rounds: the record (16-byte loads), then the cluster's rows of x_new and
//   x_old (or x and v).
// - K7's minimum image hoisted out of the sweeps: at load each slot's
//   per-axis image shift k0 = rint(d / L) of x_new, and L k0; in the sweeps
//   the bond vector is d - L k0 (one subtraction on the chain in place of
//   min_image_rn's multiply, rint, tie test and branch).  Off the chain
//   each update tests |d / L - k0| <= 1/4 (and |k0| <= 4096 at load), which
//   implies that min_image_rn takes the same shift (its tie test needs
//   |d / L - k0| within 1e-5 (1 + |d / L|) of 1/2), and ORs a failure into
//   a flag.  A flagged thread reruns its cluster from x_new through the
//   exact loop (min_image_rn per update).  Either way each update is the
//   earlier kernel's, op for op: bit-identical by construction.
// - Slot columns known at compile time where every cluster shares one slot
//   code that has an instantiation (SH_LINEAR3, the il decks' cations);
//   every other table reads its code per cluster (SH_RUNTIME).
// - dv = (x - x_new) * inv_dt, inv_dt = 1 / dt formed in double on the host
//   and rounded to float32: PyTorch divides a CUDA float32 tensor by a
//   Python float as that multiply, so the plain version's (x - x_new) / dt
//   on the card is this, bit for bit, at any dt.
// Every update is formed op for op as the plain PyTorch version forms it,
// with round-to-nearest intrinsics, no FMA contraction and the IEEE
// division, so kernel and plain version agree bit for bit (min_image_rn
// divides only within 1e-5 of a half-integer, where d * (1/L) might round
// the other way).  Each atom is in at most one cluster: no atomics, no
// shared memory.
#include <cstdint>

#include "common.cuh"

namespace conp2 {

// threads per block: 64 ran both cells fastest (il 320 clusters, bonded
// 1,329; 32 and 128 were slower at one or the other)
constexpr int SH_TB = 64;
constexpr int SH_ITERS = 12;   // the JAX package's fixed sweep count
constexpr float SH_DENOM_MIN = 1e-12f;
// slot s of a code word: si | sj << 2 | cmask << 4, at bit 5 s
constexpr uint32_t SH_RUNTIME = 0xFFFFFFFFu;
constexpr uint32_t sh_slot(uint32_t si, uint32_t sj) {
  return si | sj << 2 | 1u << 4;
}
// the il decks' 3-site cations: bonds (0,1), (1,2), the angle's 1-3 (0,2)
constexpr uint32_t SH_LINEAR3 =
    sh_slot(0, 1) | sh_slot(1, 2) << 5 | sh_slot(0, 2) << 10;
// an image shift this large could meet min_image_rn's tie margin
// 1e-5 (1 + |t|) at |d/L - k0| <= 1/4; such a cluster takes the exact loop
constexpr float SH_K0_MAX = 4096.0f;

// int4 units of a record: atoms, (code, amask bits), C slot float4s, the
// slots' imi + imj packed four to a float4
template <int C>
__host__ __device__ constexpr int sh_rec_len() {
  return 2 + C + (C + 3) / 4;
}

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

// v[col][ax] for a cluster-local column, without local memory (folds to a
// register when col is a compile-time constant)
template <int K>
__device__ __forceinline__ float pick(const float (&v)[K][3], int col,
                                      int ax) {
  float r = v[0][ax];
#pragma unroll
  for (int k = 1; k < K; ++k) r = (col == k) ? v[k][ax] : r;
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

// A cluster's record, unpacked: the slot code from the template where it is
// known at compile time
template <int K, int C, uint32_t CODE>
struct ShRec {
  int at[K];
  uint32_t amask;
  int si[C], sj[C];
  bool cm[C];
  float4 sl[C];            // (imi, imj, 2 (imi + imj), d^2)
  float isum[C];           // imi + imj

  __device__ __forceinline__ void load(const int4* __restrict__ rec, int c) {
    const int4* r = rec + static_cast<int64_t>(c) * sh_rec_len<C>();
    const int4 a = __ldg(r);
    const int4 h = __ldg(r + 1);
    const float4* f = reinterpret_cast<const float4*>(r + 2);
#pragma unroll
    for (int s = 0; s < C; ++s) sl[s] = __ldg(f + s);
    float4 q[(C + 3) / 4];
#pragma unroll
    for (int i = 0; i < (C + 3) / 4; ++i) q[i] = __ldg(f + C + i);
    const int aa[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int k = 0; k < K; ++k) at[k] = aa[k];
    amask = static_cast<uint32_t>(h.y);
    const uint32_t code = CODE == SH_RUNTIME ? static_cast<uint32_t>(h.x)
                                             : CODE;
#pragma unroll
    for (int s = 0; s < C; ++s) {
      si[s] = (code >> (5 * s)) & 3u;
      sj[s] = (code >> (5 * s + 2)) & 3u;
      cm[s] = (code >> (5 * s + 4)) & 1u;
      const float4 qq = q[s / 4];
      const float w[4] = {qq.x, qq.y, qq.z, qq.w};
      isum[s] = w[s % 4];
    }
  }
};

// The free rows: thread i of the free blocks copies free row fr[i] of src
// into dst, and writes dv = (src - src) * inv_dt there when dv is not null.
__device__ __forceinline__ void copy_free(int i, const float* __restrict__ src,
                                          const int* __restrict__ fr, int nf,
                                          float inv_dt,
                                          float* __restrict__ dst,
                                          float* __restrict__ dv) {
  if (i >= nf) return;
  const int o = 3 * fr[i];
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    const float v = __ldg(src + o + ax);
    dst[o + ax] = v;
    if (dv != nullptr) dv[o + ax] = __fmul_rn(__fsub_rn(v, v), inv_dt);
  }
}

// SH_ITERS sweeps of SHAKE slot updates over one cluster.  HOIST: the bond
// vector is d - L k0 and ``bad`` collects the test that min_image_rn would
// take the same shift; otherwise min_image_rn per update (exact loop).
template <int K, int C, uint32_t CODE, bool HOIST>
__device__ __forceinline__ void shake_sweeps(
    float (&xc)[K][3], const ShRec<K, C, CODE>& R, const float (&ro)[C][3],
    const float (&lk)[C][3], const float (&k0)[C][3], const float (&invp)[3],
    const float (&thr)[3], const ShBox& box, bool& bad) {
  for (int it = 0; it < SH_ITERS; ++it) {
#pragma unroll
    for (int s = 0; s < C; ++s) {
      float rn[3];
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) {
        const float d = __fsub_rn(pick<K>(xc, R.si[s], ax),
                                  pick<K>(xc, R.sj[s], ax));
        if (HOIST) {
          rn[ax] = __fsub_rn(d, lk[s][ax]);
          bad |= fabsf(fmaf(d, invp[ax], -k0[s][ax])) > thr[ax];
        } else {
          rn[ax] = min_image_rn(d, box.len[ax], box.inv[ax],
                                box.periodic[ax]);
        }
      }
      const float diff = __fsub_rn(dot3_rn(rn, rn), R.sl[s].w);
      const float denom = __fmul_rn(R.sl[s].z, dot3_rn(rn, ro[s]));
      const float den = fabsf(denom) > SH_DENOM_MIN ? denom : SH_DENOM_MIN;
      float lam = __fdiv_rn(diff, den);
      lam = R.cm[s] ? lam : 0.0f;
      apply_corr<K>(xc, R.si[s], R.sj[s], R.sl[s].x, R.sl[s].y, lam, ro[s]);
    }
  }
}

template <int K, int C, uint32_t CODE>
__global__ void __launch_bounds__(SH_TB)
shake_rows_kernel(const float* __restrict__ xn, const float* __restrict__ xo,
                  const int4* __restrict__ rec, const int* __restrict__ fr,
                  int m, int nf, float inv_dt, ShBox box,
                  float* __restrict__ x, float* __restrict__ dv) {
  const int tb = blockDim.x;
  const int nbc = (m + tb - 1) / tb;
  if (static_cast<int>(blockIdx.x) >= nbc) {
    copy_free((blockIdx.x - nbc) * tb + threadIdx.x, xn, fr, nf, inv_dt, x,
              dv);
    return;
  }
  const int c = blockIdx.x * tb + threadIdx.x;
  if (c >= m) return;
  ShRec<K, C, CODE> R;
  R.load(rec, c);
  // the cluster's rows of x_new and x_old, one load round
  float x0[K][3], xoc[K][3];
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      x0[k][ax] = xn[3 * R.at[k] + ax];
      xoc[k][ax] = xo[3 * R.at[k] + ax];
    }
  }
  float invp[3], thr[3];
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    invp[ax] = box.periodic[ax] ? box.inv[ax] : 0.0f;
    thr[ax] = box.periodic[ax] ? 0.25f : __int_as_float(0x7f800000);
  }
  // reference bond vectors from the pre-drift positions; image shifts of
  // x_new
  float ro[C][3], lk[C][3], k0[C][3];
  bool bad = false;
#pragma unroll
  for (int s = 0; s < C; ++s) {
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      ro[s][ax] = min_image_rn(__fsub_rn(pick<K>(xoc, R.si[s], ax),
                                         pick<K>(xoc, R.sj[s], ax)),
                               box.len[ax], box.inv[ax], box.periodic[ax]);
      const float d = __fsub_rn(pick<K>(x0, R.si[s], ax),
                                pick<K>(x0, R.sj[s], ax));
      const float k = box.periodic[ax] ? rintf(__fmul_rn(d, box.inv[ax]))
                                       : 0.0f;
      k0[s][ax] = k;
      lk[s][ax] = __fmul_rn(box.len[ax], k);
      bad |= fabsf(k) > SH_K0_MAX;
    }
  }
  float xc[K][3];
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) xc[k][ax] = x0[k][ax];
  }
  shake_sweeps<K, C, CODE, true>(xc, R, ro, lk, k0, invp, thr, box, bad);
  if (bad) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) xc[k][ax] = x0[k][ax];
    }
    shake_sweeps<K, C, CODE, false>(xc, R, ro, lk, k0, invp, thr, box, bad);
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (((R.amask >> k) & 1u) == 0) continue;
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      const int o = 3 * R.at[k] + ax;
      x[o] = xc[k][ax];
      dv[o] = __fmul_rn(__fsub_rn(xc[k][ax], x0[k][ax]), inv_dt);
    }
  }
}

template <int K, int C, uint32_t CODE>
__global__ void __launch_bounds__(SH_TB)
rattle_rows_kernel(const float* __restrict__ xp, const float* __restrict__ vp,
                   const int4* __restrict__ rec, const int* __restrict__ fr,
                   int m, int nf, ShBox box, float* __restrict__ vout) {
  const int tb = blockDim.x;
  const int nbc = (m + tb - 1) / tb;
  if (static_cast<int>(blockIdx.x) >= nbc) {
    copy_free((blockIdx.x - nbc) * tb + threadIdx.x, vp, fr, nf, 1.0f, vout,
              nullptr);
    return;
  }
  const int c = blockIdx.x * tb + threadIdx.x;
  if (c >= m) return;
  ShRec<K, C, CODE> R;
  R.load(rec, c);
  float xpc[K][3], vc[K][3];
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      xpc[k][ax] = xp[3 * R.at[k] + ax];
      vc[k][ax] = vp[3 * R.at[k] + ax];
    }
  }
  float den[C], r[C][3];
#pragma unroll
  for (int s = 0; s < C; ++s) {
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      r[s][ax] = min_image_rn(__fsub_rn(pick<K>(xpc, R.si[s], ax),
                                        pick<K>(xpc, R.sj[s], ax)),
                              box.len[ax], box.inv[ax], box.periodic[ax]);
    }
    const float d = __fmul_rn(R.isum[s], dot3_rn(r[s], r[s]));
    den[s] = d > SH_DENOM_MIN ? d : SH_DENOM_MIN;
  }
  for (int it = 0; it < SH_ITERS; ++it) {
#pragma unroll
    for (int s = 0; s < C; ++s) {
      float vij[3];
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) {
        vij[ax] = __fsub_rn(pick<K>(vc, R.si[s], ax),
                            pick<K>(vc, R.sj[s], ax));
      }
      float mu = __fdiv_rn(dot3_rn(vij, r[s]), den[s]);
      mu = R.cm[s] ? mu : 0.0f;
      apply_corr<K>(vc, R.si[s], R.sj[s], R.sl[s].x, R.sl[s].y, mu, r[s]);
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (((R.amask >> k) & 1u) == 0) continue;
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) vout[3 * R.at[k] + ax] = vc[k][ax];
  }
}

inline int sh_blocks(int m, int nf) {
  return (m + SH_TB - 1) / SH_TB + (nf + SH_TB - 1) / SH_TB;
}

}  // namespace conp2

// one case per (K, C): K in 2..4 atoms, C in 1..6 constraint slots
#define CONP2_SHAKE_CASES(X) \
  X(2, 1) X(2, 2) X(2, 3) X(2, 4) X(2, 5) X(2, 6) \
  X(3, 1) X(3, 2) X(3, 3) X(3, 4) X(3, 5) X(3, 6) \
  X(4, 1) X(4, 2) X(4, 3) X(4, 4) X(4, 5) X(4, 6)

extern "C" {

// x, dv (N, 3) float32, written in full: the clusters' valid rows and the
// nf free rows fr.  rec: the packed cluster records; code: the slot code
// every cluster shares, or -1; inv_dt: 1 / dt, in double rounded to float.
// Returns cudaGetLastError(), or
// cudaErrorInvalidValue for an unsupported (K, C).
int conp2_shake_positions_f32(const float* xn, const float* xo,
                              const int* rec, const int* fr, int m, int nf,
                              int k, int c, int code, float inv_dt, float lx,
                              float ly, float lz, int px, int py, int pz,
                              float* x, float* dv, void* stream) {
  const int nblocks = conp2::sh_blocks(m, nf);
  if (nblocks == 0) return 0;
  const conp2::ShBox box{{lx, ly, lz}, {1.0f / lx, 1.0f / ly, 1.0f / lz},
                            {px, py, pz}};
  const int4* r = reinterpret_cast<const int4*>(rec);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k == 3 && c == 3 && static_cast<uint32_t>(code) == conp2::SH_LINEAR3) {
    conp2::shake_rows_kernel<3, 3, conp2::SH_LINEAR3>
        <<<nblocks, conp2::SH_TB, 0, st>>>(xn, xo, r, fr, m, nf, inv_dt, box,
                                           x, dv);
    return static_cast<int>(cudaGetLastError());
  }
#define CONP2_SHAKE_LAUNCH(KK, CC)                                          \
  if (k == KK && c == CC) {                                                 \
    conp2::shake_rows_kernel<KK, CC, conp2::SH_RUNTIME>                     \
        <<<nblocks, conp2::SH_TB, 0, st>>>(xn, xo, r, fr, m, nf, inv_dt,    \
                                           box, x, dv);                     \
    return static_cast<int>(cudaGetLastError());                            \
  }
  CONP2_SHAKE_CASES(CONP2_SHAKE_LAUNCH)
#undef CONP2_SHAKE_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

// vout (N, 3) float32, written in full (the clusters' valid rows and the
// free rows); arguments as above.  Returns cudaGetLastError().
int conp2_rattle_velocities_f32(const float* xp, const float* vp,
                                const int* rec, const int* fr, int m, int nf,
                                int k, int c, int code, float lx, float ly,
                                float lz, int px, int py, int pz, float* vout,
                                void* stream) {
  const int nblocks = conp2::sh_blocks(m, nf);
  if (nblocks == 0) return 0;
  const conp2::ShBox box{{lx, ly, lz}, {1.0f / lx, 1.0f / ly, 1.0f / lz},
                            {px, py, pz}};
  const int4* r = reinterpret_cast<const int4*>(rec);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k == 3 && c == 3 && static_cast<uint32_t>(code) == conp2::SH_LINEAR3) {
    conp2::rattle_rows_kernel<3, 3, conp2::SH_LINEAR3>
        <<<nblocks, conp2::SH_TB, 0, st>>>(xp, vp, r, fr, m, nf, box, vout);
    return static_cast<int>(cudaGetLastError());
  }
#define CONP2_RATTLE_LAUNCH(KK, CC)                                         \
  if (k == KK && c == CC) {                                                 \
    conp2::rattle_rows_kernel<KK, CC, conp2::SH_RUNTIME>                    \
        <<<nblocks, conp2::SH_TB, 0, st>>>(xp, vp, r, fr, m, nf, box,       \
                                           vout);                           \
    return static_cast<int>(cudaGetLastError());                            \
  }
  CONP2_SHAKE_CASES(CONP2_RATTLE_LAUNCH)
#undef CONP2_RATTLE_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
