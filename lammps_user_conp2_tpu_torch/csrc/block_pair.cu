// Block-union Verlet pair sweep (K1): LJ 12-6 + erfc real-space Coulomb for
// every block atom against the sorted-unique union of its block's neighbour
// rows, with the CONP Gaussian correction for (electrode, electrolyte) pairs
// fused in as an option.
//
// Replaces the TPU kernel in lammps_user_conp2_tpu/ops/pallas/block_pair.py,
// block_pair_pallas (body _kernel).
//
// What bounds it on this card: the per-pair transcendental chain (rsqrt,
// exp, the A&S polynomial with its division; a second chain on correction
// pairs) and the gather of the union rows.  The union rows are scattered
// reads of x/q/type by atom id, which is why the block form exists: each
// union (U ~ 100-200 ids) is gathered ONCE into shared memory and reused by
// all B = 8 block atoms, instead of one gather per (atom, neighbour) slot.
// The displacement and |d|^2 are formed op for op as in the plain version
// (common.cuh rsq_rn), so both agree on which pairs are inside the cutoff.
//
// Design: one CTA per i-block, one warp per block atom (8 warps).  The CTA
// stages the union rows (x, y, z, q, flag, type, id) and the (T+1)^2 type
// tables in shared memory.  Each warp's lanes stride over the union and run
// the chain; a warp-shuffle reduction gives the atom's force, which lane 0
// writes once at the atom's slot (no atomics, deterministic).  Pad ids (n)
// are masked by index, never by sentinel coordinates.  The fused correction
// runs only in CTAs whose block and union hold an (electrode, electrolyte)
// pair (a CTA-uniform gate: cell-sorted electrodes sit in few blocks).
// Energies are summed per CTA in a fixed order and then over CTAs by a
// one-block second kernel: raw sums over ordered pairs (the caller halves).
//
// Special-bond exclusions (bonded systems) are applied per pair, as in the
// pair kernel (pair_kernel.cu) and the plain version: each warp keeps its
// block atom's (at most BP_MAX_EXCL) listed partners and factors in
// registers and checks every union member against them; a listed pair gets
// s * LJ and the Coulomb term minus (1 - s) * qq/r.  Sweeping the excluded
// pairs at s = 1 and subtracting them afterwards (the TPU kernel's way)
// cancels catastrophically in float32 at bonded distances.
#include <cstdint>

#include "common.cuh"

namespace conp2 {

constexpr int BP_B = 8;           // block atoms (one warp each)
constexpr int BP_TB = 32 * BP_B;  // threads per CTA
constexpr int BP_MAX_NT1 = 16;    // type tables up to 16 x 16
constexpr int BP_REDUCE_TB = 256;
constexpr int BP_MAX_EXCL = 16;   // listed special partners per atom

struct BlockArgs {
  const float* x;          // (n, 3)
  const float* q;          // (n,)
  const int64_t* type;     // (n,)
  const float* ele_f;      // (n,) 1 = electrode (fused correction only)
  const float* ely_f;      // (n,) 1 = electrolyte (fused correction only)
  const int64_t* un;       // (nb, U) union ids, pad n
  const int64_t* rows;     // (nb, B) block atom ids, pad n
  const float* lj;         // (4, nt1, nt1)
  const float* gtab;       // (2, nt1, nt1) eta, fo (fused correction only)
  const int64_t* exi;      // (n, m) special partners, padded with n
  const float* exv;        // (n, m) their factors s
  int m;                   // 0: no exclusions
  int n, nb, usz, nt1;
  float bx, by, bz, ibx, iby, ibz;
  int px, py, pz;
  float cutsq, g, qqr2e;
  float* f_out;            // (nb * B, 3) slot order
  float* partials;         // (nb, 3) per-CTA energy sums
};

template <bool FUSE, bool EXCL>
__global__ void __launch_bounds__(BP_TB) block_pair_kernel(BlockArgs a) {
  __shared__ float s_tab[6 * BP_MAX_NT1 * BP_MAX_NT1];
  __shared__ float s_red[BP_B][3];
  extern __shared__ float s_dyn[];
  const int usz = a.usz;
  float* ux = s_dyn;
  float* uy = ux + usz;
  float* uz = uy + usz;
  float* uq = uz + usz;
  float* uf = uq + usz;
  int* ut = reinterpret_cast<int*>(uf + usz);
  int* uid = ut + usz;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int w = tid >> 5;
  const int blk = blockIdx.x;
  const int n = a.n;
  const int nt1 = a.nt1;
  const int tsz = nt1 * nt1;
  for (int k = tid; k < 4 * tsz; k += BP_TB) s_tab[k] = a.lj[k];
  if (FUSE) {
    for (int k = tid; k < 2 * tsz; k += BP_TB) s_tab[4 * tsz + k] = a.gtab[k];
  }
  // stage the union rows once for all B block atoms
  int u_ele = 0, u_ely = 0;
  for (int k = tid; k < usz; k += BP_TB) {
    const int64_t id = a.un[static_cast<int64_t>(blk) * usz + k];
    if (id < n) {
      ux[k] = a.x[3 * id];
      uy[k] = a.x[3 * id + 1];
      uz[k] = a.x[3 * id + 2];
      uq[k] = a.q[id];
      ut[k] = static_cast<int>(a.type[id]);
      uid[k] = static_cast<int>(id);
      if (FUSE) {
        const float fl = a.ele_f[id] - a.ely_f[id];
        uf[k] = fl;
        u_ele |= fl > 0.f;
        u_ely |= fl < 0.f;
      }
    } else {
      uid[k] = n;
    }
  }
  // this warp's block atom
  const int64_t ai = a.rows[static_cast<int64_t>(blk) * BP_B + w];
  const bool row_ok = ai < n;
  float xi = 0.f, yi = 0.f, zi = 0.f, qi = 0.f, fli = 0.f;
  int ti = 0;
  if (row_ok) {
    xi = a.x[3 * ai];
    yi = a.x[3 * ai + 1];
    zi = a.x[3 * ai + 2];
    qi = a.q[ai];
    ti = static_cast<int>(a.type[ai]);
    if (FUSE) fli = a.ele_f[ai] - a.ely_f[ai];
  }
  int exj[BP_MAX_EXCL];
  float exs[BP_MAX_EXCL];
  if (EXCL) {
#pragma unroll
    for (int k = 0; k < BP_MAX_EXCL; ++k) {
      const bool on = row_ok && k < a.m;
      exj[k] = on ? static_cast<int>(a.exi[ai * a.m + k]) : -1;
      exs[k] = on ? a.exv[ai * a.m + k] : 1.0f;
    }
  }
  bool corr = false;
  if (FUSE) {
    // CTA-uniform gate: some (electrode, electrolyte) pair is possible
    const int b_ele = __syncthreads_or(lane == 0 && fli > 0.f);
    const int b_ely = __syncthreads_or(lane == 0 && fli < 0.f);
    const int any_ue = __syncthreads_or(u_ele);
    const int any_uy = __syncthreads_or(u_ely);
    corr = (b_ele && any_uy) || (b_ely && any_ue);
  } else {
    __syncthreads();                    // union rows and tables staged
  }
  const float* trow = s_tab + ti * nt1;

  float fx = 0.f, fy = 0.f, fz = 0.f, ev = 0.f, ec = 0.f, ecorr = 0.f;
  if (row_ok) {
    const int iid = static_cast<int>(ai);
    for (int k = lane; k < usz; k += 32) {
      const int j = uid[k];
      if (j >= n || j == iid) continue;
      const float dx = min_image_rn(__fsub_rn(xi, ux[k]), a.bx, a.ibx, a.px);
      const float dy = min_image_rn(__fsub_rn(yi, uy[k]), a.by, a.iby, a.py);
      const float dz = min_image_rn(__fsub_rn(zi, uz[k]), a.bz, a.ibz, a.pz);
      const float rsq = rsq_rn(dx, dy, dz);
      if (!(rsq < a.cutsq)) continue;
      const int tj = ut[k];
      const float rinv = rsqrtf(rsq);
      const float r2inv = rinv * rinv;
      const float r6inv = r2inv * r2inv * r2inv;
      const float l1 = trow[tj], l2 = trow[tsz + tj];
      const float l3 = trow[2 * tsz + tj], l4 = trow[3 * tsz + tj];
      const float grij = a.g * rsq * rinv;             // g * r
      const float expm2 = expf(-grij * grij);
      const float erfc = as_poly(grij) * expm2;
      const float qq = qi * uq[k];
      const float pref = a.qqr2e * rinv * qq;
      float fpair;
      if (EXCL) {
        float sij = 1.0f;
#pragma unroll
        for (int e = 0; e < BP_MAX_EXCL; ++e) {
          if (exj[e] == j) sij = exs[e];
        }
        float flj = 0.0f;
        if (sij > 0.0f) {
          flj = sij * r6inv * (l1 * r6inv - l2) * r2inv;
          ev += sij * r6inv * (l3 * r6inv - l4);
        }
        const float dcoul = (1.0f - sij) * pref;
        ec += pref * erfc - dcoul;
        fpair = flj + (pref * (erfc + EWALD_F * grij * expm2) - dcoul) * r2inv;
      } else {
        const float flj = r6inv * (l1 * r6inv - l2) * r2inv;
        ev += r6inv * (l3 * r6inv - l4);
        ec += pref * erfc;
        fpair = flj + pref * (erfc + EWALD_F * grij * expm2) * r2inv;
      }
      if (FUSE && corr && fli * uf[k] < 0.f) {
        // CONP Gaussian correction (fix_conp.cpp:1368-1444)
        const float et = trow[4 * tsz + tj];
        const float fo = trow[5 * tsz + tj];
        const float e2 = et * et * rsq;
        const float ghalf = expf(-0.5f * e2);
        const float em2 = ghalf * ghalf;               // exp(-e2)
        const float erfcr = erfcr_clamped(e2, em2);
        const float gexp = fo * ghalf;
        const float ferfcr = e2 < ERFC_MAX_SQ ? erfcr + EWALD_F * em2 : 0.f;
        const float cpref = a.qqr2e * qq;
        ecorr += cpref * (gexp - erfcr * et);
        fpair += cpref * (e2 * gexp - ferfcr * et) * r2inv;
      }
      fx += fpair * dx;
      fy += fpair * dy;
      fz += fpair * dz;
    }
  }
  fx = warp_sum(fx);
  fy = warp_sum(fy);
  fz = warp_sum(fz);
  ev = warp_sum(ev);
  ec = warp_sum(ec);
  ecorr = warp_sum(ecorr);
  if (lane == 0) {
    const int64_t slot = static_cast<int64_t>(blk) * BP_B + w;
    a.f_out[3 * slot] = fx;
    a.f_out[3 * slot + 1] = fy;
    a.f_out[3 * slot + 2] = fz;
    s_red[w][0] = ev;
    s_red[w][1] = ec;
    s_red[w][2] = ecorr;
  }
  __syncthreads();
  if (tid < 3) {
    float s = 0.f;
    for (int k = 0; k < BP_B; ++k) s += s_red[k][tid];
    a.partials[3 * static_cast<int64_t>(blk) + tid] = s;
  }
}

// sums[k] = sum over CTAs of partials[., k], fixed order
__global__ void __launch_bounds__(BP_REDUCE_TB)
block_pair_reduce(const float* partials, int nb, float* sums) {
  __shared__ float s[3][BP_REDUCE_TB];
  const int tid = threadIdx.x;
  float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f;
  for (int b = tid; b < nb; b += BP_REDUCE_TB) {
    acc0 += partials[3 * b];
    acc1 += partials[3 * b + 1];
    acc2 += partials[3 * b + 2];
  }
  s[0][tid] = acc0;
  s[1][tid] = acc1;
  s[2][tid] = acc2;
  __syncthreads();
  for (int h = BP_REDUCE_TB / 2; h > 0; h >>= 1) {
    if (tid < h) {
      s[0][tid] += s[0][tid + h];
      s[1][tid] += s[1][tid + h];
      s[2][tid] += s[2][tid + h];
    }
    __syncthreads();
  }
  if (tid < 3) sums[tid] = s[tid][0];
}

template <bool FUSE, bool EXCL>
cudaError_t launch_block_pair(const BlockArgs& a, size_t smem,
                              cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      block_pair_kernel<FUSE, EXCL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  block_pair_kernel<FUSE, EXCL><<<a.nb, BP_TB, smem, s>>>(a);
  return cudaGetLastError();
}

}  // namespace conp2

extern "C" {

// f_out (nb*B, 3) in slot order and sums (3) = raw (elj, ecoul, ecorr) over
// ordered pairs, float32.  ele_f == NULL selects the sweep without the CONP
// correction (ecorr is then 0); m == 0 the sweep without special-bond
// exclusions (exi, exv ignored).  Returns cudaGetLastError().
int conp2_block_pair_f32(const float* x, const float* q, const int64_t* type,
                         const float* ele_f, const float* ely_f,
                         const int64_t* un, const int64_t* rows,
                         const float* lj, const float* gtab,
                         const int64_t* exi, const float* exv, int m, int n,
                         int nb, int bsz, int usz, int nt1, float bx,
                         float by, float bz, int px, int py, int pz,
                         float cutsq, float g_ewald, float qqr2e, float* f_out,
                         float* partials, float* sums, void* stream) {
  if (n <= 0 || nb <= 0 || usz <= 0 || bsz != conp2::BP_B || nt1 <= 0 ||
      nt1 > conp2::BP_MAX_NT1 || m < 0 || m > conp2::BP_MAX_EXCL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  conp2::BlockArgs a{x, q, type, ele_f, ely_f, un, rows, lj, gtab, exi, exv,
                     m, n, nb, usz, nt1, bx, by, bz, 1.0f / bx, 1.0f / by,
                     1.0f / bz, px, py, pz, cutsq, g_ewald, qqr2e, f_out,
                     partials};
  const size_t smem = static_cast<size_t>(usz) * 7 * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool fuse = ele_f != nullptr;
  cudaError_t err;
  if (fuse && m > 0) {
    err = conp2::launch_block_pair<true, true>(a, smem, s);
  } else if (fuse) {
    err = conp2::launch_block_pair<true, false>(a, smem, s);
  } else if (m > 0) {
    err = conp2::launch_block_pair<false, true>(a, smem, s);
  } else {
    err = conp2::launch_block_pair<false, false>(a, smem, s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  conp2::block_pair_reduce<<<1, conp2::BP_REDUCE_TB, 0, s>>>(partials, nb,
                                                             sums);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
