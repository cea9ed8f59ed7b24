// Tile pair sweep: LJ 12-6 + erfc real-space Coulomb over every pair within
// the cutoff, with the CONP Gaussian correction for (electrode, electrolyte)
// pairs fused in as an option.
//
// Replaces the TPU kernel in lammps_user_conp2_tpu/ops/pallas/pair_kernel.py,
// pair_forces_pallas (body _kernel).
//
// What bounds it on this card: the per-pair transcendental chain -- rsqrt,
// exp and the A&S polynomial with its division, and for fused correction
// pairs a second exp/rsqrt/division chain -- not bytes.  All positions
// (N x 16 B) sit in L2 many times over, and each column tile is read into
// shared memory once per row block.
//
// Design: the atoms are z-sorted (perm, zs from ops/kernels/zorder.z_perm).
// One thread owns one row atom; a block owns PAIR_TB consecutive sorted
// rows.  The block walks the column tiles of PAIR_TB sorted atoms, skips
// (block-uniformly) every tile whose z bounds lie further than
// cutoff + Z_MARGIN from its own (minimum image on a periodic z), stages the
// others in shared memory and tests every x/y pair there, so the chain runs
// only for pairs of nearby z-slabs.  Each ordered pair (i, j != i) is
// evaluated and each thread writes its own force row once, at the atom's
// original index: no atomics, deterministic.  The energies sum over ordered
// pairs, are reduced per block in a fixed order, and halved by a one-block
// second kernel.  There are no pad atoms: the ragged last tile is cut by
// index, never by a sentinel coordinate.  LJ and Gaussian coefficients are
// read from the (T+1)^2 type tables in shared memory.
//
// Special-bond exclusions (bonded systems) are applied per pair, as the
// plain version applies them: each row holds its (at most MAX_EXCL) listed
// partners and factors in registers, and a listed pair gets s * LJ and the
// Coulomb term minus (1 - s) * qq/r.  Sweeping the excluded pairs at s = 1
// and subtracting them afterwards (the TPU kernel's way) cancels
// catastrophically in float32: a cation's bonded sites sit 1.8 A apart,
// where LJ is ~1e4 kcal/mol per pair.
#include <cstdint>

#include "common.cuh"

namespace conp2 {

constexpr int PAIR_TB = 64;       // rows per block == column tile width
constexpr int MAX_NT1 = 16;       // type tables up to 16 x 16
constexpr int REDUCE_TB = 256;
constexpr int MAX_EXCL = 16;      // listed special partners per atom

struct PairArgs {
  const float* x;          // (n, 3) original order
  const float* q;          // (n,)
  const int64_t* type;     // (n,)
  const float* ele_f;      // (n,) 1 = electrode (fused correction only)
  const float* ely_f;      // (n,) 1 = electrolyte (fused correction only)
  const int64_t* perm;     // (n,) sorted position -> atom index
  const float* zs;         // (n,) sorted wrapped z keys
  const float* lj;         // (4, nt1, nt1) lj1..lj4
  const float* gtab;       // (2, nt1, nt1) eta, fo (fused correction only)
  const int64_t* exi;      // (n, m) special partners, padded with n
  const float* exv;        // (n, m) their factors s
  int m;                   // 0: no exclusions
  int n, nt1;
  float bx, by, bz, ibx, iby, ibz;
  int px, py, pz;
  float cutsq, zcut, g, qqr2e;
  float* f_out;            // (n, 3) original order
  float* partials;         // (gridDim.x, 3) per-block energy sums
};

template <bool FUSE, bool EXCL>
__global__ void __launch_bounds__(PAIR_TB) pair_kernel(PairArgs a) {
  __shared__ float s_tab[6 * MAX_NT1 * MAX_NT1];
  __shared__ float sx[PAIR_TB], sy[PAIR_TB], sz[PAIR_TB], sq[PAIR_TB];
  __shared__ int st[PAIR_TB];
  __shared__ int64_t sa[PAIR_TB];
  __shared__ float se[PAIR_TB], sl[PAIR_TB];
  __shared__ float sred[3][PAIR_TB];

  const int tid = threadIdx.x;
  const int nt1 = a.nt1;
  const int tsz = nt1 * nt1;
  for (int k = tid; k < 4 * tsz; k += PAIR_TB) s_tab[k] = a.lj[k];
  if (FUSE) {
    for (int k = tid; k < 2 * tsz; k += PAIR_TB) s_tab[4 * tsz + k] = a.gtab[k];
  }

  const int n = a.n;
  const int r0 = blockIdx.x * PAIR_TB;
  const int r1 = min(n, r0 + PAIR_TB);
  const int i = r0 + tid;
  const bool row_ok = i < n;
  float xi = 0.f, yi = 0.f, zi = 0.f, qi = 0.f, ei = 0.f, li = 0.f;
  int ti = 0;
  int64_t ai = 0;
  if (row_ok) {
    ai = a.perm[i];
    xi = a.x[3 * ai];
    yi = a.x[3 * ai + 1];
    zi = a.x[3 * ai + 2];
    qi = a.q[ai];
    ti = static_cast<int>(a.type[ai]);
    if (FUSE) {
      ei = a.ele_f[ai];
      li = a.ely_f[ai];
    }
  }
  int64_t exj[MAX_EXCL];
  float exs[MAX_EXCL];
  if (EXCL) {
#pragma unroll
    for (int k = 0; k < MAX_EXCL; ++k) {
      const bool on = row_ok && k < a.m;
      exj[k] = on ? a.exi[ai * a.m + k] : -1;
      exs[k] = on ? a.exv[ai * a.m + k] : 1.0f;
    }
  }
  const float zr_lo = a.zs[r0];
  const float zr_hi = a.zs[r1 - 1];
  __syncthreads();                      // type tables staged
  const float* trow = s_tab + ti * nt1; // row ti of every table

  float fx = 0.f, fy = 0.f, fz = 0.f, ev = 0.f, ec = 0.f, ecorr = 0.f;
  const int ntile = (n + PAIR_TB - 1) / PAIR_TB;
  for (int jt = 0; jt < ntile; ++jt) {
    const int j0 = jt * PAIR_TB;
    const int j1 = min(n, j0 + PAIR_TB);
    const float zc_lo = a.zs[j0];
    const float zc_hi = a.zs[j1 - 1];
    float gap = fmaxf(fmaxf(zc_lo - zr_hi, zr_lo - zc_hi), 0.0f);
    if (a.pz) {
      const float span = fmaxf(zr_hi, zc_hi) - fminf(zr_lo, zc_lo);
      gap = fminf(gap, fmaxf(a.bz - span, 0.0f));
    }
    if (gap > a.zcut) continue;         // the same for the whole block
    __syncthreads();                    // the previous tile is consumed
    const int j = j0 + tid;
    if (j < j1) {
      const int64_t aj = a.perm[j];
      sx[tid] = a.x[3 * aj];
      sy[tid] = a.x[3 * aj + 1];
      sz[tid] = a.x[3 * aj + 2];
      sq[tid] = a.q[aj];
      st[tid] = static_cast<int>(a.type[aj]);
      if (EXCL) sa[tid] = aj;
      if (FUSE) {
        se[tid] = a.ele_f[aj];
        sl[tid] = a.ely_f[aj];
      }
    }
    __syncthreads();
    if (!row_ok) continue;
    const int nc = j1 - j0;
    for (int c = 0; c < nc; ++c) {
      if (j0 + c == i) continue;
      const float dx = min_image(xi - sx[c], a.bx, a.ibx, a.px);
      const float dy = min_image(yi - sy[c], a.by, a.iby, a.py);
      const float dz = min_image(zi - sz[c], a.bz, a.ibz, a.pz);
      const float rsq = dx * dx + dy * dy + dz * dz;
      if (!(rsq < a.cutsq)) continue;
      const int tj = st[c];
      const float rinv = rsqrtf(rsq);
      const float r2inv = rinv * rinv;
      const float r6inv = r2inv * r2inv * r2inv;
      const float l1 = trow[tj], l2 = trow[tsz + tj];
      const float l3 = trow[2 * tsz + tj], l4 = trow[3 * tsz + tj];
      const float grij = a.g * rsq * rinv;             // g * r
      const float expm2 = expf(-grij * grij);
      const float erfc = as_poly(grij) * expm2;
      const float qq = qi * sq[c];
      const float pref = a.qqr2e * rinv * qq;
      float fpair;
      if (EXCL) {
        float sij = 1.0f;
#pragma unroll
        for (int k = 0; k < MAX_EXCL; ++k) {
          if (exj[k] == sa[c]) sij = exs[k];
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
      if (FUSE && ((ei > 0.f && sl[c] > 0.f) || (li > 0.f && se[c] > 0.f))) {
        // CONP Gaussian correction (fix_conp.cpp:1467-1573)
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
  if (row_ok) {
    a.f_out[3 * ai] = fx;
    a.f_out[3 * ai + 1] = fy;
    a.f_out[3 * ai + 2] = fz;
  }
  sred[0][tid] = ev;
  sred[1][tid] = ec;
  sred[2][tid] = ecorr;
  __syncthreads();
  for (int s = PAIR_TB / 2; s > 0; s >>= 1) {
    if (tid < s) {
      sred[0][tid] += sred[0][tid + s];
      sred[1][tid] += sred[1][tid + s];
      sred[2][tid] += sred[2][tid + s];
    }
    __syncthreads();
  }
  if (tid < 3) a.partials[3 * blockIdx.x + tid] = sred[tid][0];
}

// energies[k] = 0.5 * sum over blocks of partials[., k]: each unordered pair
// was visited from both of its atoms
__global__ void __launch_bounds__(REDUCE_TB)
reduce_energies(const float* partials, int nblocks, float* energies) {
  __shared__ float s[3][REDUCE_TB];
  const int tid = threadIdx.x;
  float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f;
  for (int b = tid; b < nblocks; b += REDUCE_TB) {
    acc0 += partials[3 * b];
    acc1 += partials[3 * b + 1];
    acc2 += partials[3 * b + 2];
  }
  s[0][tid] = acc0;
  s[1][tid] = acc1;
  s[2][tid] = acc2;
  __syncthreads();
  for (int h = REDUCE_TB / 2; h > 0; h >>= 1) {
    if (tid < h) {
      s[0][tid] += s[0][tid + h];
      s[1][tid] += s[1][tid + h];
      s[2][tid] += s[2][tid + h];
    }
    __syncthreads();
  }
  if (tid < 3) energies[tid] = 0.5f * s[tid][0];
}

}  // namespace conp2

extern "C" {

// rows per block of the pair kernel: the wrapper sizes the per-block
// energy buffer (ceil(n / rows) x 3) from it
int conp2_pair_tile_rows() { return conp2::PAIR_TB; }

// f_out (n, 3) and energies (3) = (evdwl, ecoul, ecorr) in float32;
// ele_f == NULL selects the sweep without the CONP correction (ely_f and
// gtab are then ignored and ecorr is 0); m == 0 selects the sweep without
// special-bond exclusions (exi, exv ignored).  Returns cudaGetLastError().
int conp2_pair_forces_f32(const float* x, const float* q, const int64_t* type,
                          const float* ele_f, const float* ely_f,
                          const int64_t* perm, const float* zs,
                          const float* lj, const float* gtab,
                          const int64_t* exi, const float* exv, int m, int n,
                          int nt1, float bx, float by, float bz, int px,
                          int py, int pz, float cutsq, float zcut,
                          float g_ewald, float qqr2e, float* f_out,
                          float* partials, float* energies, void* stream) {
  if (n <= 0 || nt1 <= 0 || nt1 > conp2::MAX_NT1 || m < 0 ||
      m > conp2::MAX_EXCL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  conp2::PairArgs a{x, q, type, ele_f, ely_f, perm, zs, lj, gtab, exi, exv,
                    m, n, nt1, bx, by, bz, 1.0f / bx, 1.0f / by, 1.0f / bz,
                    px, py, pz, cutsq, zcut, g_ewald, qqr2e,
                    f_out, partials};
  const int nblocks = (n + conp2::PAIR_TB - 1) / conp2::PAIR_TB;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool fuse = ele_f != nullptr;
  if (fuse && m > 0) {
    conp2::pair_kernel<true, true><<<nblocks, conp2::PAIR_TB, 0, s>>>(a);
  } else if (fuse) {
    conp2::pair_kernel<true, false><<<nblocks, conp2::PAIR_TB, 0, s>>>(a);
  } else if (m > 0) {
    conp2::pair_kernel<false, true><<<nblocks, conp2::PAIR_TB, 0, s>>>(a);
  } else {
    conp2::pair_kernel<false, false><<<nblocks, conp2::PAIR_TB, 0, s>>>(a);
  }
  conp2::reduce_energies<<<1, conp2::REDUCE_TB, 0, s>>>(partials, nblocks,
                                                        energies);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
