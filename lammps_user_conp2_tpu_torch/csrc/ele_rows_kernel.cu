// The electrode-row sweeps: the b-vector real-space rows (K5) and the CONP
// Gaussian correction swept on its own (K6).
//
// K5, electrode b-vector real-space rows:
//   b_i = -sum_{electrolyte j, r^2 < cut_coulsq} q_j (erfc(g r)/r + pot(r^2))
//   pot(r^2) = fo * exp(-e2/2) - erfc(sqrt(e2))/sqrt(e2) * eta,  e2 = eta^2 r^2
// (fix_conp.cpp:1281-1365 blist_coul_cal; the ETA mode is fo = 0).
//
// Replaces the TPU kernel in lammps_user_conp2_tpu/ops/pallas/ele_rows_kernel.py,
// b_realspace_pallas (body _b_kernel).
//
// What bounds it on this card: the per-pair transcendental chain -- two exp,
// two rsqrt and two A&S polynomials with their divisions per pair in range
// -- and the dependent loads of each column (its atom index, then its
// position, charge and type), not bytes: positions, charges and the sort
// keys of every atom fit in L2.
//
// Design: K6's pass 1.  One warp owns one electrode row (B_WARPS rows per
// CTA: the 1,152 rows of the 7,296-atom cell make 144 CTAs on 132 SMs, a
// thread per row made 36 single-warp CTAs).  The columns are the
// electrolyte alone, by order, not by a flag: a first kernel (b_order, one
// CTA) compacts the step's shared z order (zorder.z_perm) to its
// electrolyte atoms, stably, by a fixed-order block scan over the flags,
// and writes their count to the device, so a window never holds an
// electrode column (64% of the window columns at 7,296 atoms, 92% on the
// ionic-liquid cell were electrodes skipped by flag), whatever the atoms'
// layout, with no second sort and no host sync.  The warp binary-searches
// that order for the z window within sqrt(cut_coulsq) + Z_MARGIN of its row
// (three windows on a periodic z, one per image; the whole range when the
// window spans the box), its lanes stride over the window's columns, and a
// fixed-order warp sum forms b_i, written once.  |d|^2 is formed as the plain version forms it, to the
// bit (common.cuh min_image_rn, rsq_rn).
//
// K6, the Gaussian correction over (electrode i, electrolyte j) pairs with
// r < cutoff (fix_conp.cpp:1368-1444 blist_coul_cal_post_force):
//   e_ij = qqr2e q_i q_j (fo exp(-e2/2) - erfcr(e2) eta)
//   F_ij = qqr2e q_i q_j (e2 fo exp(-e2/2) - ferfcr(e2) eta) / r^2 * d_ij
// with eta, fo from the (T+1)^2 type tables at (type_i, type_j).
//
// Replaces the TPU kernel in lammps_user_conp2_tpu/ops/pallas/ele_rows_kernel.py,
// conp_correction_pallas (body _corr_kernel), which the JAX engine runs when
// the pair sweep does not fuse the correction.
//
// What bounds it on this card: finding the pairs, not evaluating them.  With
// the ETA widths (fo = 0) a term is exactly 0 once eta^2 r^2 >= ERFC_MAX^2:
// at the ionic-liquid decks' eta, beyond 2.93 A of a 16 A cutoff, and most
// of an electrode row's 16 A z window is its electrode's own sheets.  The
// pairs that remain sit in L2 and take a few microseconds.
//
// Design: deterministic, no atomics, each row written once.  The
// wrapper passes the correction's own range r_corr (ele_rows_kernel.py
// correction_range: min(cutoff, ERFC_MAX / eta_min) with a 1e-5 margin when
// every electrode x electrolyte fo is 0, else the cutoff), which sets the z
// windows and the pair test; the kernel's ERFC_MAX gate is unchanged, so a
// pair left out is a pair whose terms are exactly 0.  A first kernel (one
// CTA, K5's fixed-order block scan run twice) compacts the step's shared z
// order (zorder.z_perm) into the electrolyte's and the electrodes' z
// orders, with their counts on the device, so no pass reads a column it
// then drops.  Pass 1: a warp per electrode row binary-searches its z
// windows in the electrolyte order (three on a periodic z, one per image),
// its lanes stride over them, a fixed-order warp shuffle sums the row's
// force, written once, and its energy goes to a per-block sum (fixed-order
// tree) reduced by a one-block last kernel.  Pass 2: a warp per
// electrolyte atom of the electrolyte order over its windows in the
// electrode order, writing the reactions once.  Both passes form each pair
// term from the electrode's side, op for op (d = x_ele - x_ely with the
// plain version's minimum image and |d|^2, common.cuh rsq_rn), so both
// sides of a pair are the same numbers.
#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace conp2 {

constexpr int B_WARPS = 8;        // electrode rows (one warp each) per CTA
constexpr int B_TB = 32 * B_WARPS;
constexpr int ORD_TB = 1024;      // the one CTA of b_order
constexpr int ORD_ITEMS = 4;      // consecutive sorted positions per thread
static_assert(ORD_TB == 32 * 32, "b_order scans 32 warp totals in one warp");

// first sorted position with zs[k] >= v (upper = false) or zs[k] > v
__device__ __forceinline__ int search(const float* zs, int n, float v,
                                      bool upper) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const float z = zs[mid];
    if (upper ? (z <= v) : (z < v)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// the z windows of a row at z in n sorted keys: [lo, hi) ranges, up to 3
// (one per image on a periodic z; the whole range when 2 zcut spans it)
__device__ __forceinline__ int z_windows(const float* zs, int n, float z,
                                         float bz, float ibz, int pz,
                                         float zcut, int* lo, int* hi) {
  const float zw = pz ? z - bz * floorf(z * ibz) : z;
  float wl[3], wh[3];
  int nwin = 1;
  wl[0] = zw - zcut;
  wh[0] = zw + zcut;
  if (pz) {
    if (2.0f * zcut >= bz) {
      wl[0] = -INFINITY;
      wh[0] = INFINITY;
    } else {
      nwin = 3;
      wl[1] = wl[0] + bz;
      wh[1] = wh[0] + bz;
      wl[2] = wl[0] - bz;
      wh[2] = wh[0] - bz;
    }
  }
  for (int w = 0; w < nwin; ++w) {
    lo[w] = search(zs, n, wl[w], false);
    hi[w] = search(zs, n, wh[w], true);
  }
  return nwin;
}

struct BArgs {
  const float* x;          // (n, 3) original order
  const float* q;          // (n,) electrolyte charges (0 on electrodes)
  const int64_t* ele_idx;  // (ne,) electrode row -> atom index
  const float* eta_rows;   // (ne, nt1) Gaussian width of (row, column type)
  const float* fo_rows;    // (ne, nt1) overlap prefactor of (row, column type)
  const int64_t* type;     // (n,)
  const int* perm;         // the electrolyte's atoms in z order (the first
  const float* zs;         // *ncols entries) and their sorted z keys
  const int* ncols;        // (1,) their count, written on the device
  int ne, nt1;
  float bx, by, bz, ibx, iby, ibz;
  int px, py, pz;
  float cutsq, zcut, g;
  float* b_out;            // (ne,)
};

// the entries of the full z order (perm, zs) whose atom has flag > 0, in
// the same order, into (cperm, czs), and their count into *ncols; run by
// one whole CTA of ORD_TB threads.  Chunks of ORD_TB * ORD_ITEMS sorted
// positions; thread t takes ORD_ITEMS consecutive ones, and a fixed-order
// block scan (warp shuffles, then the warp totals) places each kept entry.
__device__ __forceinline__ void compact_order(const int64_t* perm,
                                              const float* zs,
                                              const float* flag, int n,
                                              int* cperm, float* czs,
                                              int* ncols) {
  __shared__ int wofs[ORD_TB / 32];
  __shared__ int chunk_total;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wid = tid >> 5;
  int base = 0;
  for (int c0 = 0; c0 < n; c0 += ORD_TB * ORD_ITEMS) {
    const int k0 = c0 + tid * ORD_ITEMS;
    int atom[ORD_ITEMS];
    unsigned keep = 0u;
    for (int i = 0; i < ORD_ITEMS; ++i) {
      atom[i] = 0;
      if (k0 + i < n) {
        atom[i] = static_cast<int>(perm[k0 + i]);
        if (flag[atom[i]] > 0.f) keep |= 1u << i;
      }
    }
    const int cnt = __popc(keep);
    int inc = cnt;                          // inclusive scan over the warp
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, inc, o);
      if (lane >= o) inc += v;
    }
    if (lane == 31) wofs[wid] = inc;
    __syncthreads();
    if (wid == 0) {                         // scan of the 32 warp totals
      const int w = wofs[lane];
      int winc = w;
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, winc, o);
        if (lane >= o) winc += v;
      }
      wofs[lane] = winc - w;
      if (lane == 31) chunk_total = winc;
    }
    __syncthreads();
    int pos = base + wofs[wid] + inc - cnt;
    for (int i = 0; i < ORD_ITEMS; ++i) {
      if (keep & (1u << i)) {
        cperm[pos] = atom[i];
        czs[pos] = zs[k0 + i];
        ++pos;
      }
    }
    base += chunk_total;
    __syncthreads();                        // wofs, chunk_total reused
  }
  if (tid == 0) *ncols = base;
}

// one CTA: the electrolyte's z order (K5's columns)
__global__ void __launch_bounds__(ORD_TB)
b_order_kernel(const int64_t* perm, const float* zs, const float* ely_f,
               int n, int* cperm, float* czs, int* ncols) {
  compact_order(perm, zs, ely_f, n, cperm, czs, ncols);
}

__global__ void __launch_bounds__(B_TB) b_rows_kernel(BArgs a) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * B_WARPS + (threadIdx.x >> 5);
  if (r >= a.ne) return;                 // warp-uniform
  const int64_t ai = a.ele_idx[r];
  const float xi = a.x[3 * ai], yi = a.x[3 * ai + 1], zi = a.x[3 * ai + 2];
  const float* eta = a.eta_rows + static_cast<int64_t>(r) * a.nt1;
  const float* fov = a.fo_rows + static_cast<int64_t>(r) * a.nt1;
  int lo[3], hi[3];
  const int nwin = z_windows(a.zs, *a.ncols, zi, a.bz, a.ibz, a.pz, a.zcut,
                             lo, hi);
  const float g = a.g;
  float acc = 0.f;
  for (int w = 0; w < nwin; ++w) {
    for (int k = lo[w] + lane; k < hi[w]; k += 32) {
      const int aj = a.perm[k];
      const float dx = min_image_rn(__fsub_rn(xi, a.x[3 * aj]), a.bx,
                                    a.ibx, a.px);
      const float dy = min_image_rn(__fsub_rn(yi, a.x[3 * aj + 1]), a.by,
                                    a.iby, a.py);
      const float dz = min_image_rn(__fsub_rn(zi, a.x[3 * aj + 2]), a.bz,
                                    a.ibz, a.pz);
      const float rsq = rsq_rn(dx, dy, dz);
      if (!(rsq < a.cutsq)) continue;
      const int tj = static_cast<int>(a.type[aj]);
      const float et = eta[tj];
      const float fo = fov[tj];
      const float e2 = et * et * rsq;
      const float ghalf = expf(-0.5f * e2);
      const float ek = fo * ghalf - erfcr_clamped(e2, ghalf * ghalf) * et;
      const float u = g * g * rsq;
      const float dudq = erfcr_clamped(u, expf(-fmaxf(u, 1e-30f))) * g + ek;
      acc -= dudq * a.q[aj];
    }
  }
  acc = warp_sum(acc);
  if (lane == 0) a.b_out[r] = acc;
}

constexpr int C_WARPS = 8;        // rows (one warp each) per block of K6
constexpr int C_TB = 32 * C_WARPS;
constexpr int C_REDUCE_TB = 256;

struct CorrArgs {
  const float* x;          // (n, 3) original order
  const float* q;          // (n,)
  const int64_t* type;     // (n,)
  const int64_t* ele_idx;  // (ne,) electrode row -> atom index
  const float* gtab;       // (2, nt1, nt1) eta, fo
  const int* ely_perm;     // the electrolyte's atoms in z order (the first
  const float* ely_zs;     // *ely_n entries) and their sorted z keys
  const int* ely_n;
  const int* ele_perm;     // the electrodes' atoms in z order (the first
  const float* ele_zs;     // *ele_n entries) and their sorted z keys
  const int* ele_n;
  int ne, nt1;
  float bx, by, bz, ibx, iby, ibz;
  int px, py, pz;
  float cutsq, zcut, qqr2e;  // the correction's range r_corr, squared
  float* f_out;            // (n, 3) original order
  float* partials;         // (ceil(ne / C_WARPS),) per-block energy sums
};

// one CTA: the electrolyte's and the electrodes' z orders, both from the
// step's shared z order (perm, zs), one after the other
__global__ void __launch_bounds__(ORD_TB)
corr_order_kernel(const int64_t* perm, const float* zs, const float* ely_f,
                  const float* ele_f, int n, int* order) {
  compact_order(perm, zs, ely_f, n, order, reinterpret_cast<float*>(order + n),
                order + 4 * n);
  compact_order(perm, zs, ele_f, n, order + 2 * n,
                reinterpret_cast<float*>(order + 3 * n), order + 4 * n + 1);
}

// one (electrode e, electrolyte l) pair from the electrode's side: adds
// F_el to f (the force on e; -F_el acts on l) and e_el to en when r is
// within the correction's range
__device__ __forceinline__ void corr_pair(const CorrArgs& a, int ae, int al,
                                          float* f, float* en) {
  const float dx = min_image_rn(__fsub_rn(a.x[3 * ae], a.x[3 * al]), a.bx,
                                a.ibx, a.px);
  const float dy = min_image_rn(__fsub_rn(a.x[3 * ae + 1], a.x[3 * al + 1]),
                                a.by, a.iby, a.py);
  const float dz = min_image_rn(__fsub_rn(a.x[3 * ae + 2], a.x[3 * al + 2]),
                                a.bz, a.ibz, a.pz);
  const float rsq = rsq_rn(dx, dy, dz);
  if (!(rsq < a.cutsq)) return;
  const int t = static_cast<int>(a.type[ae]) * a.nt1 +
                static_cast<int>(a.type[al]);
  const float et = a.gtab[t];
  const float fo = a.gtab[a.nt1 * a.nt1 + t];
  const float e2 = et * et * rsq;
  const float ghalf = expf(-0.5f * e2);
  const float em2 = ghalf * ghalf;                   // exp(-e2)
  const float erfcr = erfcr_clamped(e2, em2);
  const float gexp = fo * ghalf;
  const float ferfcr = e2 < ERFC_MAX_SQ ? erfcr + EWALD_F * em2 : 0.f;
  const float pref = a.qqr2e * a.q[ae] * a.q[al];
  *en += pref * (gexp - erfcr * et);
  const float fpair = pref * (e2 * gexp - ferfcr * et) / rsq;
  f[0] += fpair * dx;
  f[1] += fpair * dy;
  f[2] += fpair * dz;
}

// pass 1: a warp per electrode row over the electrolyte columns of its z
// windows
__global__ void __launch_bounds__(C_TB) corr_ele_kernel(CorrArgs a) {
  __shared__ float sred[C_WARPS];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int r = blockIdx.x * C_WARPS + w;
  float f[3] = {0.f, 0.f, 0.f};
  float en = 0.f;
  int ae = 0;
  if (r < a.ne) {
    ae = static_cast<int>(a.ele_idx[r]);
    int lo[3], hi[3];
    const int nwin = z_windows(a.ely_zs, *a.ely_n, a.x[3 * ae + 2], a.bz,
                               a.ibz, a.pz, a.zcut, lo, hi);
    for (int win = 0; win < nwin; ++win) {
      for (int k = lo[win] + lane; k < hi[win]; k += 32) {
        corr_pair(a, ae, a.ely_perm[k], f, &en);
      }
    }
  }
  f[0] = warp_sum(f[0]);
  f[1] = warp_sum(f[1]);
  f[2] = warp_sum(f[2]);
  en = warp_sum(en);
  if (lane == 0) {
    if (r < a.ne) {
      a.f_out[3 * ae] = f[0];
      a.f_out[3 * ae + 1] = f[1];
      a.f_out[3 * ae + 2] = f[2];
    }
    sred[w] = en;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float acc = 0.f;
    for (int k = 0; k < C_WARPS; ++k) acc += sred[k];
    a.partials[blockIdx.x] = acc;
  }
}

// pass 2: a warp per electrolyte atom (in z order) over the electrode
// columns of its z windows, the reactions of pass 1's pair terms
__global__ void __launch_bounds__(C_TB) corr_ely_kernel(CorrArgs a) {
  const int lane = threadIdx.x & 31;
  const int k0 = blockIdx.x * C_WARPS + (threadIdx.x >> 5);
  if (k0 >= *a.ely_n) return;            // warp-uniform
  const int al = a.ely_perm[k0];
  float f[3] = {0.f, 0.f, 0.f};
  float en = 0.f;
  int lo[3], hi[3];
  const int nwin = z_windows(a.ele_zs, *a.ele_n, a.x[3 * al + 2], a.bz,
                             a.ibz, a.pz, a.zcut, lo, hi);
  for (int win = 0; win < nwin; ++win) {
    for (int k = lo[win] + lane; k < hi[win]; k += 32) {
      corr_pair(a, a.ele_perm[k], al, f, &en);
    }
  }
  f[0] = warp_sum(f[0]);
  f[1] = warp_sum(f[1]);
  f[2] = warp_sum(f[2]);
  if (lane == 0) {
    a.f_out[3 * al] = -f[0];
    a.f_out[3 * al + 1] = -f[1];
    a.f_out[3 * al + 2] = -f[2];
  }
}

// *ecorr = sum of the per-block energies, fixed order
__global__ void __launch_bounds__(C_REDUCE_TB)
corr_reduce(const float* partials, int nblocks, float* ecorr) {
  __shared__ float s[C_REDUCE_TB];
  float acc = 0.f;
  for (int b = threadIdx.x; b < nblocks; b += C_REDUCE_TB) acc += partials[b];
  s[threadIdx.x] = acc;
  __syncthreads();
  for (int h = C_REDUCE_TB / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) s[threadIdx.x] += s[threadIdx.x + h];
    __syncthreads();
  }
  if (threadIdx.x == 0) *ecorr = s[0];
}

}  // namespace conp2

extern "C" {

// rows per block of the K6 passes: the wrapper sizes the per-block energy
// buffer (ceil(ne / rows)) from it
int conp2_corr_rows() { return conp2::C_WARPS; }

// f_out (n, 3) (rows neither electrode nor electrolyte are left as they
// are: the caller zeroes f_out) and ecorr (1) in float32, over the pairs
// with r^2 < cutsq, the correction's range; order is the workspace of the
// two z orders (4n + 2 int32), partials the per-block energies
// (ceil(ne / conp2_corr_rows())).  Returns cudaGetLastError().
int conp2_conp_correction_f32(const float* x, const float* q,
                              const int64_t* type, const int64_t* ele_idx,
                              const float* ele_f, const float* ely_f,
                              const float* gtab, const int64_t* perm,
                              const float* zs, int n, int ne, int nt1,
                              float bx, float by, float bz, int px, int py,
                              int pz, float cutsq, float zcut, float qqr2e,
                              int* order, float* f_out, float* partials,
                              float* ecorr, void* stream) {
  if (n <= 0 || ne <= 0 || nt1 <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  conp2::corr_order_kernel<<<1, conp2::ORD_TB, 0, s>>>(perm, zs, ely_f,
                                                       ele_f, n, order);
  float* ordf = reinterpret_cast<float*>(order);
  conp2::CorrArgs a{x, q, type, ele_idx, gtab, order, ordf + n, order + 4 * n,
                    order + 2 * n, ordf + 3 * n, order + 4 * n + 1, ne, nt1,
                    bx, by, bz, 1.0f / bx, 1.0f / by, 1.0f / bz, px, py, pz,
                    cutsq, zcut, qqr2e, f_out, partials};
  const int nb_e = (ne + conp2::C_WARPS - 1) / conp2::C_WARPS;
  const int nb_a = (n + conp2::C_WARPS - 1) / conp2::C_WARPS;
  conp2::corr_ele_kernel<<<nb_e, conp2::C_TB, 0, s>>>(a);
  conp2::corr_ely_kernel<<<nb_a, conp2::C_TB, 0, s>>>(a);
  conp2::corr_reduce<<<1, conp2::C_REDUCE_TB, 0, s>>>(partials, nb_e, ecorr);
  return static_cast<int>(cudaGetLastError());
}

// the two z orders of K6 alone (its first kernel) into order (4n + 2
// int32: the electrolyte's atom indices and keys, the electrodes' atom
// indices and keys, the two counts).  Returns cudaGetLastError().
int conp2_corr_order_i32(const int64_t* perm, const float* zs,
                         const float* ely_f, const float* ele_f, int n,
                         int* order, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  conp2::corr_order_kernel<<<1, conp2::ORD_TB, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      perm, zs, ely_f, ele_f, n, order);
  return static_cast<int>(cudaGetLastError());
}

// the electrolyte's z order alone (K5's first kernel) into
// order (2n + 1 int32: the atom indices, the keys as float32, the count).
// Returns cudaGetLastError().
int conp2_b_order_i32(const int64_t* perm, const float* zs,
                      const float* ely_f, int n, int* order, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  conp2::b_order_kernel<<<1, conp2::ORD_TB, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      perm, zs, ely_f, n, order, reinterpret_cast<float*>(order + n),
      order + 2 * n);
  return static_cast<int>(cudaGetLastError());
}

// b_out (ne,) float32 over the electrolyte columns (ely_f > 0) of the full
// z order (perm, zs), which b_order_kernel compacts into the workspace
// order (2n + 1 int32) first.  Returns cudaGetLastError().
int conp2_b_realspace_f32(const float* x, const float* q_elyte,
                          const int64_t* ele_idx, const float* ely_f,
                          const float* eta_rows, const float* fo_rows,
                          const int64_t* type, const int64_t* perm,
                          const float* zs, int n, int ne, int nt1, float bx,
                          float by, float bz, int px, int py, int pz,
                          float cutsq, float zcut, float g_ewald, int* order,
                          float* b_out, void* stream) {
  if (n <= 0 || ne <= 0 || nt1 <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* czs = reinterpret_cast<float*>(order + n);
  conp2::b_order_kernel<<<1, conp2::ORD_TB, 0, s>>>(perm, zs, ely_f, n,
                                                    order, czs, order + 2 * n);
  conp2::BArgs a{x, q_elyte, ele_idx, eta_rows, fo_rows, type, order, czs,
                 order + 2 * n, ne, nt1, bx, by, bz, 1.0f / bx, 1.0f / by,
                 1.0f / bz, px, py, pz, cutsq, zcut, g_ewald, b_out};
  const int nblocks = (ne + conp2::B_WARPS - 1) / conp2::B_WARPS;
  conp2::b_rows_kernel<<<nblocks, conp2::B_TB, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
