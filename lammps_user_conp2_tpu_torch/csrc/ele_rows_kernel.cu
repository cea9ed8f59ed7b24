// Electrode b-vector real-space rows:
//   b_i = -sum_{electrolyte j, r^2 < cut_coulsq} q_j (erfc(g r)/r + pot(r^2))
//   pot(r^2) = fo * exp(-e2/2) - erfc(sqrt(e2))/sqrt(e2) * eta,  e2 = eta^2 r^2
// (fix_conp.cpp:1281-1365 blist_coul_cal; the ETA mode is fo = 0).
//
// Replaces the TPU kernel in lammps_user_conp2_tpu/ops/pallas/ele_rows_kernel.py,
// b_realspace_pallas (body _b_kernel).
//
// What bounds it on this card: the per-pair transcendental chain -- two exp,
// two rsqrt and two A&S polynomials with their divisions per pair in range
// -- not bytes: positions, charges and the sort keys of every atom fit in
// L2.
//
// Design: the columns are z-sorted (perm, zs from ops/kernels/zorder.z_perm).
// One thread owns one electrode row and binary-searches the sorted keys for
// the column window whose z lies within sqrt(cut_coulsq) + Z_MARGIN of its
// own (three windows on a periodic z, one per image; the whole range when
// the window spans the box).  It sums over the electrolyte columns of the
// window only (the electrode columns are skipped by flag, never by
// distance) and writes b_i once.  Neighbouring electrode rows sit on the
// same lattice plane, so the threads of a warp walk the same windows.
#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace conp2 {

constexpr int B_TB = 32;          // electrode rows per block

struct BArgs {
  const float* x;          // (n, 3) original order
  const float* q;          // (n,) electrolyte charges (0 on electrodes)
  const int64_t* ele_idx;  // (ne,) electrode row -> atom index
  const float* ely_f;      // (n,) 1 = electrolyte column
  const float* eta_rows;   // (ne, nt1) Gaussian width of (row, column type)
  const float* fo_rows;    // (ne, nt1) overlap prefactor of (row, column type)
  const int64_t* type;     // (n,)
  const int64_t* perm;     // (n,) sorted position -> atom index
  const float* zs;         // (n,) sorted wrapped z keys
  int n, ne, nt1;
  float bx, by, bz, ibx, iby, ibz;
  int px, py, pz;
  float cutsq, zcut, g;
  float* b_out;            // (ne,)
};

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

__global__ void __launch_bounds__(B_TB) b_rows_kernel(BArgs a) {
  const int r = blockIdx.x * B_TB + threadIdx.x;
  if (r >= a.ne) return;
  const int64_t ai = a.ele_idx[r];
  const float xi = a.x[3 * ai], yi = a.x[3 * ai + 1], zi = a.x[3 * ai + 2];
  const float* eta = a.eta_rows + static_cast<int64_t>(r) * a.nt1;
  const float* fov = a.fo_rows + static_cast<int64_t>(r) * a.nt1;
  const float zw = a.pz ? zi - a.bz * floorf(zi * a.ibz) : zi;

  float wlo[3], whi[3];
  int nwin = 1;
  wlo[0] = zw - a.zcut;
  whi[0] = zw + a.zcut;
  if (a.pz) {
    if (2.0f * a.zcut >= a.bz) {
      wlo[0] = -INFINITY;
      whi[0] = INFINITY;
    } else {
      nwin = 3;
      wlo[1] = wlo[0] + a.bz;
      whi[1] = whi[0] + a.bz;
      wlo[2] = wlo[0] - a.bz;
      whi[2] = whi[0] - a.bz;
    }
  }
  const float g = a.g;
  float acc = 0.f;
  for (int w = 0; w < nwin; ++w) {
    const int lo = search(a.zs, a.n, wlo[w], false);
    const int hi = search(a.zs, a.n, whi[w], true);
    for (int k = lo; k < hi; ++k) {
      const int64_t aj = a.perm[k];
      if (!(a.ely_f[aj] > 0.f)) continue;
      const float dx = min_image(xi - a.x[3 * aj], a.bx, a.ibx, a.px);
      const float dy = min_image(yi - a.x[3 * aj + 1], a.by, a.iby, a.py);
      const float dz = min_image(zi - a.x[3 * aj + 2], a.bz, a.ibz, a.pz);
      const float rsq = dx * dx + dy * dy + dz * dz;
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
  a.b_out[r] = acc;
}

}  // namespace conp2

extern "C" {

// b_out (ne,) float32.  Returns cudaGetLastError().
int conp2_b_realspace_f32(const float* x, const float* q_elyte,
                          const int64_t* ele_idx, const float* ely_f,
                          const float* eta_rows, const float* fo_rows,
                          const int64_t* type, const int64_t* perm,
                          const float* zs, int n, int ne, int nt1,
                          float bx, float by, float bz, int px, int py, int pz,
                          float cutsq, float zcut, float g_ewald, float* b_out,
                          void* stream) {
  if (n <= 0 || ne <= 0 || nt1 <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  conp2::BArgs a{x, q_elyte, ele_idx, ely_f, eta_rows, fo_rows, type, perm,
                 zs, n, ne, nt1, bx, by, bz, 1.0f / bx, 1.0f / by, 1.0f / bz,
                 px, py, pz, cutsq, zcut, g_ewald, b_out};
  const int nblocks = (ne + conp2::B_TB - 1) / conp2::B_TB;
  conp2::b_rows_kernel<<<nblocks, conp2::B_TB, 0,
                         static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
