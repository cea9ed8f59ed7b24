// Block-union Verlet pair sweep (K1): LJ 12-6 + erfc real-space Coulomb for
// every block atom against the sorted-unique union of its block's neighbour
// rows, with the CONP Gaussian correction for (electrode, electrolyte) pairs
// fused in as an option.
//
// Replaces the TPU kernel in lammps_user_conp2_tpu/ops/pallas/block_pair.py,
// block_pair_pallas (body _kernel).
//
// What bounds it on this card: issue slots.  Every (block atom, union
// member) pair is tested (d and |d|^2), and only ~12% of them lie inside
// the cutoff at the 100k cell, where each runs the transcendental chain
// (rsqrt, exp, the A&S polynomial with its division; a second chain on
// correction pairs).  The bytes (union ids and the rows they name) are a
// few tens of MB from L2.
//
// Design (three or four launches in one wrapper call):
//  1. block_pack_kernel writes one 32-byte row per atom: (x, y, z, q) as a
//     float4, then (type, flag, 0, 0) as ints, flag = +1 electrode / -1
//     electrolyte / 0.  A union member is then two 16-byte loads from one
//     sector instead of five scattered arrays.
//  2. block_sweep_kernel: persistent warps, as many CTAs as are resident,
//     each warp taking work items in turn (the next item's ids read while
//     one is swept), an item being a block of B = 8 atoms and a segment of
//     its union (`seg` chunks of 32 members; the whole union where blocks
//     alone fill the card, several segments where they do not).  Two
//     phases per chunk:
//       test: each lane loads one member's packed row and forms d and
//         |d|^2 against the 8 block atoms (unrolled), op for op as the
//         plain version does (rsq_rn; the minimum image skipped where the
//         whole chunk lies within 0.45 L of the block's box, where it is
//         the identity, and otherwise image() below), and the in-range
//         pairs are written to a per-warp queue in shared memory as
//         (atom id, block atom), in a fixed order (chunk, lane, block
//         atom; a warp scan of the lanes' counts places them);
//       chain: whenever the queue holds 32 pairs, the warp evaluates them
//         with every lane busy (d formed again, to the same bits; LJ +
//         erfc, the pair's special-bond factor from its block atom's
//         partner list in shared memory, the fused correction when any
//         lane of the batch holds an (electrode, electrolyte) pair), and
//         the rest waits for the next chunk.
//     Each lane adds its pair's force to its own column of the warp's
//     per-(atom, lane) partials in shared memory (no atomics); at the end
//     the 24 (atom, axis) sums are taken over the 32 lanes in a fixed
//     order and written once.  Energies are summed per lane over the
//     warp's items, then by a fixed butterfly, then over the CTA's warps
//     in order (the CTA count, and so the order, follows from the card's
//     occupancy at the launch's shared memory: one order per card and
//     shape).  The next chunk's ids and rows are read while a chunk is
//     swept.
//  3. block_force_reduce (only with several segments per block) sums the
//     segments' partial forces in segment order.
//  4. block_pair_reduce sums the per-CTA energy sums in one CTA of 768
//     threads, in a fixed order: raw sums over ordered pairs (the caller
//     halves).
// Pad ids (n) are masked by index, never by sentinel coordinates.
//
// Special-bond exclusions (bonded systems) are applied per pair, as in the
// pair kernel (pair_kernel.cu) and the plain version: a listed pair gets
// s * LJ and the Coulomb term minus (1 - s) * qq/r; a pair with s = 0
// still subtracts qq/r.  Sweeping the excluded pairs at s = 1 and
// subtracting them afterwards (the TPU kernel's way) cancels
// catastrophically in float32 at bonded distances.
#include <cstdint>

#include "common.cuh"

namespace conp2 {

constexpr int BP_B = 8;           // block atoms
constexpr int BP_WPC = 4;         // warps (independent work items) per CTA
constexpr int BP_TB = 32 * BP_WPC;
constexpr int BP_QCAP = 288;      // pair queue entries per warp (31 + 8 * 32)
constexpr int BP_MAX_NT1 = 16;    // type tables up to 16 x 16
constexpr int BP_REDUCE_TB = 256;
constexpr int BP_MAX_EXCL = 16;   // listed special partners per atom
constexpr int BP_EXST = 17;       // padded stride of the partner lists
constexpr int BP_PACK_TB = 256;

struct BlockArgs {
  const float4* pk;        // (n, 2) packed rows: (x, y, z, q), (type, flag)
  const int* un;           // (nb, U) union ids, pad n
  const int64_t* rows;     // (nb, B) block atom ids, pad n
  const float* lj;         // (4, nt1, nt1)
  const float* gtab;       // (2, nt1, nt1) eta, fo (fused correction only)
  const int64_t* exi;      // (n, m) special partners, padded with n
  const float* exv;        // (n, m) their factors s
  int m;                   // 0: no exclusions
  int n, nb, usz, nt1;
  int seg, nseg;           // union chunks per item, items per block
  float bx, by, bz, ibx, iby, ibz;
  int px, py, pz;
  float cutsq, g, qqr2e;
  int fast;                // cutoff <= BP_FAST_FRAC * L on periodic axes
  float* f_out;            // (nb * B, 3) slot order (nseg == 1)
  float* part_f;           // (nb * nseg, B * 3) per-item forces (nseg > 1)
  float* partials;         // (CTAs, 3) per-CTA energy sums
};

__global__ void __launch_bounds__(BP_PACK_TB)
block_pack_kernel(const float* x, const float* q, const int64_t* type,
                  const float* ele_f, const float* ely_f, int n, float4* pk) {
  const int i = blockIdx.x * BP_PACK_TB + threadIdx.x;
  if (i >= n) return;
  int flag = 0;
  if (ele_f != nullptr) {
    // the sign of ele_f - ely_f: the product of two flags is negative
    // exactly where the plain version's product of differences is
    const float fl = ele_f[i] - ely_f[i];
    flag = (fl > 0.f) - (fl < 0.f);
  }
  pk[2 * i] = make_float4(x[3 * i], x[3 * i + 1], x[3 * i + 2], q[i]);
  pk[2 * i + 1] = make_float4(__int_as_float(static_cast<int>(type[i])),
                              __int_as_float(flag), 0.f, 0.f);
}

// d - L * round(d / L) in one of three forms that agree on every pair
// within the cutoff (the only pairs the sweep keeps):
//   MI_NONE  d itself, where the caller has checked that |d| < 0.45 L on
//            every periodic axis (round(d / L) is then 0 in every form);
//   MI_FAST  k = rint(d * (1/L)), where cutoff <= BP_FAST_FRAC * L on every
//            periodic axis: k differs from min_image_rn's only within 1e-5
//            of a half-integer quotient, where both images are ~L/2 long
//            and so outside the cutoff;
//   MI_EXACT min_image_rn (common.cuh).
constexpr int MI_NONE = 0, MI_FAST = 1, MI_EXACT = 2;
constexpr float BP_FAST_FRAC = 0.45f;

template <int MI>
__device__ __forceinline__ float image(float d, float len, float inv_len,
                                       int periodic) {
  if (MI == MI_NONE || !periodic) return d;
  if (MI == MI_FAST) {
    return __fsub_rn(d, __fmul_rn(len, rintf(__fmul_rn(d, inv_len))));
  }
  return min_image_rn(d, len, inv_len, periodic);
}

// the per-warp pieces of the dynamic shared memory
struct WarpSmem {
  float4* axq;     // (B) block atoms' x, y, z and the bits of their id
                   // (-1: pad), the one load of the test
  int4* atf;       // (B) block atoms' type, flag and the bits of q
  float* facc;     // (3, B, 32) per-(axis, atom, lane) force partials
  int* queue;      // (BP_QCAP) queued pairs, j << 3 | b
  int* exj;        // (B, BP_EXST) special partners
  float* exs;      // (B, BP_EXST) their factors
};

// d = x_i - x_j between block atom b and atom j, imaged, as the test formed
// it: every form agrees there, so the fast one where it applies
template <int MI>
__device__ __forceinline__ void pair_d(const BlockArgs& a, float4 xi,
                                       float4 xj, float& dx, float& dy,
                                       float& dz) {
  dx = image<MI>(__fsub_rn(xi.x, xj.x), a.bx, a.ibx, a.px);
  dy = image<MI>(__fsub_rn(xi.y, xj.y), a.by, a.iby, a.py);
  dz = image<MI>(__fsub_rn(xi.z, xj.z), a.bz, a.ibz, a.pz);
}

// Bit b set: member j (position xj) lies within the cutoff of block atom b
// and is not that atom.
template <int MI>
__device__ __forceinline__ unsigned test_block(const BlockArgs& a,
                                               const WarpSmem& s, float4 xj,
                                               int j) {
  unsigned m = 0u;
#pragma unroll
  for (int b = 0; b < BP_B; ++b) {
    const float4 xi = s.axq[b];
    float dx, dy, dz;
    pair_d<MI>(a, xi, xj, dx, dy, dz);
    const bool in = rsq_rn(dx, dy, dz) < a.cutsq && __float_as_int(xi.w) != j;
    m |= in ? 1u << b : 0u;
  }
  return m;
}

// Evaluate one batch of the queue: lane `lane` takes entry `e` when
// `active`.  Every lane of the warp calls it.
template <bool FUSE, bool EXCL>
__device__ __forceinline__ void chain_batch(
    const BlockArgs& a, const WarpSmem& s, const float* s_tab, int lane,
    int e, bool active, float& ev, float& ec, float& ecorr) {
  const int nt1 = a.nt1;
  const int tsz = nt1 * nt1;
  float dx = 0.f, dy = 0.f, dz = 0.f, fpair = 0.f, qq = 0.f, rsq = 1.f;
  float r2inv = 1.f;
  int b = 0, fli = 0, flj = 0, tj = 0;
  const float* trow = s_tab;
  if (active) {
    const int jb = s.queue[e];
    const int j = jb >> 3;
    b = jb & 7;
    const float4 xj = a.pk[2 * j];
    const float4 rj = a.pk[2 * j + 1];
    const float4 xi = s.axq[b];
    if (a.fast) {
      pair_d<MI_FAST>(a, xi, xj, dx, dy, dz);
    } else {
      pair_d<MI_EXACT>(a, xi, xj, dx, dy, dz);
    }
    tj = __float_as_int(rj.x);
    flj = __float_as_int(rj.y);
    const int4 ti = s.atf[b];
    fli = ti.y;
    trow = s_tab + ti.x * nt1;
    rsq = rsq_rn(dx, dy, dz);
    const float rinv = rsqrtf(rsq);
    r2inv = rinv * rinv;
    const float r6inv = r2inv * r2inv * r2inv;
    const float l1 = trow[tj], l2 = trow[tsz + tj];
    const float l3 = trow[2 * tsz + tj], l4 = trow[3 * tsz + tj];
    const float grij = a.g * rsq * rinv;               // g * r
    const float expm2 = expf(-grij * grij);
    const float erfc = as_poly(grij) * expm2;
    qq = __int_as_float(ti.z) * xj.w;
    const float pref = a.qqr2e * rinv * qq;
    if (EXCL) {
      float sij = 1.0f;
      const int* pj = s.exj + b * BP_EXST;
      const float* ps = s.exs + b * BP_EXST;
      for (int k = 0; k < a.m; ++k) {
        if (pj[k] == j) sij = ps[k];
      }
      float flj_ = 0.0f;
      if (sij > 0.0f) {
        flj_ = sij * r6inv * (l1 * r6inv - l2) * r2inv;
        ev += sij * r6inv * (l3 * r6inv - l4);
      }
      const float dcoul = (1.0f - sij) * pref;
      ec += pref * erfc - dcoul;
      fpair = flj_ + (pref * (erfc + EWALD_F * grij * expm2) - dcoul) * r2inv;
    } else {
      const float flj_ = r6inv * (l1 * r6inv - l2) * r2inv;
      ev += r6inv * (l3 * r6inv - l4);
      ec += pref * erfc;
      fpair = flj_ + pref * (erfc + EWALD_F * grij * expm2) * r2inv;
    }
  }
  if (FUSE) {
    const bool cp = active && fli * flj < 0;
    if (__any_sync(0xffffffffu, cp) && cp) {
      // CONP Gaussian correction (fix_conp.cpp:1368-1444)
      const float et = trow[4 * tsz + tj];
      const float fo = trow[5 * tsz + tj];
      const float e2 = et * et * rsq;
      const float ghalf = expf(-0.5f * e2);
      const float em2 = ghalf * ghalf;                 // exp(-e2)
      const float erfcr = erfcr_clamped(e2, em2);
      const float gexp = fo * ghalf;
      const float ferfcr = e2 < ERFC_MAX_SQ ? erfcr + EWALD_F * em2 : 0.f;
      const float cpref = a.qqr2e * qq;
      ecorr += cpref * (gexp - erfcr * et);
      fpair += cpref * (e2 * gexp - ferfcr * et) * r2inv;
    }
  }
  if (active) {
    // lane-owned column: bank = lane, no conflicts, no atomics
    s.facc[(0 * BP_B + b) * 32 + lane] += fpair * dx;
    s.facc[(1 * BP_B + b) * 32 + lane] += fpair * dy;
    s.facc[(2 * BP_B + b) * 32 + lane] += fpair * dz;
  }
}

// union member ids of chunk c for this lane (n past the segment or union)
__device__ __forceinline__ int chunk_id(const BlockArgs& a, const int* urow,
                                        int c, int c1, int lane) {
  const int k = c * 32 + lane;
  return c < c1 && k < a.usz ? urow[k] : a.n;
}

// One work item (block blk = item / nseg, union segment item % nseg) on one
// warp: its force partials are written, its energies added to ev, ec,
// ecorr (per lane).
// An item's first ids: the members of its first two chunks, and (lanes
// 0..7) its block atoms; all n past the end.
struct ItemIds {
  int j0, j1;
  int64_t ai;
};

__device__ __forceinline__ ItemIds item_ids(const BlockArgs& a, int item,
                                            int lane) {
  ItemIds r{a.n, a.n, a.n};
  if (item < a.nb * a.nseg) {
    const int blk = item / a.nseg;
    const int c0 = (item - blk * a.nseg) * a.seg;
    const int c1 = min(c0 + a.seg, (a.usz + 31) / 32);
    const int* urow = a.un + static_cast<int64_t>(blk) * a.usz;
    r.j0 = chunk_id(a, urow, c0, c1, lane);
    r.j1 = chunk_id(a, urow, c0 + 1, c1, lane);
    if (lane < BP_B) r.ai = a.rows[static_cast<int64_t>(blk) * BP_B + lane];
  }
  return r;
}

template <bool FUSE, bool EXCL>
__device__ __forceinline__ void sweep_item(const BlockArgs& a,
                                           const WarpSmem& s,
                                           const float* s_tab, int item,
                                           const ItemIds& ids, int lane,
                                           float& ev, float& ec,
                                           float& ecorr) {
  const int n = a.n;
  const int blk = item / a.nseg;
  const int sg = item - blk * a.nseg;
  const int nchunk = (a.usz + 31) / 32;
  const int c0 = sg * a.seg;
  const int c1 = min(c0 + a.seg, nchunk);
  const int* urow = a.un + static_cast<int64_t>(blk) * a.usz;
  // the first two chunks' ids and the block's atoms were read during the
  // item before; each chunk's rows are read while the one before is swept
  int j_cur = ids.j0;
  int j_nxt = ids.j1;
  const int64_t ai = ids.ai;
  // the loads that wait on those ids, issued together
  float4 x_cur = make_float4(0.f, 0.f, 0.f, 0.f);
  if (j_cur < n) x_cur = a.pk[2 * j_cur];
  float4 r0 = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 r1 = r0;
  if (ai < n) {
    r0 = a.pk[2 * ai];
    r1 = a.pk[2 * ai + 1];
  }
  if (lane < BP_B) {
    s.axq[lane] = make_float4(
        r0.x, r0.y, r0.z, __int_as_float(ai < n ? static_cast<int>(ai) : -1));
    s.atf[lane] = make_int4(__float_as_int(r1.x), __float_as_int(r1.y),
                            __float_as_int(r0.w), 0);
  }
  for (int k = lane; k < 3 * BP_B * 32; k += 32) s.facc[k] = 0.f;
  __syncwarp();
  if (EXCL) {
    for (int k = lane; k < BP_B * BP_MAX_EXCL; k += 32) {
      const int b = k / BP_MAX_EXCL;
      const int e = k - b * BP_MAX_EXCL;
      const int ai = __float_as_int(s.axq[b].w);
      const bool on = ai >= 0 && e < a.m;
      s.exj[b * BP_EXST + e] =
          on ? static_cast<int>(a.exi[static_cast<int64_t>(ai) * a.m + e])
             : -1;
      s.exs[b * BP_EXST + e] =
          on ? a.exv[static_cast<int64_t>(ai) * a.m + e] : 1.0f;
    }
    __syncwarp();
  }
  // the block's real atoms and their bounding box (for the image test),
  // reduced over lanes 0..7 and taken from lane 0
  const bool real = lane < BP_B && ai < n;
  const unsigned okm = __ballot_sync(0xffffffffu, real) & 0xffu;
  float lox = real ? r0.x : INFINITY, hix = real ? r0.x : -INFINITY;
  float loy = real ? r0.y : INFINITY, hiy = real ? r0.y : -INFINITY;
  float loz = real ? r0.z : INFINITY, hiz = real ? r0.z : -INFINITY;
#pragma unroll
  for (int o = BP_B / 2; o > 0; o >>= 1) {
    lox = fminf(lox, __shfl_xor_sync(0xffffffffu, lox, o));
    hix = fmaxf(hix, __shfl_xor_sync(0xffffffffu, hix, o));
    loy = fminf(loy, __shfl_xor_sync(0xffffffffu, loy, o));
    hiy = fmaxf(hiy, __shfl_xor_sync(0xffffffffu, hiy, o));
    loz = fminf(loz, __shfl_xor_sync(0xffffffffu, loz, o));
    hiz = fmaxf(hiz, __shfl_xor_sync(0xffffffffu, hiz, o));
  }
  lox = __shfl_sync(0xffffffffu, lox, 0);
  hix = __shfl_sync(0xffffffffu, hix, 0);
  loy = __shfl_sync(0xffffffffu, loy, 0);
  hiy = __shfl_sync(0xffffffffu, hiy, 0);
  loz = __shfl_sync(0xffffffffu, loz, 0);
  hiz = __shfl_sync(0xffffffffu, hiz, 0);
  const float hx = BP_FAST_FRAC * a.bx, hy = BP_FAST_FRAC * a.by;
  const float hz = BP_FAST_FRAC * a.bz;

  int qn = 0;                                          // queued pairs
  for (int c = c0; c < c1; ++c) {
    const bool valid = j_cur < n;
    const int j = valid ? j_cur : -2;
    const float4 xj = x_cur;
    // next chunk's rows, and the ids of the one after
    x_cur = make_float4(0.f, 0.f, 0.f, 0.f);
    if (j_nxt < n) x_cur = a.pk[2 * j_nxt];
    j_cur = j_nxt;
    j_nxt = chunk_id(a, urow, c + 2, c1, lane);
    if (!__any_sync(0xffffffffu, valid)) continue;     // pads only
    // no image where every member of the chunk lies within 0.45 L of the
    // block's box on every periodic axis
    const bool inner =
        !valid ||
        ((!a.px || (fabsf(__fsub_rn(lox, xj.x)) < hx &&
                    fabsf(__fsub_rn(hix, xj.x)) < hx)) &&
         (!a.py || (fabsf(__fsub_rn(loy, xj.y)) < hy &&
                    fabsf(__fsub_rn(hiy, xj.y)) < hy)) &&
         (!a.pz || (fabsf(__fsub_rn(loz, xj.z)) < hz &&
                    fabsf(__fsub_rn(hiz, xj.z)) < hz)));
    unsigned m;
    if (__all_sync(0xffffffffu, inner)) {
      m = test_block<MI_NONE>(a, s, xj, j);
    } else if (a.fast) {
      m = test_block<MI_FAST>(a, s, xj, j);
    } else {
      m = test_block<MI_EXACT>(a, s, xj, j);
    }
    m = valid ? m & okm : 0u;
    // queue the in-range pairs in a fixed order: lane, then block atom
    // (each lane's place from an inclusive scan of the lanes' counts)
    const int cnt = __popc(m);
    int incl = cnt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    for (int at = qn + incl - cnt; m != 0u; m &= m - 1u, ++at) {
      s.queue[at] = (j << 3) | (__ffs(m) - 1);
    }
    qn += __shfl_sync(0xffffffffu, incl, 31);
    if (qn >= 32) {
      __syncwarp();
      int head = 0;
      for (; qn - head >= 32; head += 32) {
        chain_batch<FUSE, EXCL>(a, s, s_tab, lane, head + lane, true, ev, ec,
                                ecorr);
      }
      qn -= head;
      const int mv = lane < qn ? s.queue[head + lane] : 0;
      __syncwarp();
      if (lane < qn) s.queue[lane] = mv;
      __syncwarp();
    }
  }
  if (qn > 0) {
    __syncwarp();
    chain_batch<FUSE, EXCL>(a, s, s_tab, lane, lane, lane < qn, ev, ec,
                            ecorr);
  }
  __syncwarp();
  if (lane < 3 * BP_B) {
    // (atom b, axis x) = (lane / 3, lane % 3); the sum over the 32 lane
    // columns starts at column `lane` (conflict-free), a fixed order
    const int b = lane / 3;
    const int x = lane - 3 * b;
    const float* col = s.facc + (x * BP_B + b) * 32;
    float f = 0.f;
    for (int t = 0; t < 32; ++t) f += col[(t + lane) & 31];
    if (a.nseg == 1) {
      a.f_out[static_cast<int64_t>(blk) * 3 * BP_B + lane] = f;
    } else {
      a.part_f[static_cast<int64_t>(item) * 3 * BP_B + lane] = f;
    }
  }
}

template <bool FUSE, bool EXCL>
__global__ void __launch_bounds__(BP_TB, 8) block_sweep_kernel(BlockArgs a) {
  extern __shared__ float4 s_dyn4[];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int tsz = a.nt1 * a.nt1;
  WarpSmem s;
  s.axq = s_dyn4 + w * BP_B;
  s.atf = reinterpret_cast<int4*>(s_dyn4 + BP_WPC * BP_B) + w * BP_B;
  float* fbase = reinterpret_cast<float*>(s_dyn4 + 2 * BP_WPC * BP_B);
  s.facc = fbase + w * 3 * BP_B * 32;
  s.queue = reinterpret_cast<int*>(fbase + BP_WPC * 3 * BP_B * 32) +
            w * BP_QCAP;
  float* s_tab = reinterpret_cast<float*>(
      reinterpret_cast<int*>(fbase + BP_WPC * 3 * BP_B * 32) +
      BP_WPC * BP_QCAP);                               // (6, nt1, nt1)
  s.exj = reinterpret_cast<int*>(s_tab + 6 * tsz) + w * 2 * BP_B * BP_EXST;
  s.exs = reinterpret_cast<float*>(s.exj + BP_B * BP_EXST);

  for (int k = threadIdx.x; k < 4 * tsz; k += BP_TB) s_tab[k] = a.lj[k];
  if (FUSE) {
    for (int k = threadIdx.x; k < 2 * tsz; k += BP_TB) {
      s_tab[4 * tsz + k] = a.gtab[k];
    }
  }
  __syncthreads();                 // the tables
  // persistent warps: items w, w + (warps), ...; the next item's ids are
  // read while this one is swept
  const int nw = gridDim.x * BP_WPC;
  float ev = 0.f, ec = 0.f, ecorr = 0.f;
  int item = blockIdx.x * BP_WPC + w;
  ItemIds nxt = item_ids(a, item, lane);
  for (; item < a.nb * a.nseg; item += nw) {
    const ItemIds cur = nxt;
    nxt = item_ids(a, item + nw, lane);
    sweep_item<FUSE, EXCL>(a, s, s_tab, item, cur, lane, ev, ec, ecorr);
  }
  // the CTA's energies: warp sums, then the warps in order
  __shared__ float s_e[BP_WPC][3];
  ev = warp_sum(ev);
  ec = warp_sum(ec);
  ecorr = warp_sum(ecorr);
  if (lane == 0) {
    s_e[w][0] = ev;
    s_e[w][1] = ec;
    s_e[w][2] = ecorr;
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    float e = 0.f;
    for (int k = 0; k < BP_WPC; ++k) e += s_e[k][threadIdx.x];
    a.partials[3 * static_cast<int64_t>(blockIdx.x) + threadIdx.x] = e;
  }
}

// f_out[blk, :] = sum over the block's nseg items of part_f, in item order
__global__ void __launch_bounds__(BP_REDUCE_TB)
block_force_reduce(const float* part_f, int nb, int nseg, float* f_out) {
  const int64_t k = static_cast<int64_t>(blockIdx.x) * BP_REDUCE_TB +
                    threadIdx.x;
  if (k >= static_cast<int64_t>(nb) * 3 * BP_B) return;
  const int64_t blk = k / (3 * BP_B);
  const int r = static_cast<int>(k - blk * 3 * BP_B);
  const float* p = part_f + blk * nseg * 3 * BP_B + r;
  float f = 0.f;
  for (int g = 0; g < nseg; ++g) f += p[g * 3 * BP_B];
  f_out[k] = f;
}

// sums[c] = sum over CTAs of partials[., c], fixed order: thread t reads
// the flat array at t, t + 3 * 256, ... (coalesced; all of component t % 3),
// then a tree over the 256 threads of each component
__global__ void __launch_bounds__(3 * BP_REDUCE_TB)
block_pair_reduce(const float* partials, int nctas, float* sums) {
  __shared__ float s[3 * BP_REDUCE_TB];
  const int tid = threadIdx.x;
  const int64_t tot = 3 * static_cast<int64_t>(nctas);
  float acc = 0.f;
  for (int64_t k = tid; k < tot; k += 3 * BP_REDUCE_TB) acc += partials[k];
  // component c = tid % 3, its r-th thread: stored at c * 256 + r
  s[(tid % 3) * BP_REDUCE_TB + tid / 3] = acc;
  __syncthreads();
  for (int h = BP_REDUCE_TB / 2; h > 0; h >>= 1) {
    if (tid < 3 * h) {
      const int c = tid / h;
      const int r = tid - c * h;
      s[c * BP_REDUCE_TB + r] += s[c * BP_REDUCE_TB + r + h];
    }
    __syncthreads();
  }
  if (tid < 3) sums[tid] = s[tid * BP_REDUCE_TB];
}

// The sweep on as many CTAs as are resident at once (at most one per four
// items); *ctas is set to their count, the number of energy partials.
template <bool FUSE, bool EXCL>
cudaError_t launch_block_sweep(const BlockArgs& a, size_t smem,
                               cudaStream_t s, int* ctas) {
  cudaError_t err = cudaFuncSetAttribute(
      block_sweep_kernel<FUSE, EXCL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, block_sweep_kernel<FUSE, EXCL>, BP_TB, smem)) !=
          cudaSuccess) {
    return err;
  }
  const int items = a.nb * a.nseg;
  *ctas = min((items + BP_WPC - 1) / BP_WPC, max(per_sm, 1) * sms);
  block_sweep_kernel<FUSE, EXCL><<<*ctas, BP_TB, smem, s>>>(a);
  return cudaGetLastError();
}

}  // namespace conp2

extern "C" {

// The packed rows alone: pk (n, 8) float32 = (x, y, z, q) and the int bits
// of (type, flag, 0, 0); ele_f == NULL gives flag 0.  Returns
// cudaGetLastError().
int conp2_block_pack_f32(const float* x, const float* q, const int64_t* type,
                         const float* ele_f, const float* ely_f, int n,
                         float* pk, void* stream) {
  if (n <= 0 || (ele_f == nullptr) != (ely_f == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  conp2::block_pack_kernel<<<(n + conp2::BP_PACK_TB - 1) / conp2::BP_PACK_TB,
                             conp2::BP_PACK_TB, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      x, q, type, ele_f, ely_f, n, reinterpret_cast<float4*>(pk));
  return static_cast<int>(cudaGetLastError());
}

// f_out (nb*B, 3) in slot order and sums (3) = raw (elj, ecoul, ecorr) over
// ordered pairs, float32.  ele_f == NULL selects the sweep without the CONP
// correction (ecorr is then 0); m == 0 the sweep without special-bond
// exclusions (exi, exv ignored).  pk: (n, 8) float32 scratch for the packed
// rows; each block's union is swept as nseg items of seg chunks of 32
// members (seg * nseg >= ceil(usz / 32)), on at most one CTA of four
// warps per four items; part_f (nb * nseg, B * 3) is scratch when nseg > 1;
// partials (ceil(nb * nseg / 4), 3) is scratch for the CTAs' energy sums.
// Returns cudaGetLastError().
int conp2_block_pair_f32(const float* x, const float* q, const int64_t* type,
                         const float* ele_f, const float* ely_f,
                         const int* un, const int64_t* rows,
                         const float* lj, const float* gtab,
                         const int64_t* exi, const float* exv, float* pk,
                         float* part_f, int m, int n, int nb, int bsz,
                         int usz, int nt1, int seg, int nseg, float bx,
                         float by, float bz, int px, int py, int pz,
                         float cutsq, float g_ewald, float qqr2e, float* f_out,
                         float* partials, float* sums, void* stream) {
  const int nchunk = (usz + 31) / 32;
  if (n <= 0 || nb <= 0 || usz <= 0 || bsz != conp2::BP_B || nt1 <= 0 ||
      nt1 > conp2::BP_MAX_NT1 || m < 0 || m > conp2::BP_MAX_EXCL ||
      seg <= 0 || nseg <= 0 || static_cast<int64_t>(seg) * nseg < nchunk ||
      (nseg > 1 && part_f == nullptr) || n >= (1 << 28) ||
      static_cast<int64_t>(nb) * nseg >= (1LL << 30)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = conp2_block_pack_f32(x, q, type, ele_f, ely_f, n, pk,
                                       stream);
  if (err != 0) return err;
  cudaError_t e;
  // the fast image where no pair within the cutoff can sit near half a box
  const float cut = sqrtf(cutsq);
  const int fast = (!px || cut <= conp2::BP_FAST_FRAC * bx) &&
                   (!py || cut <= conp2::BP_FAST_FRAC * by) &&
                   (!pz || cut <= conp2::BP_FAST_FRAC * bz);
  conp2::BlockArgs a{reinterpret_cast<const float4*>(pk), un, rows, lj, gtab,
                     exi, exv, m, n, nb, usz, nt1, seg, nseg, bx, by, bz,
                     1.0f / bx, 1.0f / by, 1.0f / bz, px, py, pz, cutsq,
                     g_ewald, qqr2e, fast, f_out, part_f, partials};
  const size_t smem =
      sizeof(float4) * 2 * conp2::BP_WPC * conp2::BP_B +
      sizeof(float) * (conp2::BP_WPC * (3 * conp2::BP_B * 32 +
                                        conp2::BP_QCAP) +
                       6 * static_cast<size_t>(nt1) * nt1 +
                       (m > 0 ? conp2::BP_WPC * 2 * conp2::BP_B *
                                    conp2::BP_EXST
                              : 0));
  const bool fuse = ele_f != nullptr;
  int ctas = 0;
  if (fuse && m > 0) {
    e = conp2::launch_block_sweep<true, true>(a, smem, s, &ctas);
  } else if (fuse) {
    e = conp2::launch_block_sweep<true, false>(a, smem, s, &ctas);
  } else if (m > 0) {
    e = conp2::launch_block_sweep<false, true>(a, smem, s, &ctas);
  } else {
    e = conp2::launch_block_sweep<false, false>(a, smem, s, &ctas);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  if (nseg > 1) {
    const int64_t tot = static_cast<int64_t>(nb) * 3 * conp2::BP_B;
    conp2::block_force_reduce<<<static_cast<int>(
        (tot + conp2::BP_REDUCE_TB - 1) / conp2::BP_REDUCE_TB),
        conp2::BP_REDUCE_TB, 0, s>>>(part_f, nb, nseg, f_out);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  conp2::block_pair_reduce<<<1, 3 * conp2::BP_REDUCE_TB, 0, s>>>(
      partials, ctas, sums);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
