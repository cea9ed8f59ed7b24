// Pair sweep: LJ 12-6 + erfc real-space Coulomb over every pair within the
// cutoff, with the CONP Gaussian correction for (electrode, electrolyte)
// pairs fused in as an option.
//
// Replaces the TPU kernel in lammps_user_conp2_tpu/ops/pallas/pair_kernel.py,
// pair_forces_pallas (body _kernel).
//
// What bounds it on this card: the per-pair transcendental chain -- rsqrt,
// exp and the A&S polynomial with its division, and for fused correction
// pairs a second exp/rsqrt/division chain -- and, where the face is wide
// (2.5% of tested pairs in range at the 7,296-atom cell, 59.5% at the
// ionic-liquid cell), the distance tests of the pairs out of range.  Not
// bytes: the input is 16 B per atom and sits in L2; the side buffer is
// written and read once per work item.
//
// Design: a Newton-halved sweep over tile pairs, three kernels on one
// stream, no atomics, each output written once, fixed-order sums.
//  * The atoms are z-sorted (perm, zs from ops/kernels/zorder.z_perm) and
//    cut into tiles of TILE = 32 consecutive sorted atoms, one per warp lane;
//    the ragged last tile is cut by index (no pad atoms).
//  * pair_schedule (one CTA, the tile keys staged in shared memory): row tile
//    I's partners are the tiles J >= I whose z span lies within cutoff +
//    Z_MARGIN of its own: in z order a direct range [I, hi(I)] and, on a
//    periodic z, a wrapped range [wp(I), T) (binary searches on the tiles'
//    first and last keys).  Work item k is one (I, J) pair; off(I) is the
//    prefix sum of the counts, so the items are a dense list of at most
//    T(T+1)/2, the size of the side buffer the wrapper allocates: nothing can
//    overflow.  It writes each item's row tile, so that a sweep warp decodes
//    its item in one load, and for the reduction it finds, per tile J, the row
//    tiles whose ranges reach it: direct [lo_col(J), J] and wrapped [0, wc(J)).
//    It is the plain version's searchsorted schedule
//    (pair_kernel.tile_schedule_plain), on the device so that the wrapper
//    launches one kernel, not a dozen PyTorch operations.
//  * pair_sweep: persistent CTAs (as many as the card holds at once) of
//    SWEEP_WARPS warps; each warp takes one item at a time, striding over the
//    list, so every item is in flight at once at these sizes and none waits on
//    a grid of idle CTAs.  Lane l stages row atom I*32 + l and column atom J*32
//    + l in shared memory and first tests its row against the 32 columns (pass
//    A, a bit mask, by a fast minimum image with a 1e-4 margin on the cutoff;
//    the exact test decides again before a pair is evaluated).  A dense item
//    (more than LIST_CAP = 128 pairs in range) then runs 32 steps in
//    which each lane evaluates its row against column (l + step) mod 32 in
//    place, the column forces rotating one lane down the warp (__shfl_sync) so
//    that each travels with its column.  A sparse item lists its pairs (row
//    order) and evaluates them 32 at a time with every lane busy: where 2% of
//    the pairs are in range, in-place evaluation would run the chain for one or
//    two live lanes; each row then sums its own entries and each column scans
//    the list, in order.  Each unordered pair is evaluated once (on the
//    diagonal item only column > row), and the item writes its row and column
//    forces to its own 192-float slot.
//  * pair_reduce (a warp per tile and force component): each atom sums its
//    row slots over items [off(I), off(I+1)), then its column slots over
//    the row tiles [0, wc) and [lo_col, J], in index order, and writes its
//    force once at its original index.  Block 0 sums the sweep's per-CTA
//    energies in a fixed order.  Two launches on the same input give
//    bit-identical outputs.
//
// The item-list entry (conp2_pair_items_f32, the tile pair path): the atoms
// come in any order (k-d bricks, ops/kernels/zorder.kd_perm) and the work
// items are an explicit list built with plain PyTorch (pair_kernel.
// tile_items): row tile I, column tile J and a meta word per item, i-major,
// at most ``cap`` of them, the live count on the device.  The same sweep
// body takes item k from the list (pair_sweep<..., ITEMS = true>), with the
// fused correction gated by the item's correction bit; each item has its
// own slot in a side buffer of cap x SLOT floats.  pair_reduce_items sums,
// per tile, its row slots over the items [row_off(t), row_off(t + 1)) and
// its column slots over the items that the by-column index lists for it
// (a stable sort of J), in order: no atomics, fixed-order sums.  A live
// count above the cap writes NaN forces and energies (the JAX kernel's
// fail-loud contract; Engine.run doubles the cap and reruns).
//
// The type tables sit in shared memory; LJ from the row's side (the tables
// are symmetric, as LAMMPS mixes them), the Gaussian correction from the
// electrode's side, as the plain version's electrode rows read it.  |d|^2 is
// formed as the plain version forms it, to the bit (common.cuh
// min_image_rn, rsq_rn).
//
// Special-bond exclusions (bonded systems) are applied per pair, as the
// plain version applies them: each warp keeps its row atoms' (at most
// MAX_EXCL) listed partners and factors in dynamic shared memory sized by
// the lists' width, as int32 ids with the min and max per row; a pair
// whose column id lies outside that range (molecules are numbered
// contiguously, so almost every pair) skips the compares.  The lists are
// symmetric, so the row side finds every pair.  A listed pair gets s * LJ
// and the Coulomb term minus (1 - s) * qq/r.  Sweeping the excluded pairs
// at s = 1 and subtracting them afterwards (the TPU kernel's way) cancels
// catastrophically in float32: a cation's bonded sites sit 1.8 A apart,
// where LJ is ~1e4 kcal/mol per pair.
#include <climits>
#include <cstdint>

#include "common.cuh"

namespace conp2 {

constexpr int TILE = 32;          // atoms per tile == lanes of a warp
constexpr int SLOT = 6 * TILE;    // floats per item: row f (3 x 32), column f
constexpr int SWEEP_WARPS = 8;    // items in flight per CTA
constexpr int SWEEP_TB = 32 * SWEEP_WARPS;
constexpr int SCHED_TB = 1024;
constexpr int RED_WARPS = 8;      // tiles per CTA of the reduction
constexpr int RED_TB = 32 * RED_WARPS;
constexpr int MAX_NT1 = 16;       // type tables up to 16 x 16
constexpr int MAX_EXCL = 16;      // listed special partners per atom
constexpr int LIST_CAP = 128;     // most in-range pairs a sparse item lists
constexpr int SCHED_SMEM = 2048;  // tiles whose keys the schedule stages
constexpr int VALID = 1 << 8;     // column info bits above the type
constexpr int ELE = 1 << 9;
constexpr int ELY = 1 << 10;
constexpr int CORR_BIT = 8;       // item meta: the pair may need the correction

// the schedule, one int32 array of 6T + 1 + T(T+1)/2: off (T + 1), hi,
// wp, lo_col, wc (T each), the raw wrapped starts w (T, scratch) and each
// item's row tile (the items' count at most)
struct Sched {
  int* off;
  int* hi;
  int* wp;
  int* lo_col;
  int* wc;
  int* w;
  int* item_row;
};

__host__ __device__ inline Sched sched_views(int* s, int t) {
  return Sched{s, s + t + 1, s + 2 * t + 1, s + 3 * t + 1, s + 4 * t + 1,
               s + 5 * t + 1, s + 6 * t + 1};
}

// the tiles' first and last sort keys: staged in shared memory by the
// schedule when there are at most SCHED_SMEM tiles, else read from zs
struct TileKeys {
  const float* zs;
  const float* lo;         // staged first keys, or nullptr
  const float* hi;         // staged last keys
  int n;
  __device__ __forceinline__ float first(int t) const {
    return lo ? lo[t] : zs[TILE * t];
  }
  __device__ __forceinline__ float last(int t) const {
    return hi ? hi[t] : zs[min(n, TILE * t + TILE) - 1];
  }
};

// first tile whose first key is > v
__device__ int first_keys_upper(const TileKeys& k, int nt, float v) {
  int lo = 0, hi = nt;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (k.first(mid) <= v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// first tile whose last key is >= v
__device__ int last_keys_lower(const TileKeys& k, int nt, float v) {
  int lo = 0, hi = nt;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (k.last(mid) < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// first index of a non-decreasing int array with a[k] >= v (upper = false)
// or a[k] > v (upper = true)
__device__ int int_search(const int* a, int len, int v, bool upper) {
  int lo = 0, hi = len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (upper ? (a[mid] <= v) : (a[mid] < v)) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// one CTA: the tile-pair schedule (see the header).  Each count is clamped
// to [1, T - I], so the items never exceed T(T+1)/2 whatever the keys hold
// (NaN positions included).  Up to SCHED_SMEM tiles the searches run on
// keys staged in shared memory, then on hi and w staged in the same space.
__global__ void __launch_bounds__(SCHED_TB)
pair_schedule(const float* zs, int n, int nt, int pz, float zcut, float zwrap,
              int* sched) {
  __shared__ int ssum[SCHED_TB];
  __shared__ float stage[2 * SCHED_SMEM];
  const Sched s = sched_views(sched, nt);
  const int tid = threadIdx.x;
  const bool staged = nt <= SCHED_SMEM;
  if (staged) {
    for (int t = tid; t < nt; t += SCHED_TB) {
      stage[t] = zs[TILE * t];
      stage[SCHED_SMEM + t] = zs[min(n, TILE * t + TILE) - 1];
    }
    __syncthreads();
  }
  const TileKeys keys{zs, staged ? stage : nullptr,
                      staged ? stage + SCHED_SMEM : nullptr, n};
  for (int i = tid; i < nt; i += SCHED_TB) {
    const int h = max(i, first_keys_upper(keys, nt, keys.last(i) + zcut) - 1);
    int w = nt, wp = nt;
    if (pz) {
      w = last_keys_lower(keys, nt, keys.first(i) + zwrap);
      wp = max(w, h + 1);
    }
    s.hi[i] = h;
    s.w[i] = w;
    s.wp[i] = wp;
    s.wc[i] = (h - i + 1) + (nt - wp);     // item count, scanned below
  }
  __syncthreads();
  const int per = (nt + SCHED_TB - 1) / SCHED_TB;
  const int b0 = min(nt, tid * per);
  const int b1 = min(nt, b0 + per);
  int acc = 0;
  for (int i = b0; i < b1; ++i) acc += s.wc[i];
  ssum[tid] = acc;
  __syncthreads();
  for (int o = 1; o < SCHED_TB; o <<= 1) {   // inclusive scan, fixed order
    const int v = tid >= o ? ssum[tid - o] : 0;
    __syncthreads();
    ssum[tid] += v;
    __syncthreads();
  }
  int base = ssum[tid] - acc;
  for (int i = b0; i < b1; ++i) {
    s.off[i] = base;
    base += s.wc[i];
  }
  if (tid == SCHED_TB - 1) s.off[nt] = ssum[tid];
  __syncthreads();
  // each item's row tile, so that a sweep warp finds it in one load: a
  // warp per tile, its lanes on consecutive items
  for (int i = tid >> 5; i < nt; i += SCHED_TB / 32) {
    for (int k = s.off[i] + (tid & 31); k < s.off[i + 1]; k += 32) {
      s.item_row[k] = i;
    }
  }
  // the column side searches hi and w (non-decreasing in I)
  const int* hi = s.hi;
  const int* w = s.w;
  if (staged) {
    int* ist = reinterpret_cast<int*>(stage);
    for (int t = tid; t < nt; t += SCHED_TB) {
      ist[t] = s.hi[t];
      ist[SCHED_SMEM + t] = s.w[t];
    }
    hi = ist;
    w = ist + SCHED_SMEM;
  }
  __syncthreads();
  for (int j = tid; j < nt; j += SCHED_TB) {
    const int lc = int_search(hi, nt, j, false);
    s.lo_col[j] = lc;
    s.wc[j] = pz ? min(int_search(w, nt, j, true), lc) : 0;
  }
}

struct PairArgs {
  const float* x;          // (n, 3) original order
  const float* q;          // (n,)
  const int64_t* type;     // (n,)
  const float* ele_f;      // (n,) 1 = electrode (fused correction only)
  const float* ely_f;      // (n,) 1 = electrolyte (fused correction only)
  const int64_t* perm;     // (n,) sorted position -> atom index
  const int* sched;        // the schedule (6T + 1)
  const float* lj[4];      // (nt1, nt1) each: lj1..lj4
  const float* eta;        // (nt1, nt1) Gaussian widths (fused only)
  const float* fo;         // (nt1, nt1) overlap prefactors (fused only)
  const int64_t* exi;      // (n, m) special partners, padded with n
  const float* exv;        // (n, m) their factors s
  int m;                   // 0: no exclusions
  int n, nt1, nt;
  float bx, by, bz, ibx, iby, ibz;
  int px, py, pz;
  float cutsq, cutsq_hi, g, qqr2e;   // cutsq_hi: pass A's margin
  float* buf;              // (T(T+1)/2, SLOT) side buffer
  float* partials;         // (gridDim.x, 3) per-CTA energy sums
  const int* items;        // the item list (ITEMS only), see Items
  int cap;                 // items the list holds (ITEMS only)
};

// the item list of the tile path, one int32 array: row tile, column tile
// and meta of each item (cap each), row_off and col_off (T + 1 each), the
// by-column index (cap) and the live count (1)
struct Items {
  const int* ti;
  const int* tj;
  const int* meta;
  const int* row_off;
  const int* col_off;
  const int* col_items;
  const int* count;
};

__host__ __device__ inline Items item_views(const int* s, int cap, int t) {
  return Items{s, s + cap, s + 2 * cap, s + 3 * cap, s + 3 * cap + t + 1,
               s + 3 * cap + 2 * (t + 1), s + 4 * cap + 2 * (t + 1)};
}

// one warp's staged item: its 32 row and 32 column atoms, and the list of
// in-range pairs of a sparse item with their forces
struct WarpStage {
  float rx[TILE], ry[TILE], rz[TILE], rq[TILE];
  int rinfo[TILE];         // type | VALID | ELE | ELY of the row atoms
  int rexlo[TILE], rexhi[TILE];   // min and max listed partner id per row
  float cx[TILE], cy[TILE], cz[TILE], cq[TILE];
  int cinfo[TILE];         // type | VALID | ELE | ELY of the column atoms
  int cid[TILE];           // the column atoms' indices
  int list[LIST_CAP];      // row lane | column lane << 8
  float lf[3][LIST_CAP];   // each listed pair's force on its row atom
};

// F/r of one pair in range (LJ, erfc Coulomb, the special factor sij, the
// fused Gaussian correction from the electrode's side); adds its energies
template <bool FUSE, bool EXCL>
__device__ __forceinline__ float pair_term(const PairArgs& a,
                                           const float* s_tab, int tsz,
                                           float rsq, float qi, int rinfo,
                                           float cq, int cinfo, float sij,
                                           bool corr, float& ev, float& ec,
                                           float& ecorr) {
  const int ti = rinfo & 0xff, tj = cinfo & 0xff;
  const int nt1 = a.nt1;
  const float* trow = s_tab + ti * nt1;
  const float rinv = rsqrtf(rsq);
  const float r2inv = rinv * rinv;
  const float r6inv = r2inv * r2inv * r2inv;
  const float l1 = trow[tj], l2 = trow[tsz + tj];
  const float l3 = trow[2 * tsz + tj], l4 = trow[3 * tsz + tj];
  const float grij = a.g * rsq * rinv;               // g * r
  const float expm2 = expf(-grij * grij);
  const float erfc = as_poly(grij) * expm2;
  const float qq = qi * cq;
  const float pref = a.qqr2e * rinv * qq;
  float fpair;
  if (EXCL) {
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
  if (FUSE && corr && (((rinfo & ELE) && (cinfo & ELY)) ||
                       ((rinfo & ELY) && (cinfo & ELE)))) {
    // CONP Gaussian correction (fix_conp.cpp:1467-1573), with the
    // (electrode type, electrolyte type) entry of the tables
    const int te = (rinfo & ELE) ? ti * nt1 + tj : tj * nt1 + ti;
    const float et = s_tab[4 * tsz + te];
    const float fo = s_tab[5 * tsz + te];
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
  return fpair;
}

// the special factor of (row lane r, column atom cj): 1 unless r lists cj
// (the last listed match wins, as in the plain version)
__device__ __forceinline__ float special(const int* exj, const float* exs,
                                         int m, int r, int lo, int hi,
                                         int cj) {
  float sij = 1.0f;
  if (cj >= lo && cj <= hi) {
    for (int e = 0; e < m; ++e) {
      if (exj[e * TILE + r] == cj) sij = exs[e * TILE + r];
    }
  }
  return sij;
}

template <bool FUSE, bool EXCL, bool ITEMS>
__global__ void __launch_bounds__(SWEEP_TB) pair_sweep(PairArgs a) {
  __shared__ float s_tab[6 * MAX_NT1 * MAX_NT1];
  __shared__ WarpStage s_stage[SWEEP_WARPS];
  __shared__ float sred[3][SWEEP_WARPS];
  extern __shared__ int s_excl[];        // EXCL: per warp m x 32 ids, factors

  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int nt1 = a.nt1;
  const int tsz = nt1 * nt1;
  for (int k = threadIdx.x; k < tsz; k += SWEEP_TB) {
    s_tab[k] = a.lj[0][k];
    s_tab[tsz + k] = a.lj[1][k];
    s_tab[2 * tsz + k] = a.lj[2][k];
    s_tab[3 * tsz + k] = a.lj[3][k];
    if (FUSE) {
      s_tab[4 * tsz + k] = a.eta[k];
      s_tab[5 * tsz + k] = a.fo[k];
    }
  }
  __syncthreads();                      // type tables staged

  const int nt = a.nt;
  const Sched sc = sched_views(const_cast<int*>(a.sched), nt);
  const Items il = item_views(a.items, a.cap, nt);
  const int nitems = ITEMS ? min(*il.count, a.cap) : sc.off[nt];
  WarpStage& ws = s_stage[wid];
  int* exj = s_excl + wid * 2 * a.m * TILE;
  float* exs = reinterpret_cast<float*>(exj + a.m * TILE);
  const int src = (lane + 1) & 31;      // the rotation's source lane

  float ev = 0.f, ec = 0.f, ecorr = 0.f;
  for (int k = blockIdx.x * SWEEP_WARPS + wid; k < nitems;
       k += gridDim.x * SWEEP_WARPS) {
    // the item's tiles: row tile I, and column tile J from the list or
    // from I's ranges
    int ti_, tj_;
    bool corr = true;
    if (ITEMS) {
      ti_ = il.ti[k];
      tj_ = il.tj[k];
      corr = (il.meta[k] & CORR_BIT) != 0;
    } else {
      ti_ = sc.item_row[k];
      const int d = k - sc.off[ti_];
      const int nd = sc.hi[ti_] - ti_ + 1;
      tj_ = d < nd ? ti_ + d : sc.wp[ti_] + (d - nd);
    }
    const bool diag = ti_ == tj_;

    __syncwarp();                       // the previous item's stage is read
    // row atom of this lane, in registers and staged
    const int pi = TILE * ti_ + lane;
    const bool vi = pi < a.n;
    int ai = 0, rinfo = 0;
    float xi = 0.f, yi = 0.f, zi = 0.f, qi = 0.f;
    if (vi) {
      ai = static_cast<int>(a.perm[pi]);
      xi = a.x[3 * ai];
      yi = a.x[3 * ai + 1];
      zi = a.x[3 * ai + 2];
      qi = a.q[ai];
      rinfo = static_cast<int>(a.type[ai]) | VALID;
      if (FUSE) {
        rinfo |= (a.ele_f[ai] > 0.f ? ELE : 0) | (a.ely_f[ai] > 0.f ? ELY : 0);
      }
    }
    ws.rx[lane] = xi;
    ws.ry[lane] = yi;
    ws.rz[lane] = zi;
    ws.rq[lane] = qi;
    ws.rinfo[lane] = rinfo;
    // column atom of this lane, staged
    const int pj = TILE * tj_ + lane;
    int cj = -1, cinfo = 0;
    float cx = 0.f, cy = 0.f, cz = 0.f, cq = 0.f;
    if (pj < a.n) {
      cj = static_cast<int>(a.perm[pj]);
      cx = a.x[3 * cj];
      cy = a.x[3 * cj + 1];
      cz = a.x[3 * cj + 2];
      cq = a.q[cj];
      cinfo = static_cast<int>(a.type[cj]) | VALID;
      if (FUSE) {
        cinfo |= (a.ele_f[cj] > 0.f ? ELE : 0) | (a.ely_f[cj] > 0.f ? ELY : 0);
      }
    }
    ws.cx[lane] = cx;
    ws.cy[lane] = cy;
    ws.cz[lane] = cz;
    ws.cq[lane] = cq;
    ws.cinfo[lane] = cinfo;
    ws.cid[lane] = cj;
    int exlo = INT_MAX, exhi = -1;
    if (EXCL) {
      for (int e = 0; e < a.m; ++e) {
        int id = -1;
        float sv = 1.f;
        if (vi) {
          const int64_t v = a.exi[static_cast<int64_t>(ai) * a.m + e];
          if (v < a.n) {
            id = static_cast<int>(v);
            sv = a.exv[static_cast<int64_t>(ai) * a.m + e];
            exlo = min(exlo, id);
            exhi = max(exhi, id);
          }
        }
        exj[e * TILE + lane] = id;
        exs[e * TILE + lane] = sv;
      }
      ws.rexlo[lane] = exlo;
      ws.rexhi[lane] = exhi;
    }
    __syncwarp();

    // pass A: which of this row's 32 columns may be in range (bit st: the
    // column at home lane (lane + st) mod 32), by a fast test with a 1e-4
    // margin; the exact test decides again before a pair is evaluated
    unsigned mask = 0u;
    if (vi) {
      for (int st = 0; st < TILE; ++st) {
        const int jl = (lane + st) & 31;
        if ((ws.cinfo[jl] & VALID) && (!diag || jl > lane)) {
          const float dx = min_image(xi - ws.cx[jl], a.bx, a.ibx, a.px);
          const float dy = min_image(yi - ws.cy[jl], a.by, a.iby, a.py);
          const float dz = min_image(zi - ws.cz[jl], a.bz, a.ibz, a.pz);
          if (dx * dx + dy * dy + dz * dz < a.cutsq_hi) mask |= 1u << st;
        }
      }
    }
    const int cnt = __popc(mask);
    const int total = __reduce_add_sync(0xffffffffu, cnt);
    float fx = 0.f, fy = 0.f, fz = 0.f;     // the row atom's force
    float gx = 0.f, gy = 0.f, gz = 0.f;     // the home column's force
    if (total > LIST_CAP) {
      // dense item: 32 steps rotate the column forces one lane down the
      // warp, so each travels with its column; the chain runs in place
      for (int st = 0; st < TILE; ++st) {
        if (mask & (1u << st)) {
          const int jl = (lane + st) & 31;
          const float dx = min_image_rn(__fsub_rn(xi, ws.cx[jl]), a.bx,
                                        a.ibx, a.px);
          const float dy = min_image_rn(__fsub_rn(yi, ws.cy[jl]), a.by,
                                        a.iby, a.py);
          const float dz = min_image_rn(__fsub_rn(zi, ws.cz[jl]), a.bz,
                                        a.ibz, a.pz);
          const float rsq = rsq_rn(dx, dy, dz);
          if (rsq < a.cutsq) {
            const float sij = EXCL ? special(exj, exs, a.m, lane, exlo,
                                             exhi, ws.cid[jl]) : 1.0f;
            const float fpair = pair_term<FUSE, EXCL>(
                a, s_tab, tsz, rsq, qi, rinfo, ws.cq[jl], ws.cinfo[jl], sij,
                corr, ev, ec, ecorr);
            const float ox = fpair * dx, oy = fpair * dy, oz = fpair * dz;
            fx += ox;
            fy += oy;
            fz += oz;
            gx -= ox;
            gy -= oy;
            gz -= oz;
          }
        }
        gx = __shfl_sync(0xffffffffu, gx, src);
        gy = __shfl_sync(0xffffffffu, gy, src);
        gz = __shfl_sync(0xffffffffu, gz, src);
      }
    } else {
      // sparse item: list the in-range pairs (row-major: lane order, then
      // step), evaluate them 32 at a time with every lane busy, then each
      // row sums its own entries and each column scans the list, in order
      int pos = cnt;                        // inclusive lane prefix
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, pos, o);
        if (lane >= o) pos += v;
      }
      const int first = pos - cnt;
      for (unsigned mm = mask, e = first; mm; mm &= mm - 1, ++e) {
        const int st = __ffs(mm) - 1;
        ws.list[e] = lane | (((lane + st) & 31) << 8);
      }
      __syncwarp();
      for (int e = lane; e < total; e += 32) {
        const int r = ws.list[e] & 0xff, c = ws.list[e] >> 8;
        const float dx = min_image_rn(__fsub_rn(ws.rx[r], ws.cx[c]), a.bx,
                                      a.ibx, a.px);
        const float dy = min_image_rn(__fsub_rn(ws.ry[r], ws.cy[c]), a.by,
                                      a.iby, a.py);
        const float dz = min_image_rn(__fsub_rn(ws.rz[r], ws.cz[c]), a.bz,
                                      a.ibz, a.pz);
        const float rsq = rsq_rn(dx, dy, dz);
        float fpair = 0.f;
        if (rsq < a.cutsq) {
          const float sij = EXCL ? special(exj, exs, a.m, r, ws.rexlo[r],
                                           ws.rexhi[r], ws.cid[c]) : 1.0f;
          fpair = pair_term<FUSE, EXCL>(a, s_tab, tsz, rsq, ws.rq[r],
                                        ws.rinfo[r], ws.cq[c], ws.cinfo[c],
                                        sij, corr, ev, ec, ecorr);
        }
        ws.lf[0][e] = fpair * dx;
        ws.lf[1][e] = fpair * dy;
        ws.lf[2][e] = fpair * dz;
      }
      __syncwarp();
      for (int e = first; e < pos; ++e) {
        fx += ws.lf[0][e];
        fy += ws.lf[1][e];
        fz += ws.lf[2][e];
      }
      for (int e = 0; e < total; ++e) {
        if ((ws.list[e] >> 8) == lane) {
          gx -= ws.lf[0][e];
          gy -= ws.lf[1][e];
          gz -= ws.lf[2][e];
        }
      }
    }
    float* slot = a.buf + static_cast<int64_t>(k) * SLOT;
    slot[lane] = fx;
    slot[TILE + lane] = fy;
    slot[2 * TILE + lane] = fz;
    slot[3 * TILE + lane] = gx;
    slot[4 * TILE + lane] = gy;
    slot[5 * TILE + lane] = gz;
  }
  ev = warp_sum(ev);
  ec = warp_sum(ec);
  ecorr = warp_sum(ecorr);
  if (lane == 0) {
    sred[0][wid] = ev;
    sred[1][wid] = ec;
    sred[2][wid] = ecorr;
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    float acc = 0.f;
    for (int w = 0; w < SWEEP_WARPS; ++w) acc += sred[threadIdx.x][w];
    a.partials[3 * blockIdx.x + threadIdx.x] = acc;
  }
}

struct ReduceArgs {
  const int64_t* perm;     // (n,) sorted position -> atom index
  const int* sched;
  const float* buf;
  const float* partials;   // (nparts, 3)
  int nparts, n, nt;
  float* f_out;            // (n, 3) original order
  float* energies;         // (3,) evdwl, ecoul, ecorr
};

// a warp per (tile, force component): each lane's atom sums its row slots,
// then its column slots (wrapped row tiles [0, wc), direct [lo_col, J]), in
// index order
__global__ void __launch_bounds__(RED_TB) pair_reduce(ReduceArgs a) {
  const int lane = threadIdx.x & 31;
  const int wg = blockIdx.x * RED_WARPS + (threadIdx.x >> 5);
  const int tj = wg / 3, c = wg - 3 * (wg / 3);
  const int nt = a.nt;
  const Sched s = sched_views(const_cast<int*>(a.sched), nt);
  if (tj < nt) {
    const float* row = a.buf + c * TILE + lane;
    const float* col = a.buf + (3 + c) * TILE + lane;
    float f = 0.f;
    const int k1 = s.off[tj + 1];
#pragma unroll 4
    for (int k = s.off[tj]; k < k1; ++k) {
      f += row[static_cast<int64_t>(k) * SLOT];
    }
    const int nwrap = s.wc[tj];
#pragma unroll 4
    for (int i = 0; i < nwrap; ++i) {
      const int w0 = s.wp[i];
      if (tj < w0) continue;             // never, on a consistent schedule
      const int k = s.off[i] + (s.hi[i] - i + 1) + (tj - w0);
      f += col[static_cast<int64_t>(k) * SLOT];
    }
#pragma unroll 4
    for (int i = s.lo_col[tj]; i <= tj; ++i) {
      if (tj > s.hi[i]) continue;        // never, on a consistent schedule
      f += col[static_cast<int64_t>(s.off[i] + (tj - i)) * SLOT];
    }
    const int p = TILE * tj + lane;
    if (p < a.n) a.f_out[3 * a.perm[p] + c] = f;
  }
  if (blockIdx.x == 0 && threadIdx.x < 32) {
    for (int e = 0; e < 3; ++e) {
      float acc = 0.f;
      for (int b = lane; b < a.nparts; b += 32) acc += a.partials[3 * b + e];
      acc = warp_sum(acc);
      if (lane == 0) a.energies[e] = acc;
    }
  }
}

struct ItemReduceArgs {
  const int64_t* perm;     // (n,) ordered position -> atom index
  const int* items;
  const float* buf;
  const float* partials;   // (nparts, 3)
  int nparts, n, nt, cap;
  float* f_out;            // (n, 3) original order
  float* energies;         // (3,) evdwl, ecoul, ecorr
};

// the item list's reduction: a warp per (tile, force component); each
// lane's atom sums its row slots over the tile's row items, then its column
// slots over the items of the by-column index, in order.  NaN everywhere
// when the live count passed the cap.
__global__ void __launch_bounds__(RED_TB) pair_reduce_items(ItemReduceArgs a) {
  const int lane = threadIdx.x & 31;
  const int wg = blockIdx.x * RED_WARPS + (threadIdx.x >> 5);
  const int tj = wg / 3, c = wg - 3 * (wg / 3);
  const Items il = item_views(a.items, a.cap, a.nt);
  const bool over = *il.count > a.cap;
  if (tj < a.nt) {
    const float* row = a.buf + c * TILE + lane;
    const float* col = a.buf + (3 + c) * TILE + lane;
    float f = 0.f;
    const int k1 = il.row_off[tj + 1];
#pragma unroll 4
    for (int k = il.row_off[tj]; k < k1; ++k) {
      f += row[static_cast<int64_t>(k) * SLOT];
    }
    const int e1 = il.col_off[tj + 1];
#pragma unroll 4
    for (int e = il.col_off[tj]; e < e1; ++e) {
      f += col[static_cast<int64_t>(il.col_items[e]) * SLOT];
    }
    const int p = TILE * tj + lane;
    if (p < a.n) a.f_out[3 * a.perm[p] + c] = over ? __int_as_float(0x7fc00000) : f;
  }
  if (blockIdx.x == 0 && threadIdx.x < 32) {
    for (int e = 0; e < 3; ++e) {
      float acc = 0.f;
      for (int b = lane; b < a.nparts; b += 32) acc += a.partials[3 * b + e];
      acc = warp_sum(acc);
      if (lane == 0) a.energies[e] = over ? __int_as_float(0x7fc00000) : acc;
    }
  }
}

// dynamic shared memory of the sweep: the exclusion lists of each warp's
// 32 rows (ids and factors)
inline int sweep_excl_bytes(int m) {
  return SWEEP_WARPS * 2 * m * TILE * static_cast<int>(sizeof(int));
}

// the CTAs the card holds at once with the shared memory of m special
// partners per row, for the entry ITEMS selects (each entry is sized from its
// own instantiation's occupancy, so the z entry's CTA count, and with it the
// order of its per-CTA energy sums, does not depend on the item entry).  The
// dynamic shared memory a launch may ask for (above 48 KB only through the
// attribute) is raised to the largest m asked for, never lowered, so that
// every m asked for stays launchable; the count depends on this m alone.
template <bool FUSE, bool EXCL, bool ITEMS>
int sweep_setup(int m) {
  static int allowed = 0;
  const int dyn = sweep_excl_bytes(m);
  if (dyn > allowed) {
    if (cudaFuncSetAttribute(pair_sweep<FUSE, EXCL, ITEMS>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dyn) != cudaSuccess) {
      return -1;
    }
    allowed = dyn;
  }
  int dev = 0, sms = 0, per = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per, pair_sweep<FUSE, EXCL, ITEMS>, SWEEP_TB, dyn);
  return (sms > 0 ? sms : 1) * (per > 0 ? per : 1);
}

template <bool ITEMS>
int sweep_ctas(bool fuse, int m) {
  if (fuse && m > 0) return sweep_setup<true, true, ITEMS>(m);
  if (fuse) return sweep_setup<true, false, ITEMS>(0);
  if (m > 0) return sweep_setup<false, true, ITEMS>(m);
  return sweep_setup<false, false, ITEMS>(0);
}

template <bool ITEMS>
void launch_sweep(const PairArgs& a, bool fuse, int nctas, cudaStream_t s) {
  const int dyn = sweep_excl_bytes(a.m);
  if (fuse && a.m > 0) {
    pair_sweep<true, true, ITEMS><<<nctas, SWEEP_TB, dyn, s>>>(a);
  } else if (fuse) {
    pair_sweep<true, false, ITEMS><<<nctas, SWEEP_TB, 0, s>>>(a);
  } else if (a.m > 0) {
    pair_sweep<false, true, ITEMS><<<nctas, SWEEP_TB, dyn, s>>>(a);
  } else {
    pair_sweep<false, false, ITEMS><<<nctas, SWEEP_TB, 0, s>>>(a);
  }
}

}  // namespace conp2

extern "C" {

// CTAs of the persistent sweep of the z entry (items == 0) or the item-list
// entry (items != 0) for ``items_cap`` items with m listed special partners
// per atom: the CTAs this card holds at once of that entry's sweep, at most
// one per SWEEP_WARPS items; -1 if the card refuses the shared memory.  The
// wrapper sizes the per-CTA energy buffer from it and keeps the one cache of
// it.
int conp2_pair_sweep_ctas(int fuse, int m, int items_cap, int items) {
  const int ctas = items ? conp2::sweep_ctas<true>(fuse != 0, m)
                         : conp2::sweep_ctas<false>(fuse != 0, m);
  if (ctas < 0) return -1;
  const int need = (items_cap + conp2::SWEEP_WARPS - 1) / conp2::SWEEP_WARPS;
  return need < ctas ? (need > 0 ? need : 1) : ctas;
}

// the tile-pair schedule alone (the first kernel of conp2_pair_forces_f32)
// into sched (6T + 1 + T(T+1)/2 int32), T = ceil(n / 32).  Returns
// cudaGetLastError().
int conp2_pair_schedule_i32(const float* zs, int n, int pz, float zcut,
                            float zwrap, int* sched, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int nt = (n + conp2::TILE - 1) / conp2::TILE;
  conp2::pair_schedule<<<1, conp2::SCHED_TB, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      zs, n, nt, pz, zcut, zwrap, sched);
  return static_cast<int>(cudaGetLastError());
}

// f_out (n, 3) and energies (3) = (evdwl, ecoul, ecorr) in float32; the
// LJ tables lj1..lj4 and the Gaussian tables eta, fo are (nt1, nt1) each.
// ele_f == NULL selects the sweep without the CONP correction (ely_f, eta
// and fo are then ignored and ecorr is 0); m == 0 selects the sweep without
// special-bond exclusions (exi, exv ignored).  Items with at most
// LIST_CAP pairs in range take the sparse path.  Workspace from the
// wrapper: sched (6T + 1 + T(T+1)/2 int32), buf (T(T+1)/2 * 192 float32),
// partials (nctas * 3, nctas from conp2_pair_sweep_ctas with the same fuse
// and m).  Returns cudaGetLastError().
int conp2_pair_forces_f32(const float* x, const float* q, const int64_t* type,
                          const float* ele_f, const float* ely_f,
                          const int64_t* perm, const float* zs,
                          const float* lj1, const float* lj2,
                          const float* lj3, const float* lj4,
                          const float* eta, const float* fo,
                          const int64_t* exi, const float* exv, int m, int n,
                          int nt1, float bx, float by, float bz, int px,
                          int py, int pz, float cutsq, float zcut,
                          float zwrap, float g_ewald, float qqr2e, int nctas,
                          int* sched, float* buf, float* partials,
                          float* f_out, float* energies, void* stream) {
  if (n <= 0 || nt1 <= 0 || nt1 > conp2::MAX_NT1 || m < 0 ||
      m > conp2::MAX_EXCL || nctas <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int nt = (n + conp2::TILE - 1) / conp2::TILE;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  conp2::pair_schedule<<<1, conp2::SCHED_TB, 0, s>>>(zs, n, nt, pz, zcut,
                                                     zwrap, sched);
  conp2::PairArgs a{x, q, type, ele_f, ely_f, perm, sched,
                    {lj1, lj2, lj3, lj4}, eta, fo, exi, exv, m, n, nt1, nt,
                    bx, by, bz, 1.0f / bx, 1.0f / by, 1.0f / bz, px, py, pz,
                    cutsq, cutsq * 1.0001f, g_ewald, qqr2e, buf, partials,
                    nullptr, 0};
  conp2::launch_sweep<false>(a, ele_f != nullptr, nctas, s);
  conp2::ReduceArgs r{perm, sched, buf, partials, nctas, n, nt, f_out,
                      energies};
  const int nred = (3 * nt + conp2::RED_WARPS - 1) / conp2::RED_WARPS;
  conp2::pair_reduce<<<nred, conp2::RED_TB, 0, s>>>(r);
  return static_cast<int>(cudaGetLastError());
}

// The tile path's entry: the sweep over the item list ``items`` (int32,
// 4 cap + 2 (nt + 1) + 1: see conp2::Items; nt = tiles, the pad tile that
// makes their count odd included) of the atoms in the order ``perm``, then
// its reduction.  Workspace from the wrapper: buf (cap * 192 float32) and
// partials (nctas * 3).  f_out (n, 3) and energies (3) = (evdwl, ecoul,
// ecorr), NaN when the live count is above cap.  ele_f == NULL and m == 0
// as in conp2_pair_forces_f32.  Returns cudaGetLastError().
int conp2_pair_items_f32(const float* x, const float* q, const int64_t* type,
                         const float* ele_f, const float* ely_f,
                         const int64_t* perm, const int* items,
                         const float* lj1, const float* lj2,
                         const float* lj3, const float* lj4, const float* eta,
                         const float* fo, const int64_t* exi,
                         const float* exv, int m, int n, int nt1, int nt,
                         int cap, float bx, float by, float bz, int px,
                         int py, int pz, float cutsq, float g_ewald,
                         float qqr2e, int nctas, float* buf, float* partials,
                         float* f_out, float* energies, void* stream) {
  if (n <= 0 || nt1 <= 0 || nt1 > conp2::MAX_NT1 || m < 0 ||
      m > conp2::MAX_EXCL || nctas <= 0 || cap <= 0 ||
      nt < (n + conp2::TILE - 1) / conp2::TILE) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  conp2::PairArgs a{x, q, type, ele_f, ely_f, perm, nullptr,
                    {lj1, lj2, lj3, lj4}, eta, fo, exi, exv, m, n, nt1, nt,
                    bx, by, bz, 1.0f / bx, 1.0f / by, 1.0f / bz, px, py, pz,
                    cutsq, cutsq * 1.0001f, g_ewald, qqr2e, buf, partials,
                    items, cap};
  conp2::launch_sweep<true>(a, ele_f != nullptr, nctas, s);
  conp2::ItemReduceArgs r{perm, items, buf, partials, nctas, n, nt, cap,
                          f_out, energies};
  const int nred = (3 * nt + conp2::RED_WARPS - 1) / conp2::RED_WARPS;
  conp2::pair_reduce_items<<<nred, conp2::RED_TB, 0, s>>>(r);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
