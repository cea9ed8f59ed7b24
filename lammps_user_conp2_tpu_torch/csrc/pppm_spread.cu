// PPPM charge spreads from the tile slot rows: into the z-binned mesh (K2a)
// and into per-tile patches (K2b).
//
// K2a, the spread into the z-binned mesh: order-5 B-spline weights
// of every slotted atom, summed into the output mesh tile (tlx x tly x ez)
// from the tile's own slots and the border slots of its 8 periodic xy
// neighbours; z stays binned (no wrap).
//
// Replaces the TPU kernel in lammps_user_conp2_tpu/ops/pallas/pppm_spread.py,
// spread_mesh_pallas (body _mesh_kernel).
//
// What bounds it on this card: the mesh write (one float per node, 31.5 MB
// at the 100k cell) and, in shared memory, the 125 weighted adds per atom
// and tile it reaches; the slot rows are a few MB.
//
// Design: one CTA per output tile, 3 CTAs per SM.  The tile's accumulator
// (16 x 16 x 38 floats at the 100k cell) lives in shared memory, z-major
// with a padded plane stride.
//  - Counts: each of the nine sources (the tile and its 8 periodic xy
//    neighbours, same z bin) is read only up to one past its last charged
//    slot, all nine in one pass.  A tile whose sources hold no charge
//    writes zeros and returns.
//  - Staging: all 256 threads take one (source, slot) each per round, in
//    the order source, then slot, each round's rows read one round ahead;
//    an atom is kept if it is charged and its 5 x 5 footprint reaches the
//    tile, i.e. its stencil origin, mapped into this tile's frame, lies in
//    [-4, tl - 1] on x and y.  A ballot and the warp totals give each kept
//    atom its place in the pass, in that order.
//  - Origin binning: a pass (up to kcap kept atoms, sized so that the
//    accumulator and the bins keep 3 CTAs per SM) is sorted by origin cell
//    (one of (tlx + 4) x (tly + 4), x major) with a stable counting sort:
//    counts, a block scan, and ranks from one warp's match over the items
//    in pass order.  Each kept atom's record (its 15 weights by Horner, the
//    coefficients of ops/pppm.py rho_coeffs in the order of _horner_w, and
//    its origin) goes to its sorted place.
//  - Accumulation: a warp OWNS accumulator rows i (x), so no two warps
//    write one node (no atomics, deterministic sums).  The atoms that
//    reach row i are those of the origin cells with x index i .. i + 4:
//    one contiguous run of records, walked in order, one atom at a time by
//    25 lanes, one per (y, z) node of its footprint in the row: no
//    divergence, no dead tests, 125 adds per kept atom.  (A thread per
//    column walking its own 25 cells diverges: the lanes of a warp walk
//    cells of different lengths.)
//  - A tile whose kept atoms exceed one pass stages on in the same order
//    into a fresh pass after adding the full one; none is dropped.
//  - Write-out: a warp per column, lanes over its ez contiguous nodes.
// Tile indices wrap periodically in x and y, which also covers grids of
// one or two tiles per axis: a source then appears under several offsets,
// each contributing where its shifted footprint reaches the tile, as the
// plain version's overlap-add rolls it.
//
// K2b, per-tile charge patches: patch t (ex*ey, ez) = (wx (x) wy)^T (q wz)
// over the slots of tile t, where ex = tlx + 2 bw etc. are the tile plus
// its stencil border and drift margin; the caller overlap-adds the patches
// into the mesh (ops/pppm.py _overlap_add).
//
// Replaces the TPU kernel in lammps_user_conp2_tpu/ops/pallas/pppm_spread.py,
// spread_tiles_pallas (body _kernel).
//
// What bounds it on this card: the patch write (ex*ey*ez floats per tile,
// 74 KB at the 100k cell's tiles) and the shared-memory accumulation; the
// slot rows are read once.  On the electrode re-spread, the one caller,
// the grid's slot capacity is sized for all atoms, so almost every slot is
// empty: the kernel reads only the charges of a tile's slots to find its
// count (one past the last slot with a charge; the slots after it add
// nothing) and stages only the slots before it.
//
// Design: one CTA per tile, K2a's column ownership without the neighbour
// tiles: the patch accumulator lives in shared memory (z-major), each
// thread owns xy columns of it and adds the staged atoms' contributions in
// slot order (no atomics, deterministic).  128 threads stage the charged
// slots per round, compacted by ballot, and every column thread tests
// every staged atom; a stencil node outside the patch gets no weight, as in
// the plain version's one-hot weights.
#include <cstdint>

#include "common.cuh"

namespace conp2 {

constexpr int SP_TB = 256;      // threads per CTA
constexpr int SP_CHUNK = 128;   // K2b: slots staged per round (threads 0..127)
constexpr int SP_P = 5;         // stencil order
// K2a's shared memory per CTA: 3 CTAs per SM (228 KB each SM, 1 KB of it
// reserved per CTA); SP_STATIC covers the kernel's static arrays
constexpr int SP_MESH_BUDGET = 76800;
constexpr int SP_STATIC = 1024;
constexpr int SP_REC = 20;              // floats per kept atom's record
// a kept atom's item: source << SP_SLOT_BITS | slot
constexpr int SP_SLOT_BITS = 20;
constexpr int SP_ITEM_BYTES = (SP_REC + 2) * 4;   // record, item, key

// K2a's accumulator row stride (floats per z plane of the tile): the
// columns, padded to 5 (mod 32) so that the 5 x 5 lanes of one atom's
// (y, z) footprint, and 32 consecutive z of one column, hit distinct banks
__host__ __device__ inline int mesh_row_stride(int ncol) {
  return ncol + ((5 - ncol) & 31);
}

__device__ __forceinline__ void horner_w(float d, const float* cf,
                                         float* w) {
#pragma unroll
  for (int a = 0; a < SP_P; ++a) {
    float v = 0.f;
#pragma unroll
    for (int l = SP_P - 1; l >= 0; --l) v = v * d + cf[a * SP_P + l];
    w[a] = v;
  }
}

struct SpreadArgs {
  const float* rows;   // (T, 8, cap) [lx, ly, lz, dxx, dxy, dxz, q, 0]
  const float* cf;     // (5, 5) B-spline coefficients
  int tlx, tly, ez, bw, ntx, nty, ntz, cap;
  int kcap;            // kept atoms per staging pass
  float* out;          // (ntx*tlx, nty*tly, ntz, ez)
};

// The source tile nb (0..8: x offset nb / 3 - 1, y offset nb % 3 - 1) of
// output tile (tx, ty, tz): its slot rows, and its origin shift into the
// output tile's frame.
__device__ __forceinline__ const float* mesh_source(const SpreadArgs& a,
                                                    int nb, int tx, int ty,
                                                    int tz, int* sx,
                                                    int* sy) {
  const int dx = nb / 3 - 1;
  const int dy = nb % 3 - 1;
  const int nx_t = (tx + dx + a.ntx) % a.ntx;
  const int ny_t = (ty + dy + a.nty) % a.nty;
  *sx = dx * a.tlx - a.bw;
  *sy = dy * a.tly - a.bw;
  const int64_t nt = (static_cast<int64_t>(nx_t) * a.nty + ny_t) * a.ntz + tz;
  return a.rows + nt * 8 * a.cap;
}

// The nine sources of a K2a tile (mesh_source), in shared memory.
struct SourceTab {
  const float* rows[9];
  int sx[9], sy[9];
};

// One staging pass of K2a: bin the pass's nk kept atoms (s_item: source
// << SP_SLOT_BITS | slot, s_key: origin cell) by origin cell with a stable
// counting sort, write their records at the sorted places, and add them
// into the accumulator, each warp over its own rows.  Every thread calls
// it (inlined: its pointers stay shared-memory ones).
__device__ __forceinline__ void spread_pass(
    const SpreadArgs& a, int nk, float* acc, int astr, float* rec,
    int* s_item, int* s_key, int* s_run, int* s_wsum, const float* s_cf,
    const SourceTab& src) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wid = tid >> 5;
  const int nwy = a.tly + SP_P - 1;
  const int ncell = (a.tlx + SP_P - 1) * nwy;
  __syncthreads();                  // the pass's items and keys written
  for (int c = tid; c < ncell; c += SP_TB) s_run[c] = 0;
  __syncthreads();
  for (int k = tid; k < nk; k += SP_TB) atomicAdd(&s_run[s_key[k]], 1);
  __syncthreads();
  // exclusive scan of the cell counts: a contiguous run of cells per thread
  const int per = (ncell + SP_TB - 1) / SP_TB;
  const int cb = min(tid * per, ncell);
  const int ce = min(cb + per, ncell);
  int loc = 0;
  for (int c = cb; c < ce; ++c) loc += s_run[c];
  int incl = loc;
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) s_wsum[wid] = incl;
  __syncthreads();
  int run = incl - loc;
  for (int w = 0; w < wid; ++w) run += s_wsum[w];
  for (int c = cb; c < ce; ++c) {
    const int v = s_run[c];
    s_run[c] = run;
    run += v;
  }
  __syncthreads();
  if (wid == 0) {
    // stable ranks: items in pass order, 32 at a time; s_key[k] becomes
    // the item's sorted place and s_run[c] the end of cell c
    const unsigned lt = (1u << lane) - 1u;
    for (int k0 = 0; k0 < nk; k0 += 32) {
      const int k = k0 + lane;
      const bool ok = k < nk;
      const int key = ok ? s_key[k] : -1 - lane;
      const unsigned peers = __match_any_sync(0xffffffffu, key);
      int pos = 0;
      if (ok) pos = s_run[key] + __popc(peers & lt);
      __syncwarp();
      if (ok) {
        s_key[k] = pos;
        if (31 - __clz(peers) == lane) s_run[key] += __popc(peers);
      }
      __syncwarp();
    }
  }
  __syncthreads();
  // each kept atom's record at its sorted place: wx[5], wy[5], q wz[5], a
  // pad, and as ints its origin ox, oy and z offset oz * astr
  for (int k = tid; k < nk; k += SP_TB) {
    const int it = s_item[k];
    const int nb = it >> SP_SLOT_BITS;
    const int sl = it & ((1 << SP_SLOT_BITS) - 1);
    const int sx = src.sx[nb];
    const int sy = src.sy[nb];
    const float* r = src.rows[nb];
    const float qv = r[6 * a.cap + sl];
    float w[15];
    horner_w(r[3 * a.cap + sl], s_cf, w);
    horner_w(r[4 * a.cap + sl], s_cf, w + 5);
    horner_w(r[5 * a.cap + sl], s_cf, w + 10);
#pragma unroll
    for (int c = 0; c < SP_P; ++c) w[10 + c] *= qv;
    float* rp = rec + SP_REC * s_key[k];
#pragma unroll
    for (int c = 0; c < 15; ++c) rp[c] = w[c];
    *reinterpret_cast<int4*>(rp + 16) = make_int4(
        static_cast<int>(r[sl]) + sx, static_cast<int>(r[a.cap + sl]) + sy,
        static_cast<int>(r[2 * a.cap + sl]) * astr, 0);
  }
  __syncthreads();
  // a warp per band of R = tlx / 8 accumulator rows (x) i0 .. i0 + R - 1:
  // its atoms are those of the origin cells with x index i0 .. i0 + R + 3,
  // one contiguous run of the sorted records, walked one atom at a time;
  // lane (b, cz) of 25 adds, for each row i of the band the atom reaches,
  // weight i - ox on x, b on y, cz on z.  No divergence, and the plane
  // stride astr = 5 (mod 32) puts the 25 lanes on distinct banks.
  const int b = lane / SP_P;
  const int cz = lane - b * SP_P;
  const int rb = (a.tlx + SP_TB / 32 - 1) / (SP_TB / 32);
  const int i0 = wid * rb;
  const int nr = min(rb, a.tlx - i0);
  if (nr > 0) {
    float* lacc = acc + cz * astr + i0 * a.tly + b;   // this lane's (b, cz)
    const int p1 = s_run[(i0 + nr + SP_P - 1) * nwy - 1];
    for (int p = i0 > 0 ? s_run[i0 * nwy - 1] : 0; p < p1; ++p) {
      const float* rp = rec + SP_REC * p;
      const int4 o = *reinterpret_cast<const int4*>(rp + 16);
      const int a0 = i0 - o.x;                         // weight of row i0
      const int j = o.y + b;
      if (lane < SP_P * SP_P && j >= 0 && j < a.tly) {
        const float wyz = rp[SP_P + b] * rp[2 * SP_P + cz];
        float* dst = lacc + o.z + o.y;
#pragma unroll 2
        for (int r = 0; r < nr; ++r) {
          const int ai = a0 + r;
          if (ai >= 0 && ai < SP_P) dst[r * a.tly] += rp[ai] * wyz;
        }
      }
    }
  }
  __syncthreads();                  // the arrays are free for the next pass
}

// One staged (source, slot) pair of K2a, as read: charge, origin patch
// coordinates, the source's origin shift, source << SP_SLOT_BITS | slot.
// q = 0 past the end.
struct Staged {
  float q, lx, ly;
  int sx, sy, item;
};

__device__ __forceinline__ Staged stage_load(const SpreadArgs& a,
                                             const int* s_base,
                                             const SourceTab& src, int g,
                                             int total) {
  Staged st{0.f, 0.f, 0.f, 0, 0, 0};
  if (g < total) {
    int nb = 0;
    while (g >= s_base[nb + 1]) ++nb;
    const int sl = g - s_base[nb];
    const float* r = src.rows[nb];
    st.sx = src.sx[nb];
    st.sy = src.sy[nb];
    st.q = r[6 * a.cap + sl];
    st.lx = r[sl];
    st.ly = r[a.cap + sl];
    st.item = nb << SP_SLOT_BITS | sl;
  }
  return st;
}

// The tile's columns into the mesh, each warp its band of rows (as in the
// accumulation), a column at a time, lanes over its ez contiguous nodes;
// zeros when acc is null.
__device__ __forceinline__ void write_tile(const SpreadArgs& a, int tx,
                                          int ty, int tz, const float* acc,
                                          int astr) {
  const int lane = threadIdx.x & 31;
  const int rb = (a.tlx + SP_TB / 32 - 1) / (SP_TB / 32);
  const int i0 = (threadIdx.x >> 5) * rb;
  const int nr = min(rb, a.tlx - i0);
  const int64_t cstride = static_cast<int64_t>(a.ntz) * a.ez;
  for (int r = 0; r < nr; ++r) {
    const int i = i0 + r;
    float* o = a.out + ((static_cast<int64_t>(tx * a.tlx + i) * a.nty *
                         a.tly + ty * a.tly) * a.ntz + tz) * a.ez;
#pragma unroll 4
    for (int j = 0; j < a.tly; ++j, o += cstride) {
      const int col = i * a.tly + j;
      for (int z = lane; z < a.ez; z += 32) {
        o[z] = acc == nullptr ? 0.f : acc[z * astr + col];
      }
    }
  }
}

__global__ void __launch_bounds__(SP_TB, 3) spread_mesh_kernel(SpreadArgs a) {
  extern __shared__ float4 s_dyn4[];
  const int ncol = a.tlx * a.tly;
  const int astr = mesh_row_stride(ncol);
  const int kc = a.kcap;
  float* rec = reinterpret_cast<float*>(s_dyn4);  // (kcap, 16) records
  float* acc = rec + SP_REC * kc;               // (ez, astr)
  int* s_item = reinterpret_cast<int*>(acc + a.ez * astr);  // src, slot
  int* s_key = s_item + kc;                     // (kcap) origin cell
  int* s_run = s_key + kc;                      // (ncell) cell bounds
  __shared__ float s_cf[SP_P * SP_P];
  __shared__ int s_last[SP_TB / 32][9];
  __shared__ int s_base[10];
  __shared__ int s_wc[2][SP_TB / 32];
  __shared__ int s_wsum[SP_TB / 32];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wid = tid >> 5;
  const int t = blockIdx.x;
  const int tz = t % a.ntz;
  const int ty = (t / a.ntz) % a.nty;
  const int tx = t / (a.ntz * a.nty);
  __shared__ SourceTab s_src;
  if (tid < SP_P * SP_P) s_cf[tid] = a.cf[tid];
  if (tid < 9) {
    s_src.rows[tid] = mesh_source(a, tid, tx, ty, tz, &s_src.sx[tid],
                                  &s_src.sy[tid]);
  }
  // each source's count: one past its last charged slot (the slots after
  // it add nothing); the nine sources' charges are read in one pass
  {
    const float* src[9];
    int last[9];
#pragma unroll
    for (int nb = 0; nb < 9; ++nb) {
      int sx, sy;
      src[nb] = mesh_source(a, nb, tx, ty, tz, &sx, &sy) + 6 * a.cap;
      last[nb] = 0;
    }
    for (int k = tid; k < a.cap; k += SP_TB) {
#pragma unroll
      for (int nb = 0; nb < 9; ++nb) {
        if (src[nb][k] != 0.f) last[nb] = k + 1;
      }
    }
#pragma unroll
    for (int nb = 0; nb < 9; ++nb) {
      last[nb] = __reduce_max_sync(0xffffffffu, last[nb]);
      if (lane == 0) s_last[wid][nb] = last[nb];
    }
  }
  __syncthreads();
  if (wid == 0) {
    // lane nb: its source's count over the warps, then a scan
    int cnt = 0;
    if (lane < 9) {
      for (int w = 0; w < SP_TB / 32; ++w) cnt = max(cnt, s_last[w][lane]);
    }
    for (int o = 1; o < 16; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, cnt, o);
      if (lane >= o) cnt += v;
    }
    if (lane < 9) s_base[lane + 1] = cnt;
    if (lane == 0) s_base[0] = 0;
  }
  __syncthreads();
  const int total = s_base[9];
  if (total == 0) {
    // no source holds a charge: the tile is zero
    write_tile(a, tx, ty, tz, nullptr, astr);
    return;
  }
  {
    // acc follows kcap 80-byte records: 16-byte aligned
    float4* acc4 = reinterpret_cast<float4*>(acc);
    const int n4 = a.ez * astr / 4;
    for (int k = tid; k < n4; k += SP_TB) {
      acc4[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    for (int k = 4 * n4 + tid; k < a.ez * astr; k += SP_TB) acc[k] = 0.f;
  }

  // staging: the (source, slot) pairs before each source's count, source
  // by source, 256 per round; an atom is kept if it is charged and its
  // footprint reaches the tile (origin in [-4, tl - 1] on x and y)
  const unsigned lt = (1u << lane) - 1u;
  const int nwy = a.tly + SP_P - 1;
  int nk = 0;
  // each round's slot rows are read one round ahead
  Staged cur = stage_load(a, s_base, s_src, tid, total);
  for (int g0 = 0, rnd = 0; g0 < total; g0 += SP_TB, ++rnd) {
    const Staged nxt = stage_load(a, s_base, s_src, g0 + SP_TB + tid,
                                  total);
    const int ox = static_cast<int>(cur.lx) + cur.sx;
    const int oy = static_cast<int>(cur.ly) + cur.sy;
    const bool keep = cur.q != 0.f && ox < a.tlx && ox + SP_P > 0 &&
                      oy < a.tly && oy + SP_P > 0;
    const int key = (ox + SP_P - 1) * nwy + oy + SP_P - 1;
    const int item = cur.item;
    const unsigned bal = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) s_wc[rnd & 1][wid] = __popc(bal);
    __syncthreads();
    int off = 0, round_n = 0;
    for (int w = 0; w < SP_TB / 32; ++w) {
      const int c = s_wc[rnd & 1][w];
      off += w < wid ? c : 0;
      round_n += c;
    }
    if (nk + round_n > kc) {
      // the pass is full: bin and add it, then stage on from an empty one
      spread_pass(a, nk, acc, astr, rec, s_item, s_key, s_run, s_wsum, s_cf,
                  s_src);
      nk = 0;
    }
    if (keep) {
      const int dst = nk + off + __popc(bal & lt);
      s_item[dst] = item;
      s_key[dst] = key;
    }
    nk += round_n;
    cur = nxt;
  }
  if (nk > 0) {
    spread_pass(a, nk, acc, astr, rec, s_item, s_key, s_run, s_wsum, s_cf,
                s_src);
  }
  __syncthreads();
  write_tile(a, tx, ty, tz, acc, astr);
}

struct TilesArgs {
  const float* rows;   // (T, 8, cap) [lx, ly, lz, dxx, dxy, dxz, q, 0]
  const float* cf;     // (5, 5) B-spline coefficients
  int ex, ey, ez, cap;
  float* out;          // (T, ex*ey, ez)
};

__global__ void __launch_bounds__(SP_TB) spread_tiles_kernel(TilesArgs a) {
  extern __shared__ float s_dyn[];
  const int ncol = a.ex * a.ey;
  float* acc = s_dyn;                           // (ez, ncol)
  float* sw = acc + ncol * a.ez;                // (SP_CHUNK, 15) weights
  int* so = reinterpret_cast<int*>(sw + SP_CHUNK * 15);  // (SP_CHUNK, 3)
  __shared__ float s_cf[SP_P * SP_P];
  __shared__ int s_wcount[SP_TB / 32];
  __shared__ int s_total;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int64_t t = blockIdx.x;
  const float* r = a.rows + t * 8 * a.cap;
  if (tid < SP_P * SP_P) s_cf[tid] = a.cf[tid];
  for (int k = tid; k < ncol * a.ez; k += SP_TB) acc[k] = 0.f;
  // the tile's count: one past its last charged slot (block max)
  int last = 0;
  for (int k = tid; k < a.cap; k += SP_TB) {
    if (r[6 * a.cap + k] != 0.f) last = k + 1;
  }
  last = __reduce_max_sync(0xffffffffu, last);
  if (lane == 0) s_wcount[tid >> 5] = last;
  __syncthreads();
  int count = 0;
  for (int k = 0; k < SP_TB / 32; ++k) count = max(count, s_wcount[k]);

  for (int c0 = 0; c0 < count; c0 += SP_CHUNK) {
    __syncthreads();          // s_wcount read; previous chunk consumed
    bool keep = false;
    float w[15];
    int ox = 0, oy = 0, oz = 0, rank = 0;
    if (tid < SP_CHUNK) {     // whole warps 0..3
      const int sl = c0 + tid;
      if (sl < count) {
        const float qv = r[6 * a.cap + sl];
        keep = qv != 0.f;
        if (keep) {
          ox = static_cast<int>(r[sl]);
          oy = static_cast<int>(r[a.cap + sl]);
          oz = static_cast<int>(r[2 * a.cap + sl]);
          horner_w(r[3 * a.cap + sl], s_cf, w);
          horner_w(r[4 * a.cap + sl], s_cf, w + 5);
          horner_w(r[5 * a.cap + sl], s_cf, w + 10);
#pragma unroll
          for (int c = 0; c < SP_P; ++c) w[10 + c] *= qv;
        }
      }
      const unsigned bal = __ballot_sync(0xffffffffu, keep);
      if (lane == 0) s_wcount[tid >> 5] = __popc(bal);
      rank = __popc(bal & ((1u << lane) - 1u));
    }
    __syncthreads();
    if (tid == 0) {
      int acc_n = 0;
      for (int k = 0; k < SP_CHUNK / 32; ++k) {
        const int c = s_wcount[k];
        s_wcount[k] = acc_n;
        acc_n += c;
      }
      s_total = acc_n;
    }
    __syncthreads();
    if (keep) {
      const int dst = s_wcount[tid >> 5] + rank;
#pragma unroll
      for (int k = 0; k < 15; ++k) sw[dst * 15 + k] = w[k];
      so[dst * 3] = ox;
      so[dst * 3 + 1] = oy;
      so[dst * 3 + 2] = oz;
    }
    __syncthreads();
    const int total = s_total;
    for (int col = tid; col < ncol; col += SP_TB) {
      const int i = col / a.ey;
      const int j = col % a.ey;
      for (int k = 0; k < total; ++k) {
        const int ai = i - so[k * 3];
        const int bj = j - so[k * 3 + 1];
        if (static_cast<unsigned>(ai) >= SP_P ||
            static_cast<unsigned>(bj) >= SP_P) {
          continue;
        }
        const float* wk = sw + k * 15;
        const float wxy = wk[ai] * wk[5 + bj];
        const int z0 = so[k * 3 + 2];
#pragma unroll
        for (int c = 0; c < SP_P; ++c) {
          const int z = z0 + c;
          if (z >= 0 && z < a.ez) acc[z * ncol + col] += wxy * wk[10 + c];
        }
      }
    }
  }
  __syncthreads();
  // coalesced write-out: z fastest
  float* o = a.out + t * ncol * a.ez;
  for (int k = tid; k < ncol * a.ez; k += SP_TB) {
    o[k] = acc[(k % a.ez) * ncol + k / a.ez];
  }
}

}  // namespace conp2

extern "C" {

// out (T, ex*ey, ez) float32 per-tile patches from the slot rows.  Returns
// cudaGetLastError().
int conp2_spread_tiles_f32(const float* rows, const float* cf, int t_tiles,
                           int ex, int ey, int ez, int cap, float* out,
                           void* stream) {
  if (t_tiles <= 0 || ex <= 0 || ey <= 0 || ez <= 0 || cap <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  conp2::TilesArgs a{rows, cf, ex, ey, ez, cap, out};
  const size_t smem = (static_cast<size_t>(ex) * ey * ez +
                       conp2::SP_CHUNK * 15 + conp2::SP_CHUNK * 3) *
                      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      conp2::spread_tiles_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  conp2::spread_tiles_kernel<<<t_tiles, conp2::SP_TB, smem,
                               static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Kept atoms per staging pass of K2a at these tile sizes: what fits beside
// the accumulator and the origin cells in SP_MESH_BUDGET, in whole warps,
// and at least one round of SP_TB.
int conp2_spread_mesh_pass_cap(int tlx, int tly, int ez) {
  const int fixed = 4 * (ez * conp2::mesh_row_stride(tlx * tly) +
                         (tlx + conp2::SP_P - 1) * (tly + conp2::SP_P - 1));
  const int k = (conp2::SP_MESH_BUDGET - conp2::SP_STATIC - fixed) /
                conp2::SP_ITEM_BYTES / 32 * 32;
  return k > conp2::SP_TB ? k : conp2::SP_TB;
}

// out (ntx*tlx, nty*tly, ntz, ez) float32 from the slot rows.  Returns
// cudaGetLastError().
int conp2_spread_mesh_f32(const float* rows, const float* cf, int tlx,
                          int tly, int ez, int bw, int ntx, int nty, int ntz,
                          int cap, float* out, void* stream) {
  if (tlx <= 0 || tly <= 0 || ez <= 0 || ntx <= 0 || nty <= 0 || ntz <= 0 ||
      cap <= 0 || cap > (1 << conp2::SP_SLOT_BITS) ||
      tlx + conp2::SP_P > 256 || tly + conp2::SP_P > 256 || ez >= (1 << 14)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int kcap = conp2_spread_mesh_pass_cap(tlx, tly, ez);
  conp2::SpreadArgs a{rows, cf, tlx, tly, ez, bw, ntx, nty, ntz, cap, kcap,
                      out};
  const size_t smem =
      4 * (static_cast<size_t>(ez) * conp2::mesh_row_stride(tlx * tly) +
           static_cast<size_t>(tlx + conp2::SP_P - 1) *
               (tly + conp2::SP_P - 1)) +
      static_cast<size_t>(kcap) * conp2::SP_ITEM_BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      conp2::spread_mesh_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nblocks = ntx * nty * ntz;
  conp2::spread_mesh_kernel<<<nblocks, conp2::SP_TB, smem,
                              static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
