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
// What bounds it on this card: shared-memory read-modify-write of the
// accumulator (125 weighted adds per atom) and the weight arithmetic; the
// inputs (slot rows, 32 B per slot) and the output (one write per mesh
// node) are a few tens of MB at the 100k cell.
//
// Design: one CTA per output tile.  The tile's accumulator (16 x 16 x 38
// floats = 38.9 KB at the 100k cell) lives in shared memory, laid out
// z-major so a warp's threads touch consecutive banks.  Each thread OWNS
// xy columns of the tile (256 threads, 256 columns at the 100k cell): no
// two threads ever write one accumulator cell, so there are no atomics and
// the sums are deterministic.  Atoms are staged in chunks: each staging
// thread reads one slot, evaluates its 5 weights per axis by Horner (the
// coefficients of ops/pppm.py rho_coeffs, the same order as _horner_w),
// maps its stencil origin into this tile's frame, and keeps it only if the
// stencil reaches the tile and the charge is nonzero; a warp-ballot scan
// compacts the kept atoms in slot order.  Then every thread adds the kept
// atoms' contributions to its own columns.  Neighbour tiles contribute
// their border atoms only, so the compaction keeps the work near one
// tile's worth of atoms.  Tile indices wrap periodically in x and y, which
// also covers grids of one or two tiles per axis.
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
// slot order (no atomics, deterministic).  Staging and the ballot
// compaction of the charged slots are K2a's; a stencil node outside the
// patch gets no weight, as in the plain version's one-hot weights.
#include <cstdint>

#include "common.cuh"

namespace conp2 {

constexpr int SP_TB = 256;      // threads per CTA
constexpr int SP_CHUNK = 128;   // slots staged per round (threads 0..127)
constexpr int SP_P = 5;         // stencil order

struct SpreadArgs {
  const float* rows;   // (T, 8, cap) [lx, ly, lz, dxx, dxy, dxz, q, 0]
  const float* cf;     // (5, 5) B-spline coefficients
  int tlx, tly, ez, bw, ntx, nty, ntz, cap;
  float* out;          // (ntx*tlx, nty*tly, ntz, ez)
};

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

__global__ void __launch_bounds__(SP_TB) spread_mesh_kernel(SpreadArgs a) {
  extern __shared__ float s_dyn[];
  const int ncol = a.tlx * a.tly;
  float* acc = s_dyn;                           // (ez, ncol)
  float* sw = acc + ncol * a.ez;                // (SP_CHUNK, 15) weights
  int* so = reinterpret_cast<int*>(sw + SP_CHUNK * 15);  // (SP_CHUNK, 3)
  __shared__ float s_cf[SP_P * SP_P];
  __shared__ int s_wcount[SP_CHUNK / 32];
  __shared__ int s_total;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int t = blockIdx.x;
  const int tz = t % a.ntz;
  const int ty = (t / a.ntz) % a.nty;
  const int tx = t / (a.ntz * a.nty);
  if (tid < SP_P * SP_P) s_cf[tid] = a.cf[tid];
  for (int k = tid; k < ncol * a.ez; k += SP_TB) acc[k] = 0.f;

  for (int nb = 0; nb < 9; ++nb) {
    const int dx = nb / 3 - 1;
    const int dy = nb % 3 - 1;
    const int nx_t = (tx + dx + a.ntx) % a.ntx;
    const int ny_t = (ty + dy + a.nty) % a.nty;
    const int64_t nt = (static_cast<int64_t>(nx_t) * a.nty + ny_t) * a.ntz + tz;
    const float* r = a.rows + nt * 8 * a.cap;
    for (int c0 = 0; c0 < a.cap; c0 += SP_CHUNK) {
      __syncthreads();          // s_cf/acc ready; previous chunk consumed
      bool keep = false;
      float w[15];
      int ox = 0, oy = 0, oz = 0, rank = 0;
      if (tid < SP_CHUNK) {     // whole warps 0..3
        const int s = c0 + tid;
        if (s < a.cap) {
          const float qv = r[6 * a.cap + s];
          ox = static_cast<int>(r[s]) + dx * a.tlx - a.bw;
          oy = static_cast<int>(r[a.cap + s]) + dy * a.tly - a.bw;
          oz = static_cast<int>(r[2 * a.cap + s]);
          keep = qv != 0.f && ox < a.tlx && ox + SP_P > 0 && oy < a.tly &&
                 oy + SP_P > 0;
          if (keep) {
            horner_w(r[3 * a.cap + s], s_cf, w);
            horner_w(r[4 * a.cap + s], s_cf, w + 5);
            horner_w(r[5 * a.cap + s], s_cf, w + 10);
#pragma unroll
            for (int c = 0; c < SP_P; ++c) w[10 + c] *= qv;
          }
        }
        // deterministic compaction: rank within the warp by ballot, warp
        // totals prefixed in warp order below
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
        const int i = col / a.tly;
        const int j = col % a.tly;
        for (int k = 0; k < total; ++k) {
          const int ai = i - so[k * 3];
          const int bj = j - so[k * 3 + 1];
          if (static_cast<unsigned>(ai) >= SP_P ||
              static_cast<unsigned>(bj) >= SP_P) {
            continue;
          }
          const float* wk = sw + k * 15;
          const float wxy = wk[ai] * wk[5 + bj];
          float* dst_col = acc + so[k * 3 + 2] * ncol + col;
#pragma unroll
          for (int c = 0; c < SP_P; ++c) dst_col[c * ncol] += wxy * wk[10 + c];
        }
      }
    }
  }
  __syncthreads();
  // coalesced write-out: z fastest
  const int nyf = a.nty * a.tly;
  for (int k = tid; k < ncol * a.ez; k += SP_TB) {
    const int col = k / a.ez;
    const int z = k % a.ez;
    const int gx = tx * a.tlx + col / a.tly;
    const int gy = ty * a.tly + col % a.tly;
    a.out[((static_cast<int64_t>(gx) * nyf + gy) * a.ntz + tz) * a.ez + z] =
        acc[z * ncol + col];
  }
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

// out (ntx*tlx, nty*tly, ntz, ez) float32 from the slot rows.  Returns
// cudaGetLastError().
int conp2_spread_mesh_f32(const float* rows, const float* cf, int tlx,
                          int tly, int ez, int bw, int ntx, int nty, int ntz,
                          int cap, float* out, void* stream) {
  if (tlx <= 0 || tly <= 0 || ez <= 0 || ntx <= 0 || nty <= 0 || ntz <= 0 ||
      cap <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  conp2::SpreadArgs a{rows, cf, tlx, tly, ez, bw, ntx, nty, ntz, cap, out};
  const size_t smem = (static_cast<size_t>(tlx) * tly * ez +
                       conp2::SP_CHUNK * 15 + conp2::SP_CHUNK * 3) *
                      sizeof(float);
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
