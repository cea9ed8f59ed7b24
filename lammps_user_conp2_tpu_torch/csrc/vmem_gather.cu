// Window gather probe (K9): for each block t, lane l and row w,
//   out[t, w, l] = sum_{r=0}^{R-1} win[t, (idx[t, w, l] + r) mod W, l],
// win (nb, W, 128) float32, idx (nb, W, 128) int32, out (nb, W, 128) float32.
// Every lane gathers along its own column, from a window held on chip.
//
// Replaces the TPU kernel in tools/exp_vmem_gather.py, run_probe (body
// gather_kernel): R dependent take_along_axis ops on a VMEM-resident
// (W, 128) window.
//
// What bounds it on this card: bytes.  win, idx and out cross HBM once
// each (3 nb W 128 4 B); the R nb W 128 adds are ~50x below that.  What the
// probe measures beyond the bytes is the rate of random-row reads from
// shared memory, bank conflicts included.
//
// Design.  The TPU block holds the whole (W, 128) window; a CTA has at most
// 227 KB of shared memory, and columns are independent, so a work item is
// one (t, group of C lanes): its W x C slice of the window is all the
// gather of those lanes reads.  The wrapper's plan (ops/kernels/
// vmem_gather.py window_plan) takes the widest C of 16, 8, 4 whose slice
// fits once: 16 at W = 2048, 8 at 4096, 4 at 8192.  Width comes first:
// each halving of C halves the bytes a row chunk moves per request and
// doubled the kernel's time at W = 4096, far more than any overlap buys.
//
// - Persistent CTAs, one per SM (grid = min(items, SMs)), each walks the
//   items blockIdx.x + k gridDim.x.  Item = t G + g, so the CTAs of one
//   round hold neighbouring lane groups of the same rows, whose row chunks
//   then share L2 lines.  No ragged second wave: the rounds differ by at
//   most one item per CTA.
// - The window slice arrives by the Tensor Memory Accelerator: one thread
//   issues C lanes x box_rows (<= 256) row boxes of a 3-d tensor map over
//   win (rows past W zero-filled, never read) onto the item's mbarrier,
//   which expects the boxes' bytes.  The boxes land in a ring of box slots
//   (box seq of the walk in slot seq % slots) that holds one window and as
//   many slots more, up to a second window, as fit in 192 KB: once item
//   k's window has landed, item k + 1's first boxes go into the free slots
//   and load during item k's gather; the rest follow when item k is done.
//   The 192 KB cap leaves the SM's L1 room for the idx loads in flight (a
//   fuller ring ran slower).
// - idx and out go between HBM and registers, one lane per thread and C
//   lanes of 1024 / C rows per pass; a thread's U = 8 passes form a batch,
//   and the idx loads of the next batch (the next item's first, across an
//   item boundary) are issued before the current batch is gathered:
//   1024 x 8 x 4 B = 32 KB of idx in flight per SM, against the ~20 KB that
//   hides HBM latency at 3.35 TB/s over 132 SMs; each load asks L2 for the
//   256 bytes around it, which the round's other lane groups read.
// - Shared layout [w][c], row stride C, as the TMA box lands it.
//   Consecutive threads take consecutive lanes, so a warp covers 32 / C
//   rows x C lanes and lane (w, c) reads bank (j C + c) mod 32 for its
//   random row j: threads of different lanes never share a bank, and the
//   32 / C threads of one lane collide only where their random rows agree
//   mod 32 / C.  The conflicts come from the data, as the probe intends,
//   not from the layout.  A row's R terms are R rows apart by C floats;
//   where they wrap neither the window nor the ring, they are read at
//   fixed offsets from one address.
//
// (ix + r) mod W is ix mod W (torch.remainder semantics) advanced by one
// with a wrap per term, and the R terms are added in order r = 0 ... R-1
// into a zero accumulator: bit for bit the plain version's sums.
#include <cstdint>

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_runtime.h>

namespace conp2 {

constexpr int WG_TB = 1024;       // threads per CTA
constexpr int WG_LANES = 128;
constexpr int WG_U = 8;           // passes per batch of idx loads
constexpr int WG_BAR_BYTES = 128;  // the mbarriers, ahead of the ring
constexpr int WG_BOX_MAX = 256;   // a TMA box dimension's limit
constexpr int WG_SMEM_MAX = 232448;  // dynamic shared memory of a CTA

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(1u)
               : "memory");
}

// the one arrival of a phase, and the bytes its copies will bring
__device__ __forceinline__ void bar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes)
               : "memory");
}

// a copy that never lands (a refused box) traps after ~2^26 tries, and the
// launch fails, instead of spinning the card
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    if (tries == (1u << 26)) __trap();
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// a 4-byte idx load that asks L2 for the 256 bytes around it: the other
// lane groups' CTAs of the same round read the rest of those rows
__device__ __forceinline__ int ldg_l2_256(const int* p) {
  int v;
  asm("ld.global.nc.L2::256B.b32 %0, [%1];\n" : "=r"(v) : "l"(p));
  return v;
}

// RT > 0: R fixed at compile time (the probe's R = 8, the library
// comparison's R = 1); RT == 0: the runtime loop over R.
template <int C, int RT>
__global__ void __launch_bounds__(WG_TB, 1)
window_gather_kernel(const __grid_constant__ CUtensorMap wmap,
                     const int* __restrict__ idx, int nb, int W, int R,
                     int box_rows, int nbox, int slots,
                     float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int G = WG_LANES / C;  // items (lane groups) per block t
  constexpr int P = WG_TB / C;     // rows per pass
  const int items = nb * G;
  const int ring_rows = slots * box_rows;
  const uint32_t box_bytes = box_rows * C * 4;
  const uint32_t bar0 = smem_addr(smem);  // two barriers, 8 bytes apart
  const uint32_t ring0 = bar0 + WG_BAR_BYTES;
  const float* ring = reinterpret_cast<const float*>(smem + WG_BAR_BYTES);
  const int tid = threadIdx.x;
  const int c = tid % C;
  const int r0 = tid / C;
  const int mine = (items - 1 - static_cast<int>(blockIdx.x)) /
                       static_cast<int>(gridDim.x) + 1;
  const int batches = ((W + P - 1) / P + WG_U - 1) / WG_U;
  const int total = mine * batches;
  const CUtensorMap* map = &wmap;

  // thread 0: the boxes seq < limit not yet issued, in order; box seq is
  // box q = seq % nbox of item k = seq / nbox and lands in slot seq % slots
  int next_box = 0;
  auto issue_upto = [&](int limit) {
    limit = min(limit, mine * nbox);
    for (; next_box < limit; ++next_box) {
      const int k = next_box / nbox;
      const int q = next_box - k * nbox;
      const int item = blockIdx.x + k * gridDim.x;
      const int t = item / G;
      const int g = item - t * G;
      const uint32_t bar = bar0 + 8 * (k & 1);
      if (q == 0) bar_expect(bar, nbox * box_bytes);
      tma_load(ring0 + (next_box % slots) * box_bytes, map, bar, g * C,
               q * box_rows, t);
    }
  };
  // the idx of batch ``it`` of this CTA's walk (rows past W read nothing)
  auto load = [&](int it, int (&v)[WG_U]) {
    const int k = it / batches;
    const int bi = it - k * batches;
    const int item = blockIdx.x + k * gridDim.x;
    const int t = item / G;
    const int g = item - t * G;
    const int* src = idx + static_cast<int64_t>(t) * W * WG_LANES + g * C + c;
#pragma unroll
    for (int u = 0; u < WG_U; ++u) {
      const int w = (bi * WG_U + u) * P + r0;
      v[u] = w < W ? ldg_l2_256(src + static_cast<int64_t>(w) * WG_LANES)
                   : 0;
    }
  };

  if (tid == 0) {
    bar_init(bar0);
    bar_init(bar0 + 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) issue_upto(nbox);  // item 0's window first, alone
  int nxt[WG_U];
  load(0, nxt);
  for (int it = 0; it < total; ++it) {
    int cur[WG_U];
#pragma unroll
    for (int u = 0; u < WG_U; ++u) cur[u] = nxt[u];
    if (it + 1 < total) load(it + 1, nxt);
    const int k = it / batches;
    const int bi = it - k * batches;
    if (bi == 0) {
      bar_wait(bar0 + 8 * (k & 1), (k >> 1) & 1);
      // item k's window has landed: item k + 1's boxes into the free slots
      if (tid == 0) issue_upto(min(k * nbox + slots, (k + 2) * nbox));
    }
    const int item = blockIdx.x + k * gridDim.x;
    const int t = item / G;
    const int g = item - t * G;
    const int base = ((k * nbox) % slots) * box_rows;  // ring row of row 0
    float* dst = out + static_cast<int64_t>(t) * W * WG_LANES + g * C + c;
#pragma unroll
    for (int u = 0; u < WG_U; ++u) {
      const int w = (bi * WG_U + u) * P + r0;
      if (w < W) {
        int j = cur[u];
        if (static_cast<unsigned>(j) >= static_cast<unsigned>(W)) {
          j %= W;
          if (j < 0) j += W;
        }
        int rr = base + j;
        if (rr >= ring_rows) rr -= ring_rows;
        float acc = 0.f;
        const int run = RT > 0 ? RT : R;
        if (j <= W - run && rr <= ring_rows - run) {
          // the R rows neither wrap the window nor the ring: one address,
          // the terms at fixed offsets
          const float* p = ring + rr * C + c;
          if constexpr (RT > 0) {
#pragma unroll
            for (int r = 0; r < RT; ++r) acc = acc + p[r * C];
          } else {
            for (int r = 0; r < R; ++r) acc = acc + p[r * C];
          }
        } else {
          for (int r = 0; r < run; ++r) {
            acc = acc + ring[rr * C + c];
            if (++j == W) {
              j = 0;
              rr = base;
            } else if (++rr == ring_rows) {
              rr = 0;
            }
          }
        }
        dst[static_cast<int64_t>(w) * WG_LANES] = acc;
      }
    }
    // item k done: its slots take the rest of item k + 1's boxes
    if (bi == batches - 1 && k + 1 < mine) {
      __syncthreads();
      if (tid == 0) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        issue_upto(min((k + 1) * nbox + slots, (k + 2) * nbox));
      }
    }
  }
}

template <int C, int RT>
cudaError_t launch_window_gather(const CUtensorMap& map, const int* idx,
                                 int nb, int W, int R, int box_rows, int nbox,
                                 int slots, int grid, int smem, float* out,
                                 cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      window_gather_kernel<C, RT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  window_gather_kernel<C, RT><<<grid, WG_TB, smem, s>>>(
      map, idx, nb, W, R, box_rows, nbox, slots, out);
  return cudaGetLastError();
}

template <int C>
cudaError_t dispatch_r(const CUtensorMap& map, const int* idx, int nb, int W,
                       int R, int box_rows, int nbox, int slots, int grid,
                       int smem, float* out, cudaStream_t s) {
  if (R == 8)
    return launch_window_gather<C, 8>(map, idx, nb, W, R, box_rows, nbox,
                                      slots, grid, smem, out, s);
  if (R == 1)
    return launch_window_gather<C, 1>(map, idx, nb, W, R, box_rows, nbox,
                                      slots, grid, smem, out, s);
  return launch_window_gather<C, 0>(map, idx, nb, W, R, box_rows, nbox,
                                    slots, grid, smem, out, s);
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime, so the
// library needs no -lcuda
cudaError_t encoder(EncodeTiledFn* fn) {
  static EncodeTiledFn cached = nullptr;
  if (cached == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || p == nullptr)
      return cudaErrorSymbolNotFound;
    cached = reinterpret_cast<EncodeTiledFn>(p);
  }
  *fn = cached;
  return cudaSuccess;
}

}  // namespace conp2

extern "C" {

// Status of a tensor map that cuTensorMapEncodeTiled refused: this plus
// its CUresult (CUDA runtime errors are below it).
constexpr int CONP2_ENCODE_FAILED = 10000;

// out (nb, W, 128) float32.  The plan (vmem_gather.window_plan): cols lanes
// per item (16/8/4), box_rows rows per TMA box (<= 256; box_rows cols 4
// bytes a multiple of 128), slots boxes in the shared ring (>= the boxes of
// one window, <= two windows'), grid persistent CTAs (<= the items
// nb 128 / cols).  win must be 16-byte aligned.  Returns 0, the first CUDA
// error (a refused shared-memory request or launch is not run and is
// reported), or CONP2_ENCODE_FAILED + the encoder's CUresult.
int conp2_window_gather_f32(const float* win, const int* idx, int nb, int W,
                            int R, int cols, int box_rows, int slots,
                            int grid, float* out, void* stream) {
  const int items = cols > 0 ? nb * (conp2::WG_LANES / cols) : 0;
  const int nbox = box_rows > 0 ? (W + box_rows - 1) / box_rows : 0;
  const long long smem =
      conp2::WG_BAR_BYTES + static_cast<long long>(slots) * box_rows * cols * 4;
  if (nb <= 0 || W <= 0 || R <= 0 || box_rows <= 0 ||
      box_rows > conp2::WG_BOX_MAX || (box_rows * cols * 4) % 128 != 0 ||
      slots < nbox || slots > 2 * nbox || grid <= 0 || grid > items ||
      smem > conp2::WG_SMEM_MAX ||
      reinterpret_cast<uintptr_t>(win) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  conp2::EncodeTiledFn encode;
  cudaError_t err = conp2::encoder(&encode);
  if (err != cudaSuccess) return static_cast<int>(err);
  // win as a 3-d tensor (lanes, rows, blocks), innermost first; a box is
  // cols lanes x box_rows rows of one block
  CUtensorMap map;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(conp2::WG_LANES),
                              static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(nb)};
  const cuuint64_t strides[2] = {
      static_cast<cuuint64_t>(conp2::WG_LANES) * 4,
      static_cast<cuuint64_t>(W) * conp2::WG_LANES * 4};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(cols),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult res = encode(
      &map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
      const_cast<float*>(win), dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return CONP2_ENCODE_FAILED + static_cast<int>(res);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int sm = static_cast<int>(smem);
  switch (cols) {
    case 16:
      return static_cast<int>(conp2::dispatch_r<16>(
          map, idx, nb, W, R, box_rows, nbox, slots, grid, sm, out, s));
    case 8:
      return static_cast<int>(conp2::dispatch_r<8>(
          map, idx, nb, W, R, box_rows, nbox, slots, grid, sm, out, s));
    case 4:
      return static_cast<int>(conp2::dispatch_r<4>(
          map, idx, nb, W, R, box_rows, nbox, slots, grid, sm, out, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
