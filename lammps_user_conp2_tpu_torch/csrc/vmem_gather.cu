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
// Design: the TPU block holds the whole (W, 128) window (1 MiB at W = 2048,
// 4 MiB at W = 8192); a CTA has at most 227 KB of shared memory.  Columns
// are independent, so one CTA per (t, group of C lanes) stages that group's
// W x C slice in dynamic shared memory (C the largest of 16, 8, 4 with
// W C 4 B <= the wrapper's budget: 16 / 8 / 4 at W = 2048 / 4096 / 8192,
// 128 KB each, one CTA per SM).  Staging reads float4s.  The CTAs of one t are adjacent in the grid, so the
// narrow row chunks of neighbouring groups share L2 sectors.  Then each
// thread computes outputs of its column with R shared-memory reads.
//
// Staging layout [w][c], row stride C.  Consecutive threads take
// consecutive columns, so a warp covers 32/C rows x C columns and lane
// (w, c) reads bank (j C + c) mod 32 for its random row j: threads of
// different columns never share a bank, and the 32/C threads of one
// column collide only where their random rows agree mod 32/C.  The
// conflicts come from the data, as the probe intends, not from the layout.
//
// (ix + r) mod W is ix mod W (torch.remainder semantics) advanced by one
// with a wrap per term, and the R terms are added in order r = 0 ... R-1
// into a zero accumulator: bit for bit the plain version's sums.
#include <cstdint>

#include <cuda_runtime.h>

namespace conp2 {

constexpr int WG_TB = 1024;
constexpr int WG_LANES = 128;

// RT > 0: R fixed at compile time (the probe's R = 8, the library
// comparison's R = 1); RT == 0: the runtime loop over R.
template <int C, int RT>
__global__ void __launch_bounds__(WG_TB)
window_gather_kernel(const float* __restrict__ win,
                     const int* __restrict__ idx, int W, int R,
                     float* __restrict__ out) {
  extern __shared__ float s_win[];          // [W][C]
  constexpr int GROUPS = WG_LANES / C;
  const int g = blockIdx.x % GROUPS;
  const int t = blockIdx.x / GROUPS;
  const int64_t base = static_cast<int64_t>(t) * W * WG_LANES + g * C;
  const int n = W * C;
  constexpr int V = C / 4;                  // float4 per row chunk
  float4* s4 = reinterpret_cast<float4*>(s_win);
  for (int k = threadIdx.x; k < W * V; k += WG_TB) {
    const int w = k / V;
    const int v = k % V;
    s4[k] = __ldg(reinterpret_cast<const float4*>(
        win + base + static_cast<int64_t>(w) * WG_LANES + 4 * v));
  }
  __syncthreads();
  for (int k = threadIdx.x; k < n; k += WG_TB) {
    const int w = k / C;
    const int c = k % C;
    const int64_t o = base + static_cast<int64_t>(w) * WG_LANES + c;
    int j = __ldg(idx + o);
    if (static_cast<unsigned>(j) >= static_cast<unsigned>(W)) {
      j %= W;
      if (j < 0) j += W;
    }
    float acc = 0.f;
    if constexpr (RT > 0) {
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        acc = acc + s_win[j * C + c];
        j = (j + 1 == W) ? 0 : j + 1;
      }
    } else {
      for (int r = 0; r < R; ++r) {
        acc = acc + s_win[j * C + c];
        j = (j + 1 == W) ? 0 : j + 1;
      }
    }
    out[o] = acc;
  }
}

template <int C, int RT>
cudaError_t launch_window_gather(const float* win, const int* idx, int nb,
                                 int W, int R, float* out, cudaStream_t s) {
  const size_t smem = static_cast<size_t>(W) * C * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      window_gather_kernel<C, RT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  window_gather_kernel<C, RT><<<nb * (WG_LANES / C), WG_TB, smem, s>>>(
      win, idx, W, R, out);
  return cudaGetLastError();
}

template <int C>
cudaError_t dispatch_r(const float* win, const int* idx, int nb, int W,
                       int R, float* out, cudaStream_t s) {
  if (R == 8) return launch_window_gather<C, 8>(win, idx, nb, W, R, out, s);
  if (R == 1) return launch_window_gather<C, 1>(win, idx, nb, W, R, out, s);
  return launch_window_gather<C, 0>(win, idx, nb, W, R, out, s);
}

}  // namespace conp2

extern "C" {

// out (nb, W, 128) float32; cols (the lanes a CTA stages, 4/8/16) sets the
// shared memory, W cols 4 bytes; win must be 16-byte aligned.  Returns the
// first CUDA error: a refused shared-memory request or launch is not run
// and is reported.
int conp2_window_gather_f32(const float* win, const int* idx, int nb, int W,
                            int R, int cols, float* out, void* stream) {
  if (nb <= 0 || W <= 0 || R <= 0 ||
      reinterpret_cast<uintptr_t>(win) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (cols) {
    case 16: err = conp2::dispatch_r<16>(win, idx, nb, W, R, out, s); break;
    case 8: err = conp2::dispatch_r<8>(win, idx, nb, W, R, out, s); break;
    case 4: err = conp2::dispatch_r<4>(win, idx, nb, W, R, out, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
