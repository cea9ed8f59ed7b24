// The dense PPPM mesh's stencil spread and stencil readout: charges onto
// the (nx, ny, nz) mesh or onto the electrodes' z planes (nx, ny, P), and
// one to three mesh fields (or one potential's gradient) read at the atoms.
//
// Replaces no TPU kernel: the JAX package computes the dense path
// (ops/pppm.py spread, gather, gather3, gather3_ad, spread_zplanes,
// gather_zplanes) in XLA, as products of per-axis weight matrices (N, nx),
// (N, ny), (N, nz) whose xy outer product is an (N, nx*ny) matrix: a shape
// for a matrix unit.  On this card that formulation costs some 20 small
// launches per axis to build the stencils, the (N, nx*ny) products (14.5 MB
// at 3,776 atoms on the 30 x 32 x 80 mesh) and GEMMs over them, for work
// whose true size is p^3 nodes per atom and a 0.3 MB mesh per field.
//
// What bounds them on this card: launches and L2 reads, not device memory.
// At il_onelayer's sizes a field is 0.3 MB and the atoms 60 KB, all of it
// in L2; the bytes once at 3.35 TB/s are well under a microsecond.  So each
// call is ONE launch that forms every stencil in registers (the binning and
// the Horner weights of ops/pppm.py _stencil_full / _horner_w, with the
// same float32 roundings, no FMA contraction) and touches only the p^3
// nodes of each atom.
//
// Readout (stencil_readout_kernel): a warp per atom, lane l over the (a, b)
// = (l / p, l % p) xy pairs of its stencil (p^2 <= 32 up to order 5; a lane
// loops over pairs beyond 32), reading the p z nodes of each of the 1 to 3
// fields with the weights formed once for all fields.  The fields are read
// through their strides: the planes' potential comes out of its xy FFT
// plane-major, and a copy would be one more launch.  The xy
// sum is a fixed butterfly over the warp, so the result does not depend on
// scheduling.  The output row is written once, times the atom's charge
// where a scale is given (the ik forces' q E) and by a sign (b's -phi).
// With derivative weights (ad) the one field gives (w'x wy wz, wx w'y wz,
// wx wy w'z) times delinv, as K3 does.
//
// Spread (stencil_spread_kernel): one CTA per 4 x 4 x 16 tile of output
// nodes, a thread per node.  No atomics: the CTA walks all atoms in their
// order, 1,024 at a time (4 atoms a thread, their loads in flight
// together: the walk is bound by load latency, since every CTA runs at
// once), keeps those with a non-zero charge whose periodic
// footprint reaches the tile, compacts them by ballot into shared memory in
// atom order (their origin and 3p + 1 weights, formed once per CTA), and
// each node thread sums the staged atoms' terms (wx wy) (q wz) in that
// order; a full staging buffer is added before more atoms are staged.  So every
// node's sum takes its terms in the atoms' order, and two runs give the
// same bits.  Binning atoms by origin cell first (K2a's design) would need
// a device sort per call; at a few thousand atoms the walk is cheaper: the
// 320 CTAs of the 30 x 32 x 80 mesh test 3,776 atoms each, a few µs in
// all, and the electrode rows of the electrolyte spread (charge exactly
// zero) are never staged.
//
// A mesh axis shorter than the order (m < p) wraps several stencil columns
// onto one node: the spread adds them in stencil order, as
// ops/pppm.py _weight_matrix does, and the readout reads the node once per
// column.  On the z planes, a stencil node off the plane set makes the
// whole output NaN, as ops/pppm.py's _nan_where does: every CTA tests every
// atom's z stencil against the slot map, so the decision needs no second
// launch and no host read.
#include <cstdint>

#include "common.cuh"

namespace conp2 {

constexpr int MS_TX = 4;            // spread tile: x nodes
constexpr int MS_TY = 4;            //              y nodes
constexpr int MS_TZ = 16;           //              z nodes (or planes)
constexpr int MS_TB = MS_TX * MS_TY * MS_TZ;   // a thread per node
constexpr int MS_K = 4;             // atoms per thread per staging round
constexpr int MS_CAP = 384;         // staged atoms per pass
constexpr int MR_TB = 256;          // readout: 8 warps, an atom each

struct StencilGeom {
  int nx, ny, nz;       // the mesh
  int nzo;              // z extent of the fields / output: nz or P planes
  float lo[3];          // box_lo
  float s[3];           // n / L per axis (float32, as the plain version)
};

// One axis of an atom's stencil: the wrapped first node and the fractional
// offset dx, with ops/pppm.py _stencil_full's float32 operations:
// u = (x - lo) * s; odd p: m = floor(u + 1/2), dx = m - u; even p:
// m = floor(u), dx = (m + 1/2) - u; the first node m - (p - 1) / 2.
template <int P>
__device__ __forceinline__ int stencil_axis(float xc, float lo, float s,
                                            int n, float* dx) {
  const float u = __fmul_rn(__fsub_rn(xc, lo), s);
  float f;
  if (P % 2 == 1) {
    f = floorf(__fadd_rn(u, 0.5f));
    *dx = __fsub_rn(f, u);
  } else {
    f = floorf(u);
    *dx = __fsub_rn(__fadd_rn(f, 0.5f), u);
  }
  int m = (static_cast<int>(f) - (P - 1) / 2) % n;
  return m < 0 ? m + n : m;
}

// rho1d[a](dx) by Horner in _horner_w's order, mul and add rounded apart
template <int P>
__device__ __forceinline__ float horner_row(float d, const float* cf, int a) {
  float v = 0.f;
#pragma unroll
  for (int l = P - 1; l >= 0; --l) v = __fadd_rn(__fmul_rn(v, d), cf[a * P + l]);
  return v;
}

// d rho1d[a] / d dx in _horner_dw's order
template <int P>
__device__ __forceinline__ float horner_drow(float d, const float* cf,
                                             int a) {
  float v = 0.f;
#pragma unroll
  for (int l = P - 1; l >= 1; --l) {
    v = __fadd_rn(__fmul_rn(v, d), __fmul_rn(static_cast<float>(l),
                                             cf[a * P + l]));
  }
  return v;
}

// (o + k) mod n for a node 0 <= o < n and a stencil offset k >= 0
__device__ __forceinline__ int wrap_add(int o, int k, int n) {
  return (o + k) % n;
}

// Whether the periodic footprint [o, o + P) of an axis of n nodes meets
// the node interval [lo, hi] (0 <= lo <= hi < n): two cyclic intervals
// meet iff one's start lies in the other.
template <int P>
__device__ __forceinline__ bool reaches(int o, int lo, int hi, int n) {
  if (P >= n) return true;
  int d = lo - o;
  if (d < 0) d += n;
  if (d < P) return true;
  int e = o - lo;
  if (e < 0) e += n;
  return e <= hi - lo;
}

// Whether a stencil of P z nodes from oz leaves the plane set.
template <int P>
__device__ __forceinline__ bool off_planes(int oz, int nz,
                                           const int* __restrict__ zinv) {
  bool bad = false;
#pragma unroll
  for (int k = 0; k < P; ++k) bad |= __ldg(zinv + wrap_add(oz, k, nz)) < 0;
  return bad;
}

template <int P>
__global__ void __launch_bounds__(MS_TB)
stencil_spread_kernel(const float* __restrict__ x,
                      const float* __restrict__ q,
                      const float* __restrict__ cf,
                      const int* __restrict__ zinv,
                      const int* __restrict__ znode, int n, StencilGeom g,
                      int tiles_y, int tiles_z, float* __restrict__ out) {
  __shared__ float s_cf[P * P];
  __shared__ int s_o[3][MS_CAP];
  __shared__ float s_w[3 * P + 1][MS_CAP];    // wx, wy, wz, q
  __shared__ int s_wsum[MS_K][MS_TB / 32];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wid = tid >> 5;
  if (tid < P * P) s_cf[tid] = cf[tid];
  const int b = blockIdx.x;
  const int x0 = (b / (tiles_z * tiles_y)) * MS_TX;
  const int y0 = ((b / tiles_z) % tiles_y) * MS_TY;
  const int z0 = (b % tiles_z) * MS_TZ;
  const int x1 = min(x0 + MS_TX, g.nx) - 1;
  const int y1 = min(y0 + MS_TY, g.ny) - 1;
  const int z1 = min(z0 + MS_TZ, g.nzo) - 1;
  // the tile's z interval in mesh nodes (planes are sorted by node)
  const int zlo = znode ? __ldg(znode + z0) : z0;
  const int zhi = znode ? __ldg(znode + z1) : z1;
  const int i = x0 + tid / (MS_TZ * MS_TY);
  const int j = y0 + (tid / MS_TZ) % MS_TY;
  const int k = z0 + tid % MS_TZ;
  const bool node = i <= x1 && j <= y1 && k <= z1;
  const int kz = node ? (znode ? __ldg(znode + k) : k) : 0;
  float acc = 0.f;
  bool bad = false;
  int count = 0;
  __syncthreads();

  // the staged atoms' terms at this thread's node, in staging order
  auto add_staged = [&](int cnt) {
    if (!node) return;
    for (int r = 0; r < cnt; ++r) {
      int dx = i - s_o[0][r];
      if (dx < 0) dx += g.nx;
      int dy = j - s_o[1][r];
      if (dy < 0) dy += g.ny;
      int dz = kz - s_o[2][r];
      if (dz < 0) dz += g.nz;
      if (dx >= P || dy >= P || dz >= P) continue;
      float wx = 0.f, wy = 0.f, wz = 0.f;
      for (int s = dx; s < P; s += g.nx) wx = __fadd_rn(wx, s_w[s][r]);
      for (int s = dy; s < P; s += g.ny) wy = __fadd_rn(wy, s_w[P + s][r]);
      for (int s = dz; s < P; s += g.nz) {
        wz = __fadd_rn(wz, s_w[2 * P + s][r]);
      }
      acc = fmaf(__fmul_rn(wx, wy), __fmul_rn(s_w[3 * P][r], wz), acc);
    }
  };

  for (int base = 0; base < n; base += MS_TB * MS_K) {
    // atoms base + u * MS_TB + tid, u < MS_K: their loads in flight
    // together, each load coalesced across the CTA
    int o[MS_K][3];
    float d[MS_K][3], qa[MS_K];
    bool keep[MS_K];
#pragma unroll
    for (int u = 0; u < MS_K; ++u) {
      const int a = base + u * MS_TB + tid;
      keep[u] = false;
      qa[u] = 0.f;
      o[u][0] = o[u][1] = o[u][2] = 0;
      d[u][0] = d[u][1] = d[u][2] = 0.f;
      if (a < n) {
        const float* xa = x + 3 * static_cast<int64_t>(a);
        qa[u] = q[a];
        o[u][2] = stencil_axis<P>(xa[2], g.lo[2], g.s[2], g.nz, &d[u][2]);
        if (zinv) bad |= off_planes<P>(o[u][2], g.nz, zinv);
        if (qa[u] != 0.f) {
          o[u][0] = stencil_axis<P>(xa[0], g.lo[0], g.s[0], g.nx, &d[u][0]);
          o[u][1] = stencil_axis<P>(xa[1], g.lo[1], g.s[1], g.ny, &d[u][1]);
          keep[u] = reaches<P>(o[u][0], x0, x1, g.nx)
                    && reaches<P>(o[u][1], y0, y1, g.ny)
                    && reaches<P>(o[u][2], zlo, zhi, g.nz);
        }
      }
    }
    // stable compaction: each kept atom's place in the round, atom order
    unsigned bal[MS_K];
#pragma unroll
    for (int u = 0; u < MS_K; ++u) {
      bal[u] = __ballot_sync(0xffffffffu, keep[u]);
      if (lane == 0) s_wsum[u][wid] = __popc(bal[u]);
    }
    __syncthreads();
    int pos[MS_K], total = 0;
#pragma unroll
    for (int u = 0; u < MS_K; ++u) {
      int before = 0, tot = 0;
#pragma unroll
      for (int w = 0; w < MS_TB / 32; ++w) {
        const int c = s_wsum[u][w];
        before += w < wid ? c : 0;
        tot += c;
      }
      pos[u] = total + before + __popc(bal[u] & ((1u << lane) - 1u));
      total += tot;
    }
    // write the round's records in windows that fit the buffer, adding a
    // full buffer before the next window
    for (int done = 0; done < total;) {
      const int take = min(total - done, MS_CAP - count);
#pragma unroll
      for (int u = 0; u < MS_K; ++u) {
        if (keep[u] && pos[u] >= done && pos[u] < done + take) {
          const int r = count + pos[u] - done;
          s_o[0][r] = o[u][0];
          s_o[1][r] = o[u][1];
          s_o[2][r] = o[u][2];
#pragma unroll
          for (int t = 0; t < P; ++t) {
            s_w[t][r] = horner_row<P>(d[u][0], s_cf, t);
            s_w[P + t][r] = horner_row<P>(d[u][1], s_cf, t);
            s_w[2 * P + t][r] = horner_row<P>(d[u][2], s_cf, t);
          }
          s_w[3 * P][r] = qa[u];
        }
      }
      count += take;
      done += take;
      __syncthreads();
      if (count == MS_CAP) {
        add_staged(count);
        count = 0;
        __syncthreads();
      }
    }
    __syncthreads();   // s_wsum is rewritten by the next round
  }
  add_staged(count);
  if (zinv) bad = __syncthreads_or(bad);
  if (node) {
    out[(static_cast<int64_t>(i) * g.ny + j) * g.nzo + k] =
        bad ? __int_as_float(0x7fc00000) : acc;
  }
}

template <int P>
__global__ void __launch_bounds__(MR_TB)
stencil_readout_kernel(const float* __restrict__ f0,
                       const float* __restrict__ f1,
                       const float* __restrict__ f2, int nf, int ad,
                       int fsx, int fsy, int fsz,
                       const float* __restrict__ x,
                       const float* __restrict__ scale, float sign,
                       const float* __restrict__ cf,
                       const int* __restrict__ zinv, int n, StencilGeom g,
                       float d0, float d1, float d2,
                       float* __restrict__ out) {
  __shared__ float s_cf[P * P];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  if (tid < P * P) s_cf[tid] = cf[tid];
  bool bad = false;
  if (zinv) {
    // the fail-loud rule over every atom, in every CTA
    for (int a0 = 0; a0 < n; a0 += MR_TB * 4) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int a = a0 + u * MR_TB + tid;
        if (a < n) {
          float d;
          const int oz = stencil_axis<P>(
              x[3 * static_cast<int64_t>(a) + 2], g.lo[2], g.s[2], g.nz, &d);
          bad |= off_planes<P>(oz, g.nz, zinv);
        }
      }
    }
    bad = __syncthreads_or(bad);
  } else {
    __syncthreads();
  }
  const int a = blockIdx.x * (MR_TB / 32) + (tid >> 5);
  if (a >= n) return;
  const float* xa = x + 3 * static_cast<int64_t>(a);
  float dxx, dxy, dxz;
  const int ox = stencil_axis<P>(xa[0], g.lo[0], g.s[0], g.nx, &dxx);
  const int oy = stencil_axis<P>(xa[1], g.lo[1], g.s[1], g.ny, &dxy);
  const int oz = stencil_axis<P>(xa[2], g.lo[2], g.s[2], g.nz, &dxz);
  float wz[P], dwz[P];
  int zi[P];
#pragma unroll
  for (int t = 0; t < P; ++t) {
    wz[t] = horner_row<P>(dxz, s_cf, t);
    dwz[t] = ad ? horner_drow<P>(dxz, s_cf, t) : 0.f;
    const int node = wrap_add(oz, t, g.nz);
    zi[t] = (zinv ? max(__ldg(zinv + node), 0) : node) * fsz;
  }
  const float* fs[3] = {f0, f1, f2};
  float acc[3] = {0.f, 0.f, 0.f};
  for (int ab = lane; ab < P * P; ab += 32) {
    const int ia = ab / P;
    const int ib = ab % P;
    const float wx = horner_row<P>(dxx, s_cf, ia);
    const float wy = horner_row<P>(dxy, s_cf, ib);
    const int64_t row = static_cast<int64_t>(wrap_add(ox, ia, g.nx)) * fsx
                        + static_cast<int64_t>(wrap_add(oy, ib, g.ny)) * fsy;
    if (ad) {
      const float dwx = horner_drow<P>(dxx, s_cf, ia);
      const float dwy = horner_drow<P>(dxy, s_cf, ib);
      float sz = 0.f, sdz = 0.f;
#pragma unroll
      for (int t = 0; t < P; ++t) {
        const float v = __ldg(f0 + row + zi[t]);
        sz = fmaf(wz[t], v, sz);
        sdz = fmaf(dwz[t], v, sdz);
      }
      acc[0] = fmaf(__fmul_rn(dwx, wy), sz, acc[0]);
      acc[1] = fmaf(__fmul_rn(wx, dwy), sz, acc[1]);
      acc[2] = fmaf(__fmul_rn(wx, wy), sdz, acc[2]);
    } else {
      const float wxy = __fmul_rn(wx, wy);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        if (c < nf) {
          float sz = 0.f;
#pragma unroll
          for (int t = 0; t < P; ++t) {
            sz = fmaf(wz[t], __ldg(fs[c] + row + zi[t]), sz);
          }
          acc[c] = fmaf(wxy, sz, acc[c]);
        }
      }
    }
  }
  const int nout = ad ? 3 : nf;
  const float dl[3] = {d0, d1, d2};
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    if (c < nout) {
      float v = warp_sum(acc[c]);
      if (ad) v = __fmul_rn(v, dl[c]);
      if (scale) v = __fmul_rn(scale[a], v);
      v = __fmul_rn(sign, v);
      if (lane == 0) {
        out[static_cast<int64_t>(a) * nout + c] =
            bad ? __int_as_float(0x7fc00000) : v;
      }
    }
  }
}

inline StencilGeom make_geom(int nx, int ny, int nz, int nzo, float lox,
                             float loy, float loz, float sx, float sy,
                             float sz) {
  StencilGeom g;
  g.nx = nx;
  g.ny = ny;
  g.nz = nz;
  g.nzo = nzo;
  g.lo[0] = lox;
  g.lo[1] = loy;
  g.lo[2] = loz;
  g.s[0] = sx;
  g.s[1] = sy;
  g.s[2] = sz;
  return g;
}

template <int P>
void launch_spread(const float* x, const float* q, const float* cf,
                   const int* zinv, const int* znode, int n,
                   const StencilGeom& g, float* out, cudaStream_t st) {
  const int ty = (g.ny + MS_TY - 1) / MS_TY;
  const int tz = (g.nzo + MS_TZ - 1) / MS_TZ;
  const int tx = (g.nx + MS_TX - 1) / MS_TX;
  stencil_spread_kernel<P><<<tx * ty * tz, MS_TB, 0, st>>>(
      x, q, cf, zinv, znode, n, g, ty, tz, out);
}

template <int P>
void launch_readout(const float* f0, const float* f1, const float* f2,
                    int nf, int ad, int fsx, int fsy, int fsz,
                    const float* x, const float* scale,
                    float sign, const float* cf, const int* zinv, int n,
                    const StencilGeom& g, float d0, float d1, float d2,
                    float* out, cudaStream_t st) {
  const int per = MR_TB / 32;
  stencil_readout_kernel<P><<<(n + per - 1) / per, MR_TB, 0, st>>>(
      f0, f1, f2, nf, ad, fsx, fsy, fsz, x, scale, sign, cf, zinv, n, g,
      d0, d1, d2, out);
}

}  // namespace conp2

extern "C" {

// Charges onto the mesh: out (nx, ny, nzo) float32, nzo = nz (znode and
// zinv null) or the P planes whose z nodes znode lists (zinv: (nz,) slot
// of each z node, -1 off the set).  x (n, 3), q (n,), cf (p, p).  Returns
// cudaGetLastError().
int conp2_stencil_spread_f32(const float* x, const float* q, const float* cf,
                             const int* zinv, const int* znode, int n,
                             int order, int nx, int ny, int nz, int nzo,
                             float lox, float loy, float loz, float sx,
                             float sy, float sz, float* out, void* stream) {
  if (n < 0 || nx <= 0 || ny <= 0 || nz <= 0 || nzo <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const conp2::StencilGeom g = conp2::make_geom(nx, ny, nz, nzo, lox, loy,
                                                loz, sx, sy, sz);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (order) {
    case 2: conp2::launch_spread<2>(x, q, cf, zinv, znode, n, g, out, st); break;
    case 3: conp2::launch_spread<3>(x, q, cf, zinv, znode, n, g, out, st); break;
    case 4: conp2::launch_spread<4>(x, q, cf, zinv, znode, n, g, out, st); break;
    case 5: conp2::launch_spread<5>(x, q, cf, zinv, znode, n, g, out, st); break;
    case 6: conp2::launch_spread<6>(x, q, cf, zinv, znode, n, g, out, st); break;
    case 7: conp2::launch_spread<7>(x, q, cf, zinv, znode, n, g, out, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Fields read at the atoms: out (n, nf) (ad: (n, 3) from f0), each value
// times scale[i] (if scale is not null) and sign; fields (nx, ny, nzo) of
// element strides (fsx, fsy, fsz), all alike, read through zinv on the z
// planes (nzo = P).  d0..d2: delinv (ad).  Returns cudaGetLastError().
int conp2_stencil_readout_f32(const float* f0, const float* f1,
                              const float* f2, int nf, int ad, int fsx,
                              int fsy, int fsz,
                              const float* x, const float* scale,
                              float sign, const float* cf, const int* zinv,
                              int n, int order, int nx, int ny, int nz,
                              int nzo, float lox, float loy, float loz,
                              float sx, float sy, float sz, float d0,
                              float d1, float d2, float* out, void* stream) {
  if (n <= 0 || nf < 1 || nf > 3 || nx <= 0 || ny <= 0 || nz <= 0
      || nzo <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const conp2::StencilGeom g = conp2::make_geom(nx, ny, nz, nzo, lox, loy,
                                                loz, sx, sy, sz);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CONP2_READOUT(P)                                                   \
  conp2::launch_readout<P>(f0, f1, f2, nf, ad, fsx, fsy, fsz, x, scale,   \
                           sign, cf, zinv, n, g, d0, d1, d2, out, st)
  switch (order) {
    case 2: CONP2_READOUT(2); break;
    case 3: CONP2_READOUT(3); break;
    case 4: CONP2_READOUT(4); break;
    case 5: CONP2_READOUT(5); break;
    case 6: CONP2_READOUT(6); break;
    case 7: CONP2_READOUT(7); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef CONP2_READOUT
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
