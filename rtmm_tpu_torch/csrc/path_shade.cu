// Path-tracer bounce kernels for NVIDIA Hopper (sm_90a): the per-lane
// work of bench config 5 outside the trace, one launch for the primaries
// and one per bounce.
//
// Replaces no Pallas kernel: on the TPU this work is XLA-fused device code
// inside the jitted path_trace (rtmm_tpu/render/pathtrace.py), and each
// kernel here is one of its fused regions:
//
// - pt_primary, one thread per pixel p < total (pad pixels p >= n dead):
//   the primaries' shading :265-267 (the normal normalised and flipped
//   toward the ray, where(hit0, direct, bg)), the bounce origin :279
//   ((o0 + t0 d0) + 1e-4 nrm0) and, for each sample s < spp, the spawn of
//   lane g = s * total + p :364-372 (tile_s over the padded pixels, the
//   draw on hits, the cosine direction): the lane's o, d and alive. Pad
//   lanes get o 0, d 1.0 and alive false. An optional output takes every
//   lane's two uniforms.
// - pt_bounce<Spawn>, one thread per lane of the sorted state: the
//   bounce lines :472-487. hit = alive & (t < BIG) & (t > 0) (or alive &
//   a given hit, the per-ray engine's), the trace's normal read in place
//   through its strides (K2's (groups, 3, GROUP), the grouped engine's
//   (g, GROUP, 3), the per-ray engine's (n, 3)) and normalised and flipped
//   in registers, the bounce radiance rad + where(alive & ~hit, tp bg, 0)
//   + where(hit, tp direct, 0) with the throughput tp = albedo ** b; with
//   Spawn (bounces before the last) the draw on hits and the next ray,
//   o + where(hit, t, 0) d + 1e-4 n and where(hit, dir, d). Writes rad,
//   hit (the next alive) and, with Spawn, o and d.
//
// The draw is jax.random's threefry on (seed, bounce, g // total,
// g % total): u = uniform(fold_in(fold_in(kb, g // total), g % total),
// (2,)) with kb = fold_in(key(seed), bounce) folded on the host; four
// Threefry-2x32 blocks per lane in uint32 arithmetic, the partitionable
// bit path of utils/threefry.py, on the lanes that spawn (every lane when
// the uniforms are asked for).
//
// The plain PyTorch versions are rtmm_tpu_torch/ops/path_shade.py::
// primary_plain and bounce_plain, compositions of shade_plain and
// spawn_plain and the path tracer's eager lines. They do the same float32
// operations in the same order, and this file is built with -fmad=false
// and without fast math: divisions and square roots correctly rounded,
// cosf / sinf the CUDA math library's (what torch.cos / torch.sin call on
// float32), each Python-scalar constant of the plain version written as
// the float32 PyTorch casts it to. So the uniforms and every output equal
// the plain version's on the card.
//
// What bounds them on an H100, and what the design does about it:
// - Bytes. A bounce lane moves ~80 bytes (d, o, rad in; rad, o, d out;
//   the normal, t, alive, idx and hit) for ~100 float32 operations and,
//   on hits, ~330 integer operations of the draw; the large forms are
//   bound by their bytes at 3.35 TB/s. Each block stages its 256 lanes'
//   (n, 3) rows through shared memory and moves them as 16-byte words
//   (3 KB a row array, 192 float4s), falling back to 4-byte words for a
//   ragged tail or a base that is not 16-byte aligned (a state cut at
//   x[:cap] or an offset view); a thread issues all its loads before it
//   uses any, so a block waits for memory once. K2's component-major
//   normals are read with coalesced 4-byte loads, and nothing crosses a
//   seam: the normal never leaves registers, hit is computed where it is
//   used, and each input is read once and each output written once.
// - The launch floor. After the lane caps the small bounces run 32,768
//   and 8,192 lanes, well under the ~3 us a launch costs; the answer is
//   one launch where there were two (pt_shade then pt_spawn), not work
//   inside the kernel.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kParity = 0x1BD11BDAu;
// The plain version's Python-scalar constants, as PyTorch casts them to
// float32 before the operation.
constexpr float kTwoPi = static_cast<float>(2.0 * 3.141592653589793);
constexpr float kEps = static_cast<float>(1e-4);
constexpr float kTiny = static_cast<float>(1e-20);
constexpr float kFlat = static_cast<float>(0.9);
constexpr float kBig = static_cast<float>(1e30);

// The bounce's shading constants: albedo, background, throughput
// albedo ** b, and per light its intensity x scale / pi (a Python double
// cast to float32, as the plain version's albedo * (radiance / pi)).
struct ShadeConsts {
  float albedo[3];
  float bg[3];
  float tp[3];
  float scale[4];
};

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// Threefry-2x32, 20 rounds, on the counter words (x0, x1) in place.
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ kParity};
  constexpr int kRot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, kRot[i % 2][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
}

// uniform(fold_in(fold_in(kb, hi), lo), (2,)): hi = g // total, lo =
// g % total.
__device__ __forceinline__ void draw(uint32_t kb0, uint32_t kb1, uint32_t hi,
                                     uint32_t lo, float& u0, float& u1) {
  uint32_t a0 = 0u, a1 = hi;
  threefry2x32(kb0, kb1, a0, a1);
  uint32_t k0 = 0u, k1 = lo;
  threefry2x32(a0, a1, k0, k1);
  uint32_t b0 = 0u, b1 = 0u;
  threefry2x32(k0, k1, b0, b1);
  uint32_t c0 = 0u, c1 = 1u;
  threefry2x32(k0, k1, c0, c1);
  u0 = __uint_as_float(((b0 ^ b1) >> 9) | 0x3F800000u) - 1.0f;
  u1 = __uint_as_float(((c0 ^ c1) >> 9) | 0x3F800000u) - 1.0f;
}

// torch.clamp_min on CUDA: NaN passes, else the larger.
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

// a x b, jnp.cross's component formula.
__device__ __forceinline__ void cross(const float a[3], const float b[3],
                                      float out[3]) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

// Cosine-weighted hemisphere direction around n (path_shade.cosine_dir).
__device__ __forceinline__ void cosine_dir(float u0, float u1,
                                           const float n[3], float out[3]) {
  const float r = sqrtf(u0);
  const float phi = kTwoPi * u1;
  const float x = r * cosf(phi);
  const float y = r * sinf(phi);
  const float z = sqrtf(clamp_min(1.0f - u0, 0.0f));
  const bool flat = fabsf(n[2]) < kFlat;
  const float up[3] = {flat ? 0.0f : 1.0f, 0.0f, flat ? 1.0f : 0.0f};
  float t[3], b[3];
  cross(up, n, t);
  const float len = clamp_min(sqrtf(t[0] * t[0] + t[1] * t[1]
                                    + t[2] * t[2]), kTiny);
  t[0] = t[0] / len;
  t[1] = t[1] / len;
  t[2] = t[2] / len;
  cross(n, t, b);
#pragma unroll
  for (int c = 0; c < 3; ++c) out[c] = x * t[c] + y * b[c] + z * n[c];
}

// The geometric normal b normalised (its norm clamped to 1e-20) and
// flipped toward the ray d (path_shade.normalize_flip).
__device__ __forceinline__ void normal_toward(const float b[3],
                                              const float d[3], float n[3]) {
  const float den = clamp_min(sqrtf(b[0] * b[0] + b[1] * b[1]
                                    + b[2] * b[2]), kTiny);
  n[0] = b[0] / den;
  n[1] = b[1] / den;
  n[2] = b[2] / den;
  if (n[0] * d[0] + n[1] * d[1] + n[2] * d[2] > 0.0f) {
    n[0] = -n[0];
    n[1] = -n[1];
    n[2] = -n[2];
  }
}

// The four lights of closesthit.hlsl:70-81 (+Z, +Y, -Z, -Y): the plain
// version's dot n[0] * l[0] + n[1] * l[1] + n[2] * l[2], left to right,
// its zero and unit products included; Reinhard tone-mapped.
__device__ __forceinline__ void direct_light(const float n[3],
                                             const ShadeConsts& k,
                                             float lo[3]) {
  constexpr float kDirs[4][3] = {{0.0f, 0.0f, 1.0f}, {0.0f, 1.0f, 0.0f},
                                 {0.0f, 0.0f, -1.0f}, {0.0f, -1.0f, 0.0f}};
  lo[0] = lo[1] = lo[2] = 0.0f;
#pragma unroll
  for (int l = 0; l < 4; ++l) {
    const float ndl = clamp_min(n[0] * kDirs[l][0] + n[1] * kDirs[l][1]
                                + n[2] * kDirs[l][2], 0.0f);
#pragma unroll
    for (int c = 0; c < 3; ++c)
      lo[c] = lo[c] + (k.albedo[c] * k.scale[l]) * ndl;
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) lo[c] = lo[c] / (lo[c] + 1.0f);
}

// A block's tile of (n, 3) float32 rows, rows r0 .. r0 + rows - 1 of the
// array as 3 * rows <= 768 floats, is moved by its first 192 threads, 4
// consecutive floats each: one 16-byte access where the tile starts on a
// 16-byte boundary (tiles start at multiples of 256 rows, so that is the
// array's base) and the thread's 4 floats are whole, else 4-byte
// accesses (a ragged tail, a base that is not 16-byte aligned). fetch
// only loads into registers, so that a thread's loads of every array are
// in flight together; the rows go through shared memory (put / get) to
// and from the thread that owns them.
constexpr int kShare = 3 * kThreads / 4;

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

__device__ __forceinline__ float4 fetch_rows(const float* __restrict__ src,
                                             long long r0, int rows) {
  const float* base = src + 3 * r0;
  const int nf = 3 * rows;
  const int k = 4 * static_cast<int>(threadIdx.x);
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (k + 4 <= nf && aligned16(base)) {
    v = *reinterpret_cast<const float4*>(base + k);
  } else if (k < nf) {
    v.x = base[k];
    if (k + 1 < nf) v.y = base[k + 1];
    if (k + 2 < nf) v.z = base[k + 2];
    if (k + 3 < nf) v.w = base[k + 3];
  }
  return v;
}

__device__ __forceinline__ void store_rows(float* __restrict__ dst,
                                           long long r0, int rows,
                                           float4 v) {
  float* base = dst + 3 * r0;
  const int nf = 3 * rows;
  const int k = 4 * static_cast<int>(threadIdx.x);
  if (k + 4 <= nf && aligned16(base)) {
    *reinterpret_cast<float4*>(base + k) = v;
  } else if (k < nf) {
    base[k] = v.x;
    if (k + 1 < nf) base[k + 1] = v.y;
    if (k + 2 < nf) base[k + 2] = v.z;
    if (k + 3 < nf) base[k + 3] = v.w;
  }
}

__device__ __forceinline__ void put(float* tile, float4 v) {
  if (threadIdx.x < kShare) reinterpret_cast<float4*>(tile)[threadIdx.x] = v;
}

__device__ __forceinline__ float4 get(const float* tile) {
  return threadIdx.x < kShare
             ? reinterpret_cast<const float4*>(tile)[threadIdx.x]
             : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// One block per 256 pixels. Reads bn, d, o, t and hit of the n_pix
// primaries; writes the primary radiance (n_pix, 3) and, per sample s,
// lanes s * total + p of o, d, alive (and the uniforms). Six blocks an
// SM (40 registers, where 64 would allow four) overlap more blocks'
// loads with others' draws.
__global__ void __launch_bounds__(kThreads, 6)
pt_primary_kernel(int n_pix, int total, int spp, uint32_t kb0, uint32_t kb1,
                  const float* __restrict__ bn, const float* __restrict__ d,
                  const float* __restrict__ o, const float* __restrict__ t,
                  const unsigned char* __restrict__ hit, ShadeConsts k,
                  float* __restrict__ rad_out, float* __restrict__ o_out,
                  float* __restrict__ d_out,
                  unsigned char* __restrict__ alive_out,
                  float* __restrict__ u_out) {
  __shared__ __align__(16) float s_n[3 * kThreads];
  __shared__ __align__(16) float s_d[3 * kThreads];
  __shared__ __align__(16) float s_o[3 * kThreads];
  const int p0 = blockIdx.x * kThreads;
  const int rows = min(kThreads, n_pix - p0);     // pixels (may be <= 0)
  const int lanes = min(kThreads, total - p0);    // lanes per sample
  const int tid = threadIdx.x;
  const int p = p0 + tid;
  const int r = 3 * tid;
  const bool pix = tid < rows;
  // Every load first: they are in flight together.
  const float4 vn = fetch_rows(bn, p0, rows);
  const float4 vd = fetch_rows(d, p0, rows);
  const float4 vo = fetch_rows(o, p0, rows);
  bool h = false;
  float ti = 0.0f;
  if (pix) {
    h = hit[p] != 0;
    ti = t[p];
  }
  put(s_n, vn);
  put(s_d, vd);
  put(s_o, vo);
  __syncthreads();
  float n[3] = {0.0f, 0.0f, 0.0f}, di[3] = {1.0f, 1.0f, 1.0f};
  if (pix) {
    const float b[3] = {s_n[r], s_n[r + 1], s_n[r + 2]};
    di[0] = s_d[r];
    di[1] = s_d[r + 1];
    di[2] = s_d[r + 2];
    normal_toward(b, di, n);
    float lo[3] = {0.0f, 0.0f, 0.0f};
    if (h) direct_light(n, k, lo);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      s_n[r + c] = h ? lo[c] : k.bg[c];
      s_o[r + c] = (s_o[r + c] + ti * di[c]) + kEps * n[c];
    }
  } else if (tid < lanes) {
    s_o[r] = s_o[r + 1] = s_o[r + 2] = 0.0f;
  }
  __syncthreads();
  store_rows(rad_out, p0, rows, get(s_n));
  const float4 vo_out = get(s_o);
  // Sample s's directions go through s_d or s_n in turn, so one barrier
  // a sample keeps a tile's writes apart from the last reads of it.
  for (int s = 0; s < spp; ++s) {
    float* s_dir = (s & 1) ? s_n : s_d;
    const long long g0 = static_cast<long long>(s) * total + p0;
    if (tid < lanes) {
      float u0 = 0.0f, u1 = 0.0f;
      if (h || u_out != nullptr)
        draw(kb0, kb1, static_cast<uint32_t>(s), static_cast<uint32_t>(p),
             u0, u1);
      if (u_out != nullptr)
        reinterpret_cast<float2*>(u_out)[g0 + tid] = make_float2(u0, u1);
      float dn[3] = {di[0], di[1], di[2]};
      if (h) cosine_dir(u0, u1, n, dn);
      s_dir[r] = dn[0];
      s_dir[r + 1] = dn[1];
      s_dir[r + 2] = dn[2];
      alive_out[g0 + tid] = h ? 1 : 0;
    }
    __syncthreads();
    store_rows(d_out, g0, lanes, get(s_dir));
    store_rows(o_out, g0, lanes, vo_out);
  }
}

// The trace's normal of lane i: element (i >> shift, i & (2^shift - 1),
// c) of a (g, 2^shift, 3) view with the given element strides ((n, 3):
// shift 0, inner stride 0).
struct NormalView {
  const float* p;
  int shift;
  long long s_outer, s_inner, s_c;
};

// One block per 256 lanes of the sorted state.
template <bool Spawn>
__global__ void __launch_bounds__(kThreads)
pt_bounce_kernel(int n, int total, uint32_t kb0, uint32_t kb1,
                 NormalView bn, const float* __restrict__ d,
                 const float* __restrict__ o, const float* __restrict__ t,
                 const unsigned char* __restrict__ alive,
                 const unsigned char* __restrict__ hit_in,
                 const float* __restrict__ rad, const int* __restrict__ idx,
                 ShadeConsts k, float* __restrict__ rad_out,
                 unsigned char* __restrict__ hit_out,
                 float* __restrict__ o_out, float* __restrict__ d_out,
                 float* __restrict__ u_out) {
  __shared__ __align__(16) float s_d[3 * kThreads];
  __shared__ __align__(16) float s_o[Spawn ? 3 * kThreads : 4];
  __shared__ __align__(16) float s_r[3 * kThreads];
  const int i0 = blockIdx.x * kThreads;
  const int rows = min(kThreads, n - i0);
  const int tid = threadIdx.x;
  const int i = i0 + tid;
  const int r = 3 * tid;
  const bool lane = tid < rows;
  // Every load first: they are in flight together.
  const float4 vd = fetch_rows(d, i0, rows);
  float4 vo = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (Spawn) vo = fetch_rows(o, i0, rows);
  const float4 vr = fetch_rows(rad, i0, rows);
  float b[3] = {0.0f, 0.0f, 0.0f}, ti = 0.0f;
  bool a = false, hin = true;
  uint32_t g = 0u;
  if (lane) {
    a = alive[i] != 0;
    ti = t[i];
    if (hit_in != nullptr) hin = hit_in[i] != 0;
    if (Spawn) g = static_cast<uint32_t>(idx[i]);
    const float* q = bn.p + (i >> bn.shift) * bn.s_outer
                     + (i & ((1 << bn.shift) - 1)) * bn.s_inner;
    b[0] = q[0];
    b[1] = q[bn.s_c];
    b[2] = q[2 * bn.s_c];
  }
  put(s_d, vd);
  if (Spawn) put(s_o, vo);
  put(s_r, vr);
  __syncthreads();
  if (lane) {
    const bool h = a && (hit_in != nullptr ? hin : (ti < kBig && ti > 0.0f));
    const float di[3] = {s_d[r], s_d[r + 1], s_d[r + 2]};
    float nrm[3];
    normal_toward(b, di, nrm);
    float lo[3] = {0.0f, 0.0f, 0.0f};
    if (h) direct_light(nrm, k, lo);
    const bool escaped = a && !h;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float v = s_r[r + c];
      v = v + (escaped ? k.tp[c] * k.bg[c] : 0.0f);
      s_r[r + c] = v + (h ? k.tp[c] * lo[c] : 0.0f);
    }
    hit_out[i] = h ? 1 : 0;
    if (Spawn) {
      float u0 = 0.0f, u1 = 0.0f;
      if (h || u_out != nullptr)
        draw(kb0, kb1, g / static_cast<uint32_t>(total),
             g % static_cast<uint32_t>(total), u0, u1);
      if (u_out != nullptr)
        reinterpret_cast<float2*>(u_out)[i] = make_float2(u0, u1);
      float dn[3] = {di[0], di[1], di[2]};
      if (h) cosine_dir(u0, u1, nrm, dn);
      const float ht = h ? ti : 0.0f;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        s_d[r + c] = dn[c];
        s_o[r + c] = (s_o[r + c] + ht * di[c]) + kEps * nrm[c];
      }
    }
  }
  __syncthreads();
  store_rows(rad_out, i0, rows, get(s_r));
  if (Spawn) {
    store_rows(o_out, i0, rows, get(s_o));
    store_rows(d_out, i0, rows, get(s_d));
  }
}

// The launch floor: an empty kernel on the same grid and stream.
__global__ void __launch_bounds__(kThreads) pt_empty_kernel() {}

ShadeConsts unpack(const float* consts) {
  ShadeConsts k;
  for (int c = 0; c < 3; ++c) {
    k.albedo[c] = consts[c];
    k.bg[c] = consts[3 + c];
    k.tp[c] = consts[6 + c];
  }
  for (int l = 0; l < 4; ++l) k.scale[l] = consts[9 + l];
  return k;
}

int blocks_for(long long n) {
  return static_cast<int>((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int rtmm_pt_primary(int n_pix, int total, int spp,
                               unsigned int kb0, unsigned int kb1,
                               const float* bn, const float* d,
                               const float* o, const float* t,
                               const unsigned char* hit, const float* consts,
                               float* rad_out, float* o_out, float* d_out,
                               unsigned char* alive_out, float* u_out,
                               void* stream) {
  if (n_pix < 0 || total < 1 || n_pix > total || spp < 0 ||
      static_cast<long long>(spp) * total > 0x7FFFFFFFLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_pix == 0 && spp == 0) return 0;
  pt_primary_kernel<<<blocks_for(total), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      n_pix, total, spp, kb0, kb1, bn, d, o, t, hit, unpack(consts), rad_out,
      o_out, d_out, alive_out, u_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rtmm_pt_bounce(int n, int total, int spawn, unsigned int kb0,
                              unsigned int kb1, const float* bn, int shift,
                              long long s_outer, long long s_inner,
                              long long s_c, const float* d, const float* o,
                              const float* t, const unsigned char* alive,
                              const unsigned char* hit_in, const float* rad,
                              const int* idx, const float* consts,
                              float* rad_out, unsigned char* hit_out,
                              float* o_out, float* d_out, float* u_out,
                              void* stream) {
  if (n < 0 || total < 1 || shift < 0 || shift > 30)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  if (spawn && (o == nullptr || idx == nullptr || o_out == nullptr ||
                d_out == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const NormalView view{bn, shift, s_outer, s_inner, s_c};
  const ShadeConsts k = unpack(consts);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (spawn)
    pt_bounce_kernel<true><<<blocks_for(n), kThreads, 0, st>>>(
        n, total, kb0, kb1, view, d, o, t, alive, hit_in, rad, idx, k,
        rad_out, hit_out, o_out, d_out, u_out);
  else
    pt_bounce_kernel<false><<<blocks_for(n), kThreads, 0, st>>>(
        n, total, kb0, kb1, view, d, o, t, alive, hit_in, rad, idx, k,
        rad_out, hit_out, o_out, d_out, u_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rtmm_pt_empty(int blocks, void* stream) {
  if (blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  pt_empty_kernel<<<blocks, kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rtmm_pt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
