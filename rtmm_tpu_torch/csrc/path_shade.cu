// Path-tracer bounce kernels for NVIDIA Hopper (sm_90a): the per-lane
// work of bench config 5 outside the trace.
//
// Replaces no Pallas kernel: on the TPU this work is XLA-fused device code
// inside the jitted path_trace (rtmm_tpu/render/pathtrace.py: rand2
// :342-350, the bounce shading and next ray :472-487, the primaries'
// shading :336-339 and spawn :347-369). Two kernels:
//
// - pt_spawn: per lane, the draw and the next ray. The draw is
//   jax.random's threefry on (seed, bounce, g // total, g % total):
//   u = uniform(fold_in(fold_in(kb, g // total), g % total), (2,)) with
//   kb = fold_in(key(seed), bounce) folded on the host, g the lane's
//   global index; four Threefry-2x32 blocks per lane in uint32
//   arithmetic, the partitionable bit path of utils/threefry.py. Then the
//   cosine-weighted direction around the lane's normal and the next ray:
//   bounces >= 1 o + where(hit, t, 0) d + 1e-4 n and where(hit, dir, d);
//   the primary form reads pixel g % total of the n primaries (nrm0,
//   hit0, the bounce origin, d0), and the pad lanes past n get nrm 0,
//   hit false, o 0 and d 1.0, as the plain version's padding gives them.
//   An optional output takes the lane's two uniforms.
// - pt_shade: per lane, the hit's shading: the geometric normal
//   normalised and flipped toward the ray (written out for pt_spawn), the
//   background on escaped lanes and the four-light Lambertian direct
//   light, Reinhard tone-mapped, on hits, both times the bounce's
//   throughput albedo ** b (a host constant). The primary form writes
//   where(hit0, direct, background).
//
// The plain PyTorch versions are rtmm_tpu_torch/ops/path_shade.py::
// spawn_plain and shade_plain. They do the same float32 operations in the
// same order, and this file is built with -fmad=false and without fast
// math: divisions and square roots correctly rounded, cosf / sinf the
// CUDA math library's (what torch.cos / torch.sin call on float32), each
// Python-scalar constant of the plain version written as the float32
// PyTorch casts it to. So the words, the uniforms and every output equal
// the plain version's on the card.
//
// Design: one thread per lane, grid-stride loops, nothing staged. What
// bounds them on an H100: pt_spawn's draw is ~330 32-bit integer
// operations per live lane (~16.7 T/s), its state ~70 bytes per lane
// (3.35 TB/s); pt_shade moves ~60 bytes per lane for ~100 float32
// operations, so it is bound by its bytes. A dead lane of a bounce needs
// no draw and skips it (unless the uniforms are asked for).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;
constexpr uint32_t kParity = 0x1BD11BDAu;
// The plain version's Python-scalar constants, as PyTorch casts them to
// float32 before the operation.
constexpr float kTwoPi = static_cast<float>(2.0 * 3.141592653589793);
constexpr float kEps = static_cast<float>(1e-4);
constexpr float kTiny = static_cast<float>(1e-20);
constexpr float kFlat = static_cast<float>(0.9);

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

// uniform(fold_in(fold_in(kb, g // total), g % total), (2,)).
__device__ __forceinline__ void draw(uint32_t kb0, uint32_t kb1, int g,
                                     int total, float& u0, float& u1) {
  uint32_t a0 = 0u, a1 = static_cast<uint32_t>(g / total);
  threefry2x32(kb0, kb1, a0, a1);
  uint32_t k0 = 0u, k1 = static_cast<uint32_t>(g % total);
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

__device__ __forceinline__ void load3(const float* p, int i, float v[3]) {
  v[0] = p[3 * i];
  v[1] = p[3 * i + 1];
  v[2] = p[3 * i + 2];
}

__device__ __forceinline__ void store3(float* p, int i, const float v[3]) {
  p[3 * i] = v[0];
  p[3 * i + 1] = v[1];
  p[3 * i + 2] = v[2];
}

// Bounce form (t != nullptr): lane i of the sorted state, g = idx[i].
// Primary form (t == nullptr): lane g = i of spp x total lanes reads pixel
// g % total of the n_pix primaries; o is their bounce origin.
__global__ void __launch_bounds__(kThreads)
pt_spawn_kernel(int n_lanes, int total, int n_pix, uint32_t kb0,
                uint32_t kb1, const int* __restrict__ idx,
                const float* __restrict__ nrm,
                const unsigned char* __restrict__ hit,
                const float* __restrict__ o, const float* __restrict__ d,
                const float* __restrict__ t, float* __restrict__ o_out,
                float* __restrict__ d_out, float* __restrict__ u_out) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n_lanes;
       i += gridDim.x * blockDim.x) {
    const int g = t != nullptr ? idx[i] : i;
    float n[3] = {0.0f, 0.0f, 0.0f}, oi[3] = {0.0f, 0.0f, 0.0f};
    float di[3] = {1.0f, 1.0f, 1.0f};
    bool h = false;
    const int src = t != nullptr ? i : g % total;
    if (t != nullptr || src < n_pix) {
      load3(nrm, src, n);
      load3(o, src, oi);
      load3(d, src, di);
      h = hit[src] != 0;
    }
    float u0 = 0.0f, u1 = 0.0f;
    if (h || u_out != nullptr) draw(kb0, kb1, g, total, u0, u1);
    if (u_out != nullptr) {
      u_out[2 * i] = u0;
      u_out[2 * i + 1] = u1;
    }
    float dn[3];
    if (h) {
      cosine_dir(u0, u1, n, dn);
    } else {
      dn[0] = di[0];
      dn[1] = di[1];
      dn[2] = di[2];
    }
    store3(d_out, i, dn);
    if (t != nullptr) {
      const float ht = h ? t[i] : 0.0f;
#pragma unroll
      for (int c = 0; c < 3; ++c) oi[c] = (oi[c] + ht * di[c]) + kEps * n[c];
    }
    store3(o_out, i, oi);
  }
}

// The four lights of closesthit.hlsl:70-81 (+Z, +Y, -Z, -Y): the plain
// version's dot n[0] * l[0] + n[1] * l[1] + n[2] * l[2], left to right,
// its zero and unit products included.
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

// Bounce form (rad_in != nullptr): rad_out = rad_in + where(escaped,
// tp bg, 0) + where(hit, tp direct, 0). Primary form: where(hit, direct,
// bg). Both write the normalised, flipped normal.
__global__ void __launch_bounds__(kThreads)
pt_shade_kernel(int n_lanes, const float* __restrict__ bn,
                const float* __restrict__ d,
                const unsigned char* __restrict__ hit,
                const unsigned char* __restrict__ alive,
                const float* __restrict__ rad_in, float* __restrict__ rad_out,
                float* __restrict__ nrm_out, ShadeConsts k) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n_lanes;
       i += gridDim.x * blockDim.x) {
    float b[3], di[3], n[3];
    load3(bn, i, b);
    load3(d, i, di);
    const float den = clamp_min(sqrtf(b[0] * b[0] + b[1] * b[1]
                                      + b[2] * b[2]), kTiny);
    n[0] = b[0] / den;
    n[1] = b[1] / den;
    n[2] = b[2] / den;
    if (n[0] * di[0] + n[1] * di[1] + n[2] * di[2] > 0.0f) {
      n[0] = -n[0];
      n[1] = -n[1];
      n[2] = -n[2];
    }
    store3(nrm_out, i, n);
    const bool h = hit[i] != 0;
    float lo[3] = {0.0f, 0.0f, 0.0f}, r[3];
    if (h) direct_light(n, k, lo);
    if (rad_in == nullptr) {
#pragma unroll
      for (int c = 0; c < 3; ++c) r[c] = h ? lo[c] : k.bg[c];
    } else {
      const bool escaped = alive[i] != 0 && !h;
      load3(rad_in, i, r);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        r[c] = r[c] + (escaped ? k.tp[c] * k.bg[c] : 0.0f);
        r[c] = r[c] + (h ? k.tp[c] * lo[c] : 0.0f);
      }
    }
    store3(rad_out, i, r);
  }
}

int blocks_for(int n) {
  const int b = (n + kThreads - 1) / kThreads;
  return b < kMaxBlocks ? b : kMaxBlocks;
}

}  // namespace

extern "C" int rtmm_pt_spawn(int n_lanes, int total, int n_pix,
                             unsigned int kb0, unsigned int kb1,
                             const int* idx, const float* nrm,
                             const unsigned char* hit, const float* o,
                             const float* d, const float* t, float* o_out,
                             float* d_out, float* u_out, void* stream) {
  if (n_lanes < 0 || total < 1 || (t != nullptr && idx == nullptr) ||
      (t == nullptr && (n_pix < 0 || n_pix > total)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_lanes == 0) return 0;
  pt_spawn_kernel<<<blocks_for(n_lanes), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      n_lanes, total, n_pix, kb0, kb1, idx, nrm, hit, o, d, t, o_out, d_out,
      u_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rtmm_pt_shade(int n_lanes, const float* bn, const float* d,
                             const unsigned char* hit,
                             const unsigned char* alive, const float* rad_in,
                             float* rad_out, float* nrm_out,
                             const float* consts, void* stream) {
  if (n_lanes < 0 || (rad_in != nullptr && alive == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_lanes == 0) return 0;
  ShadeConsts k;
  for (int c = 0; c < 3; ++c) {
    k.albedo[c] = consts[c];
    k.bg[c] = consts[3 + c];
    k.tp[c] = consts[6 + c];
  }
  for (int l = 0; l < 4; ++l) k.scale[l] = consts[9 + l];
  pt_shade_kernel<<<blocks_for(n_lanes), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      n_lanes, bn, d, hit, alive, rad_in, rad_out, nrm_out, k);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rtmm_pt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
