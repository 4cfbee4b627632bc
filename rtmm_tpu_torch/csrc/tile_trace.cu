// Fused tile trace + shade for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel rtmm_tpu/ops/pallas_tiled.py::trace_pallas in
// its main-path mode: fused + in-kernel raygen + precomputed tables (body
// _kernel -> _trace_tile_nonempty, pallas_call at pallas_tiled.py:1336).
// The plain PyTorch version of the same walk is
// rtmm_tpu_torch/ops/tile_trace.py::trace_fused_plain; the two do the same
// float32 operations in the same order, and this file is built with
// -fmad=false (no a*b+c contraction) and without fast math, so they agree
// bit for bit except where a reduction order differs (the tie-sum of
// winner normals when several leaves hit at exactly the same t).
//
// Design. One block per 32x32 ray tile, one thread per ray (1,024
// threads). The block walks the tile's front-to-back cluster list: the
// first 64 threads cull the cluster's 64 units against the tile's
// sub-cones and hold each unit's apex distance and integer key
// (distance bits | lane); per step the block picks the two nearest units
// that some sub-tile can still use (pick-2 with a warp butterfly over
// the two smallest keys), stages their tables in shared memory, and every
// thread runs Möller-Trumbore over the 2 x 64 leaves for its own ray,
// keeping its closest hit in registers. Per-sub worst-hit bounds are
// block max-reductions (warp shuffles + shared atomics on order-preserving
// integer keys: a max is exact in any order). The tile stops when the
// worst bound is below the next cluster's entry distance; empty tiles
// write the background and leave.
//
// What bounds it: arithmetic. Each (ray, leaf) test is ~55 float32
// operations (four 6-term dot products, one correctly rounded division,
// four products and the compares); the unit tables are read once per
// visit from L2 into shared memory and broadcast to all 1,024 threads, so
// device-memory traffic is small (chip_smoke.py prints both bounds).
// This first version aims to be right; it uses no tensor cores.
//
// The TPU mechanics are left behind: bf16 hi/lo splits, one-hot matmul
// gathers and transposes, DMA semaphores, tiles_per_block, A/B knobs.

#include <cuda_runtime.h>

#include <climits>
#include <cstring>

namespace {

constexpr int kTileW = 32;
constexpr int kTileH = 32;
constexpr int kTile = kTileW * kTileH;     // threads per block, one ray each
constexpr int kLpu = 64;                   // leaves per unit
constexpr int kUpc = 64;                   // units per cluster
constexpr int kMetaLanes = 128;            // cluster_unit_meta row width
constexpr int kQnCols = 4 * kLpu + 128;    // unit_qn row: det|u|v|t|normals
constexpr int kMaxSub = 8;
constexpr float kBig = 1e30f;              // miss sentinel
constexpr float kUvEps = 1e-3f;            // MT_UV_EPS, intersection.hlsl:413
constexpr int kIMax = 0x7FFFFFFF;          // removed / ineligible key

// Float parameters, laid out as tile_trace.py::shade_params packs them.
struct Params {
  float width, height, t_min, t_max;
  float bg[3], alb[3], f0[3], one_m_f0[3], alb_pi[3], ambient[3];
  float radiance[4][3];
  float one_m_metal, ggx_one_m_k, ggx_k, a2m1, a2, pi, sw;
};
constexpr int kNumParams = sizeof(Params) / sizeof(float);

struct Shared {
  float q[2][6][4 * kLpu];   // staged units: det | u | v | w columns, rows 0-5
  float nrm[2][3][kLpu];     // staged units: leaf normals
  float tn[2][kLpu];         // staged units: per-frame t numerators
  float ctr[3][kUpc];        // cluster's unit AABB centers
  float dist[kUpc];          // apex -> unit AABB distance
  int dkey[kUpc];            // (distance bits & ~127) | lane
  unsigned inside[kUpc];     // bit j: unit inside sub-cone j
  int removed[kUpc];
  int ws_key[kMaxSub];       // per-sub worst bound, order-preserving int
  int pk[2][2];              // per-warp two smallest keys
  int pick[2];
};

// NaN-propagating max/min (jnp.maximum / torch.maximum semantics).
__device__ __forceinline__ float jmax(float a, float b) {
  return (a != a || b != b) ? a + b : fmaxf(a, b);
}
__device__ __forceinline__ float jmin(float a, float b) {
  return (a != a || b != b) ? a + b : fminf(a, b);
}

// Float <-> int keys whose signed-int order is the float order.
__device__ __forceinline__ int ord_key(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7FFFFFFF;
}
__device__ __forceinline__ float ord_val(int k) {
  return __int_as_float(k >= 0 ? k : k ^ 0x7FFFFFFF);
}

// Per-sub-tile worst-case reach (pallas_tiled.py worst_subs): a ray
// contributes its hit's apex-relative t, or — while it still misses — its
// scene-exit t; with several subs, rays outside sub j count as 0. Returns
// the max over the subs. Every thread must have passed a barrier since
// the last read of ws_key.
__device__ float worst_subs(Shared& sh, float bt, float s, float exit_t,
                            int my_sub, int nsub, int sub_lanes, int tid) {
  if (tid < kMaxSub) sh.ws_key[tid] = INT_MIN;
  __syncthreads();
  float v = bt < kBig ? bt + s : exit_t;
  if (nsub > 1) v = v > 0.0f ? v : 0.0f;
  int key = ord_key(v);
  for (int o = sub_lanes / 2; o >= 1; o >>= 1)
    key = max(key, __shfl_xor_sync(0xffffffffu, key, o));
  if (tid % sub_lanes == 0) atomicMax(&sh.ws_key[my_sub], key);
  __syncthreads();
  float wmax = ord_val(sh.ws_key[0]);
  for (int j = 1; j < nsub; ++j) wmax = fmaxf(wmax, ord_val(sh.ws_key[j]));
  return wmax;
}

// Load one cluster's unit metadata and cull its units (cluster_body).
__device__ void load_cluster(Shared& sh, const float* __restrict__ meta,
                             int cl, const float* __restrict__ fr, int nsub,
                             float ax, float ay, float az, int tid) {
  if (tid < kUpc) {
    const float* mt = meta + static_cast<size_t>(cl) * 8 * kMetaLanes + tid;
    const float mnx = mt[0 * kMetaLanes], mny = mt[1 * kMetaLanes];
    const float mnz = mt[2 * kMetaLanes];
    const float mxx = mt[3 * kMetaLanes], mxy = mt[4 * kMetaLanes];
    const float mxz = mt[5 * kMetaLanes];
    const bool valid = mt[6 * kMetaLanes] > 0.0f;
    // Unit centers: 0.5*(min+max), the recentering origin of unit_qn.
    sh.ctr[0][tid] = 0.5f * (mnx + mxx);
    sh.ctr[1][tid] = 0.5f * (mny + mxy);
    sh.ctr[2][tid] = 0.5f * (mnz + mxz);
    unsigned in = 0;
    for (int j = 0; j < nsub; ++j) {
      bool inside = valid;
      for (int p = 0; p < 4; ++p) {
        const float* n = fr + 3 + 12 * j + 3 * p;
        const float dot = n[0] * ((n[0] >= 0.0f ? mxx : mnx) - ax)
                        + n[1] * ((n[1] >= 0.0f ? mxy : mny) - ay)
                        + n[2] * ((n[2] >= 0.0f ? mxz : mnz) - az);
        inside = inside && dot >= 0.0f;
      }
      if (inside) in |= 1u << j;
    }
    sh.inside[tid] = in;
    const float ddx = jmax(jmax(mnx - ax, ax - mxx), 0.0f);
    const float ddy = jmax(jmax(mny - ay, ay - mxy), 0.0f);
    const float ddz = jmax(jmax(mnz - az, az - mxz), 0.0f);
    const float dist = sqrtf(ddx * ddx + ddy * ddy + ddz * ddz);
    sh.dist[tid] = dist;
    sh.dkey[tid] = (__float_as_int(dist) & -128) | tid;
    sh.removed[tid] = 0;
  }
  __syncthreads();
}

// Pick the two nearest units that are eligible (inside some sub-cone and
// no farther than its worst bound) and not removed; then remove every
// unit ineligible at this pick and the picked ones (pick2 / unit_body).
__device__ void pick2(Shared& sh, int nsub, int tid) {
  if (tid < kUpc) {
    const float d = sh.dist[tid];
    const unsigned in = sh.inside[tid];
    bool elig = false;
    for (int j = 0; j < nsub; ++j)
      elig = elig || (((in >> j) & 1u) && d <= ord_val(sh.ws_key[j]));
    int a = (elig && !sh.removed[tid]) ? sh.dkey[tid] : kIMax;
    if (!elig) sh.removed[tid] = 1;
    int b = kIMax;
    for (int o = 16; o >= 1; o >>= 1) {
      const int a2 = __shfl_xor_sync(0xffffffffu, a, o);
      const int b2 = __shfl_xor_sync(0xffffffffu, b, o);
      const int lo = min(a, a2);
      b = min(max(a, a2), min(b, b2));
      a = lo;
    }
    if ((tid & 31) == 0) {
      sh.pk[tid >> 5][0] = a;
      sh.pk[tid >> 5][1] = b;
    }
  }
  __syncthreads();
  if (tid == 0) {
    const int a0 = sh.pk[0][0], b0 = sh.pk[0][1];
    const int a1 = sh.pk[1][0], b1 = sh.pk[1][1];
    const int p0 = min(a0, a1);
    const int p1 = min(max(a0, a1), min(b0, b1));
    const int u0 = p0 < kIMax ? (p0 & 127) : 128;
    const int u1 = p1 < kIMax ? (p1 & 127) : 128;
    if (u0 < kUpc) sh.removed[u0] = 1;
    if (u1 < kUpc) sh.removed[u1] = 1;
    sh.pick[0] = u0;
    sh.pick[1] = u1;
  }
  __syncthreads();
}

// Stage the picked units' tables: the det|u|v columns, the w column
// formed on the q columns ((det - u) - v, before any dot product), the
// normals and t_num = -((a-c).(-n)) - e2.w2 (unit_tables).
__device__ void stage_units(Shared& sh, const float* __restrict__ unit_qn,
                            int cl, int ua, int ub, int nslot, float ax,
                            float ay, float az, int tid) {
  constexpr int kCols = 6 * kLpu;
  if (tid < nslot * kCols) {
    const int slot = tid / kCols;
    const int row = (tid % kCols) / kLpu;
    const int k = tid % kLpu;
    const int u = slot ? ub : ua;
    const float* q = unit_qn
        + (static_cast<size_t>(cl * kUpc + u) * 8 + row) * kQnCols;
    const float qd = q[k], qu = q[kLpu + k], qv = q[2 * kLpu + k];
    sh.q[slot][row][k] = qd;
    sh.q[slot][row][kLpu + k] = qu;
    sh.q[slot][row][2 * kLpu + k] = qv;
    sh.q[slot][row][3 * kLpu + k] = (qd - qu) - qv;
  } else if (tid >= 2 * kCols && tid < 2 * kCols + nslot * kLpu) {
    const int slot = (tid - 2 * kCols) / kLpu;
    const int k = (tid - 2 * kCols) % kLpu;
    const int u = slot ? ub : ua;
    const float* q = unit_qn + static_cast<size_t>(cl * kUpc + u) * 8 * kQnCols;
    const float cx = sh.ctr[0][u], cy = sh.ctr[1][u], cz = sh.ctr[2][u];
    const float s_neg = (ax - cx) * q[0 * kQnCols + k]
                      + (ay - cy) * q[1 * kQnCols + k]
                      + (az - cz) * q[2 * kQnCols + k];
    sh.tn[slot][k] = -s_neg - q[3 * kQnCols + 4 * kLpu + k];
    for (int r = 0; r < 3; ++r) sh.nrm[slot][r][k] = q[r * kQnCols + 4 * kLpu + k];
  }
  __syncthreads();
}

// One unit visit for this thread's ray (process_unit + ep_fold).
__device__ __forceinline__ void process_unit(
    const Shared& sh, int slot, int u, float dx, float dy, float dz,
    float mx, float my, float mz, float s, float pmin, float pmax,
    float& bt, float& bnx, float& bny, float& bnz) {
  const float cx = sh.ctr[0][u], cy = sh.ctr[1][u], cz = sh.ctr[2][u];
  // Recentered moment m' = (a - c) x d = m - c x d.
  const float mpx = mx - (cy * dz - cz * dy);
  const float mpy = my - (cz * dx - cx * dz);
  const float mpz = mz - (cx * dy - cy * dx);
  const float (*q)[4 * kLpu] = sh.q[slot];
  float pb = kBig, nsx = 0.0f, nsy = 0.0f, nsz = 0.0f;
#pragma unroll 2
  for (int k = 0; k < kLpu; ++k) {
    const float det = q[0][k] * dx + q[1][k] * dy + q[2][k] * dz
                    + q[3][k] * mpx + q[4][k] * mpy + q[5][k] * mpz;
    const int ku = kLpu + k, kv = 2 * kLpu + k, kw = 3 * kLpu + k;
    const float un = q[0][ku] * dx + q[1][ku] * dy + q[2][ku] * dz
                   + q[3][ku] * mpx + q[4][ku] * mpy + q[5][ku] * mpz;
    const float vn = q[0][kv] * dx + q[1][kv] * dy + q[2][kv] * dz
                   + q[3][kv] * mpx + q[4][kv] * mpy + q[5][kv] * mpz;
    const float wn = q[0][kw] * dx + q[1][kw] * dy + q[2][kw] * dz
                   + q[3][kw] * mpx + q[4][kw] * mpy + q[5][kw] * mpz;
    // No det guard: det == 0 gives inf/NaN quotients that fail the window.
    const float iv = 1.0f / det;
    const float uu = un * iv, vv = vn * iv, ww = wn * iv;
    const float pp = sh.tn[slot][k] * iv;
    // w-form acceptance, min(u, v, w) >= -eps (a NaN fails every compare).
    const bool ok = uu >= -kUvEps && vv >= -kUvEps && ww >= -kUvEps
                 && pp >= pmin;
    const float p = ok ? pp : kBig;
    // Leaf minimum with the winner normal summed over exact ties.
    if (k == 0 || p < pb) {
      pb = p;
      nsx = sh.nrm[slot][0][k];
      nsy = sh.nrm[slot][1][k];
      nsz = sh.nrm[slot][2][k];
    } else if (p == pb) {
      nsx += sh.nrm[slot][0][k];
      nsy += sh.nrm[slot][1][k];
      nsz += sh.nrm[slot][2][k];
    }
  }
  // Upper t-window on the leaf minimum; the 1e30 sentinel survives - s.
  const float tb = pb <= pmax ? pb - s : kBig;
  if (tb < bt) {
    bt = tb;
    bnx = nsx;
    bny = nsy;
    bnz = nsz;
  }
}

// Cook-Torrance GGX + Reinhard (ops/shading.py::shade_rows).
__device__ void shade_rows(float nx, float ny, float nz, float vx, float vy,
                           float vz, bool hit, const Params& P, float rgb[3]) {
  const float L[4][3] = {{0.0f, 0.0f, 1.0f}, {0.0f, 1.0f, 0.0f},
                         {0.0f, 0.0f, -1.0f}, {0.0f, -1.0f, 0.0f}};
  const float n_dot_v = jmax(nx * vx + ny * vy + nz * vz, 0.0f);
  const float ggx_v = n_dot_v / (n_dot_v * P.ggx_one_m_k + P.ggx_k);
  float lo[3] = {0.0f, 0.0f, 0.0f};
  for (int l = 0; l < 4; ++l) {
    const float lx = L[l][0], ly = L[l][1], lz = L[l][2];
    float hx = vx + lx, hy = vy + ly, hz = vz + lz;
    const float hnorm = jmax(sqrtf(hx * hx + hy * hy + hz * hz), 1e-20f);
    hx = hx / hnorm;
    hy = hy / hnorm;
    hz = hz / hnorm;
    const float n_dot_l = jmax(nx * lx + ny * ly + nz * lz, 0.0f);
    const float n_dot_h = jmax(nx * hx + ny * hy + nz * hz, 0.0f);
    const float dg = n_dot_h * n_dot_h * P.a2m1 + 1.0f;
    const float ndf = P.a2 / (P.pi * dg * dg);
    const float g = ggx_v * (n_dot_l / (n_dot_l * P.ggx_one_m_k + P.ggx_k));
    const float h_dot_v = jmax(hx * vx + hy * vy + hz * vz, 0.0f);
    const float x = jmin(jmax(1.0f - h_dot_v, 0.0f), 1.0f);
    const float x2 = x * x;
    const float fres5 = x * (x2 * x2);
    const float denom = 4.0f * n_dot_v * n_dot_l + 0.0001f;
    const float ndf_g = ndf * g;
    for (int c = 0; c < 3; ++c) {
      const float f_c = P.f0[c] + P.one_m_f0[c] * fres5;
      const float k_d = (1.0f - f_c) * P.one_m_metal;
      const float spec = ndf_g * f_c / denom;
      lo[c] = lo[c] + ((k_d * P.alb_pi[c] + spec) * P.radiance[l][c] * n_dot_l);
    }
  }
  for (int c = 0; c < 3; ++c) {
    float color = P.ambient[c] + lo[c];
    color = color / (color + 1.0f);
    color = P.alb[c] + (color - P.alb[c]) * P.sw;
    rgb[c] = hit ? color : P.bg[c];
  }
}

__global__ void __launch_bounds__(kTile, 1)
tile_trace_fused_kernel(const int* __restrict__ ccand,
                        const int* __restrict__ ccount,
                        const float* __restrict__ centry,
                        const float* __restrict__ frus,
                        const float* __restrict__ meta,
                        const float* __restrict__ unit_qn,
                        float* __restrict__ image, int* __restrict__ visits,
                        int* __restrict__ eligible, int kc, int pack,
                        int tiles_per_frame, int tx, int pw, int ph,
                        int nsub, int nrows, const Params P) {
  __shared__ Shared sh;
  const int row = blockIdx.x;                 // tile row, frame-major
  const int tid = threadIdx.x;
  const int pr = tid / kTileW, pc = tid % kTileW;
  const int frame = row / tiles_per_frame, t = row % tiles_per_frame;
  const int py = (t / tx) * kTileH + pr, px = (t % tx) * kTileW + pc;
  float* out = image + ((static_cast<size_t>(frame) * ph + py) * pw + px) * 3;
  const float* fr = frus + static_cast<size_t>(row) * pack;
  const int ccnt = min(ccount[row], kc);
  if (ccnt <= 0) {                            // empty tile: background
    out[0] = P.bg[0];
    out[1] = P.bg[1];
    out[2] = P.bg[2];
    if (tid == 0) {
      visits[row] = 0;
      eligible[row] = 0;
    }
    return;
  }

  // In-kernel raygen (_raygen_rows): explicit unproject, true divisions.
  const int rg = 3 + nsub * 12;
  const float* m = fr + rg + 2;
  const float u = (fr[rg] + static_cast<float>(pc) + 0.5f) / P.width;
  const float v = (fr[rg + 1] + static_cast<float>(pr) + 0.5f) / P.height;
  const float ndc_x = u * 2.0f - 1.0f;
  const float ndc_y = -(v * 2.0f - 1.0f);
  float pn[4], pf[4];
  for (int i = 0; i < 4; ++i) {
    pn[i] = m[4 * i] * ndc_x + m[4 * i + 1] * ndc_y + m[4 * i + 3];
    pf[i] = m[4 * i] * ndc_x + m[4 * i + 1] * ndc_y
          + (m[4 * i + 2] + m[4 * i + 3]);
  }
  const float ox = pn[0] / pn[3], oy = pn[1] / pn[3], oz = pn[2] / pn[3];
  float dx = pf[0] / pf[3] - ox;
  float dy = pf[1] / pf[3] - oy;
  float dz = pf[2] / pf[3] - oz;
  const float ln = sqrtf(dx * dx + dy * dy + dz * dz);
  dx = dx / ln;
  dy = dy / ln;
  dz = dz / ln;
  const float ax = fr[0], ay = fr[1], az = fr[2];
  const float s = (ox - ax) * dx + (oy - ay) * dy + (oz - az) * dz;
  const float mx = ay * dz - az * dy;
  const float my = az * dx - ax * dz;
  const float mz = ax * dy - ay * dx;

  // Per-ray reach: slab exit through the inflated scene AABB.
  const float* box = fr + rg + 18;
  const float dd[3] = {dx, dy, dz}, aa[3] = {ax, ay, az};
  float exit_t = 0.0f;
  for (int k = 0; k < 3; ++k) {
    const float sd = fabsf(dd[k]) < 1e-12f ? (dd[k] >= 0.0f ? 1e-12f : -1e-12f)
                                          : dd[k];
    const float inv = 1.0f / sd;
    const float ek = jmax((box[k] - aa[k]) * inv, (box[3 + k] - aa[k]) * inv);
    exit_t = k == 0 ? ek : jmin(exit_t, ek);
  }
  const float pmin = P.t_min + s;
  const float pmax = P.t_max + s;

  const int ncols = nsub / nrows;
  const int sub_lanes = kTileW / ncols;
  const int my_sub = (pr / (kTileH / nrows)) * ncols + pc / sub_lanes;

  float bt = kBig, bnx = 0.0f, bny = 0.0f, bnz = 0.0f;
  int nv = 0, ne = 0;
  float wmax = worst_subs(sh, bt, s, exit_t, my_sub, nsub, sub_lanes, tid);
  const int* cand = ccand + static_cast<size_t>(row) * kc;
  const float* entry = centry + static_cast<size_t>(row) * kc;
  // Cluster stop rule (cluster_cond): no remaining cluster can beat the
  // tile's worst bound.
  for (int ci = 0; ci < ccnt && wmax >= entry[min(ci, kc - 1)]; ++ci) {
    const int cl = cand[ci];
    load_cluster(sh, meta, cl, fr, nsub, ax, ay, az, tid);
    pick2(sh, nsub, tid);
    int ua = sh.pick[0], ub = sh.pick[1];
    while (ua < 128) {
      const bool hasb = ub < 128;
      stage_units(sh, unit_qn, cl, ua, ub, hasb ? 2 : 1, ax, ay, az, tid);
      process_unit(sh, 0, ua, dx, dy, dz, mx, my, mz, s, pmin, pmax,
                   bt, bnx, bny, bnz);
      // (The TPU kernel recomputes unit A in a slot with no B: an
      // idempotent fold, skipped here.)
      if (hasb)
        process_unit(sh, 1, ub, dx, dy, dz, mx, my, mz, s, pmin, pmax,
                     bt, bnx, bny, bnz);
      nv += 1 + hasb;
      ne += 1 + hasb;
      wmax = worst_subs(sh, bt, s, exit_t, my_sub, nsub, sub_lanes, tid);
      pick2(sh, nsub, tid);
      ua = sh.pick[0];
      ub = sh.pick[1];
    }
  }

  // Epilogue: normalise the selected normal, shade against -d.
  const float nn = jmax(sqrtf(bnx * bnx + bny * bny + bnz * bnz), 1e-20f);
  float rgb[3];
  shade_rows(bnx / nn, bny / nn, bnz / nn, -dx, -dy, -dz, bt < kBig, P, rgb);
  out[0] = rgb[0];
  out[1] = rgb[1];
  out[2] = rgb[2];
  if (tid == 0) {
    visits[row] = nv;
    eligible[row] = ne;
  }
}

}  // namespace

// Launch the fused trace over n_rows tile rows on `stream`. host_params
// points to kNumParams floats in host memory (Params). Returns the CUDA
// error code of the launch (0 = launched).
extern "C" int rtmm_tile_trace_fused(
    const int* ccand, const int* ccount, const float* centry,
    const float* frus, const float* meta, const float* unit_qn, float* image,
    int* visits, int* eligible, int n_rows, int kc, int pack,
    int tiles_per_frame, int tx, int pw, int ph, int nsub, int nrows,
    const float* host_params, int n_params, void* stream) {
  if (n_params != kNumParams || nsub < 1 || nsub > kMaxSub || nrows < 1 ||
      nsub % nrows != 0 || kc < 1 || n_rows < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  std::memcpy(&p, host_params, sizeof(Params));
  tile_trace_fused_kernel<<<n_rows, kTile, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      ccand, ccount, centry, frus, meta, unit_qn, image, visits, eligible, kc,
      pack, tiles_per_frame, tx, pw, ph, nsub, nrows, p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rtmm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
