// Tile trace for NVIDIA Hopper (sm_90a): the walk of every ported mode.
//
// Replaces the TPU kernel rtmm_tpu/ops/pallas_tiled.py::trace_pallas
// (body _kernel -> _trace_tile_nonempty, pallas_call at
// pallas_tiled.py:1336) in all four of its modes, as template parameters
// <Compressed, Mode> of one kernel over one walk. The three output modes:
//   K1a  fused (kFused): in-kernel raygen (or a ray-matrix input), shaded
//        in-kernel;
//   K1b  windowed (kWindowed): one cluster window of a longer walk; the ray
//        matrix is an input, the running best hit (t, summed winner
//        normal, visit/eligible counters) is carried in and out, no shading;
//   K1d  raw (kRaw; raw=True, with xform=True for the instanced raygen): no
//        carries in, every row starts at t = 1e30, one compact output row
//        [t, nx, ny, nz] per tile row, no shading. Rays come from a ray
//        matrix, or from the world raygen followed by the row's object
//        transform (d_o = R^T d_w, s_o = s_w / scale, moments about the
//        object-space apex at the pack head): one launch traces the tile
//        rows of every instance of a two-level scene;
// and, across all three,
//   K1c  compressed (Compressed): each visited unit's tables are derived
//        from its displaced grid-vertex record (_derive_unit, :309-465)
//        instead of read from unit_qn.
// The plain PyTorch versions are rtmm_tpu_torch/ops/tile_trace.py::
// trace_fused_plain, trace_windowed_plain and trace_raw_plain; they do the
// same float32 operations in the same order, and this file is built with
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
// write the background (fused), pass the carries through (windowed) or
// write a miss (raw).
// Compressed staging loads the two records' <= 45 positions into shared
// memory and derives one (unit, leaf) per thread on 128 threads; the
// corner gather is an indexed load (the TPU's one-hot matmul gathers the
// same value exactly).
//
// What bounds it: arithmetic. Each (ray, leaf) test here is ~55 float32
// operations (four 6-term dot products, one correctly rounded division,
// four products and the compares; the det column's moment rows are 0, so
// the test needs ~49 of them); the unit tables or records are read
// once per visit from L2 into shared memory and broadcast to all 1,024
// threads, so device-memory traffic is small (chip_smoke.py prints both
// bounds). The raw mode writes 16 KB per row, its largest stream, and
// stays bound by arithmetic. The compressed derive adds ~100 operations
// per leaf per visit, done by 128 threads while the other 896 wait at the
// barrier. This first version aims to be right; it uses no tensor cores.
//
// The TPU mechanics are left behind: bf16 hi/lo splits, one-hot matmul
// gathers and transposes, the widened gather layout, DMA semaphores,
// tiles_per_block, A/B knobs.

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
constexpr int kGridLanes = 128;            // compressed record row width
constexpr float kBig = 1e30f;              // miss sentinel
constexpr float kUvEps = 1e-3f;            // MT_UV_EPS, intersection.hlsl:413
constexpr int kIMax = 0x7FFFFFFF;          // removed / ineligible key

// Output modes of the kernel.
constexpr int kFused = 0;     // shade in-kernel, write the image
constexpr int kWindowed = 1;  // carries in and out
constexpr int kRaw = 2;       // fresh start, compact [t | n] rows out

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
  float pos[2][3][kGridLanes];  // compressed: staged records' positions
  int cidx[2][3][kLpu];         // compressed: leaf-corner lanes per slot
};

// Where a unit's tables come from: precomputed unit_qn rows, or compressed
// records with shared corner lanes (corners) or per-unit index rows.
struct Tables {
  const float* unit_qn;  // (U, 8, kQnCols), precomputed scenes
  const float* grid;     // (U, grows, kGridLanes), compressed scenes
  const int* corners;    // (3, kLpu) shared lanes; null: record rows 3-5
  int grows;
};

// Kernel arguments of every mode (the unused ones are null).
struct Args {
  const int* ccand;      // (N, kc) front-to-back cluster lists
  const int* ccount;     // (N,)
  const float* centry;   // (N, kc) cluster entry distances
  const float* frus;     // (N, pack) per-tile scalar pack
  const float* raymat;   // (N, 8, kTile) rows [d, m, s, 1]; null: raygen
  const float* meta;     // (C, 8, kMetaLanes) per-cluster unit AABBs
  Tables tab;
  float* image;          // fused: (F, ph, pw, 3) rgb
  const float* t_in;     // windowed carries in: (N, kTile) best t,
  const float* n_in;     //   (N, 3, kTile) summed winner normals,
  const int* vis_in;     //   (N,) visits and (N,) eligible so far
  const int* elig_in;
  float* t_out;          // windowed carries out, same layouts
  float* n_out;
  float* raw_out;        // raw: (N, 4, kTile) rows [t, nx, ny, nz]
  int* visits;           // (N,) per-tile counters
  int* eligible;
  int kc, pack, tiles_per_frame, tx, pw, ph, nsub, nrows;
  // Raw raygen only: the pack carries [R^T (9), inv_s, apex_w (3)] after
  // the scene box, and the generated world rays go to object space.
  int xform;
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
  constexpr int kCols = 6 * kLpu;  // 2 slots x 384 + 2 x 64 <= kTile threads
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

// Derive the picked units' tables from their compressed records
// (_derive_unit): positions into shared memory, then one thread per
// (unit, leaf) forms e1, e2, n, w1, w2 recentered on the unit AABB center,
// e2.w2, t_num = (a-c).n - e2.w2 and the normalised normal, in
// _derive_unit's order, into the same q / tn / nrm layout as stage_units
// (w column (det - u) - v on the q columns). Shared corner lanes were
// loaded into sh.cidx once per block; indexed records carry their own.
__device__ void stage_grid_units(Shared& sh, const Tables& tab, int cl,
                                 int ua, int ub, int nslot, float ax,
                                 float ay, float az, int tid) {
  constexpr int kPos = 3 * kGridLanes;
  if (tid < nslot * kPos) {
    const int slot = tid / kPos;
    const int r = (tid % kPos) / kGridLanes;
    const int l = tid % kGridLanes;
    const int u = slot ? ub : ua;
    sh.pos[slot][r][l] = tab.grid[
        (static_cast<size_t>(cl * kUpc + u) * tab.grows + r) * kGridLanes + l];
  }
  if (tab.corners == nullptr && tid < nslot * 3 * kLpu) {
    const int slot = tid / (3 * kLpu);
    const int j = (tid % (3 * kLpu)) / kLpu;
    const int k = tid % kLpu;
    const int u = slot ? ub : ua;
    const float f = tab.grid[
        (static_cast<size_t>(cl * kUpc + u) * tab.grows + 3 + j) * kGridLanes
        + k];
    // Lane indices are small integers in float32 (truncating cast, as
    // astype(int32)); the clamp only guards memory against a bad record.
    sh.cidx[slot][j][k] = min(max(static_cast<int>(f), 0), kGridLanes - 1);
  }
  __syncthreads();
  if (tid < nslot * kLpu) {
    const int slot = tid / kLpu;
    const int k = tid % kLpu;
    const int u = slot ? ub : ua;
    const float cx = sh.ctr[0][u], cy = sh.ctr[1][u], cz = sh.ctr[2][u];
    const int i0 = sh.cidx[slot][0][k], i1 = sh.cidx[slot][1][k];
    const int i2 = sh.cidx[slot][2][k];
    const float (*p)[kGridLanes] = sh.pos[slot];
    const float v0x = p[0][i0], v0y = p[1][i0], v0z = p[2][i0];
    const float e1x = p[0][i1] - v0x, e1y = p[1][i1] - v0y;
    const float e1z = p[2][i1] - v0z;
    const float e2x = p[0][i2] - v0x, e2y = p[1][i2] - v0y;
    const float e2z = p[2][i2] - v0z;
    const float cx0 = v0x - cx, cy0 = v0y - cy, cz0 = v0z - cz;
    const float nx = e1y * e2z - e1z * e2y;
    const float ny = e1z * e2x - e1x * e2z;
    const float nz = e1x * e2y - e1y * e2x;
    const float w1x = e2y * cz0 - e2z * cy0;
    const float w1y = e2z * cx0 - e2x * cz0;
    const float w1z = e2x * cy0 - e2y * cx0;
    const float w2x = cy0 * e1z - cz0 * e1y;
    const float w2y = cz0 * e1x - cx0 * e1z;
    const float w2z = cx0 * e1y - cy0 * e1x;
    const float e2w2 = e2x * w2x + e2y * w2y + e2z * w2z;
    sh.tn[slot][k] = (ax - cx) * nx + (ay - cy) * ny + (az - cz) * nz - e2w2;
    // q rows [-n | -w1 | -w2] over the d rows, [0 | e2 | -e1] over the
    // moment rows.
    const float qd[6] = {-nx, -ny, -nz, 0.0f, 0.0f, 0.0f};
    const float qu[6] = {-w1x, -w1y, -w1z, e2x, e2y, e2z};
    const float qv[6] = {-w2x, -w2y, -w2z, -e1x, -e1y, -e1z};
    for (int r = 0; r < 6; ++r) {
      sh.q[slot][r][k] = qd[r];
      sh.q[slot][r][kLpu + k] = qu[r];
      sh.q[slot][r][2 * kLpu + k] = qv[r];
      sh.q[slot][r][3 * kLpu + k] = (qd[r] - qu[r]) - qv[r];
    }
    const float nn = jmax(sqrtf(nx * nx + ny * ny + nz * nz), 1e-20f);
    sh.nrm[slot][0][k] = nx / nn;
    sh.nrm[slot][1][k] = ny / nn;
    sh.nrm[slot][2][k] = nz / nn;
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

template <bool Compressed, int Mode>
__global__ void __launch_bounds__(kTile, 1)
tile_trace_kernel(const Args a, const Params P) {
  constexpr bool Windowed = Mode == kWindowed;
  __shared__ Shared sh;
  const int row = blockIdx.x;                 // tile row, frame-major
  const int tid = threadIdx.x;
  const int pr = tid / kTileW, pc = tid % kTileW;
  const float* fr = a.frus + static_cast<size_t>(row) * a.pack;
  const size_t ray = static_cast<size_t>(row) * kTile + tid;
  float* out = nullptr;
  if (Mode == kFused) {
    const int frame = row / a.tiles_per_frame, t = row % a.tiles_per_frame;
    const int py = (t / a.tx) * kTileH + pr, px = (t % a.tx) * kTileW + pc;
    out = a.image + ((static_cast<size_t>(frame) * a.ph + py) * a.pw + px) * 3;
  }
  const int ccnt = min(a.ccount[row], a.kc);
  if (ccnt <= 0) {
    if (Windowed) {                           // empty tile: carries through
      a.t_out[ray] = a.t_in[ray];
      for (int r = 0; r < 3; ++r) {
        const size_t i = (static_cast<size_t>(row) * 3 + r) * kTile + tid;
        a.n_out[i] = a.n_in[i];
      }
      if (tid == 0) {
        a.visits[row] = a.vis_in[row];
        a.eligible[row] = a.elig_in[row];
      }
    } else {
      if (Mode == kRaw) {                     // empty row: a miss
        float* ro = a.raw_out + static_cast<size_t>(row) * 4 * kTile + tid;
        ro[0 * kTile] = kBig;
        ro[1 * kTile] = 0.0f;
        ro[2 * kTile] = 0.0f;
        ro[3 * kTile] = 0.0f;
      } else {                                // empty tile: background
        out[0] = P.bg[0];
        out[1] = P.bg[1];
        out[2] = P.bg[2];
      }
      if (tid == 0) {
        a.visits[row] = 0;
        a.eligible[row] = 0;
      }
    }
    return;
  }

  // The pack head is the apex of the walk: the camera, or with an object
  // transform the camera in the row's object space.
  const float ax = fr[0], ay = fr[1], az = fr[2];
  float dx, dy, dz, s, mx, my, mz;
  const bool raygen = a.raymat == nullptr;
  if (raygen) {
    // In-kernel raygen (_raygen_rows): explicit unproject, true divisions.
    const int rg = 3 + a.nsub * 12;
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
    dx = pf[0] / pf[3] - ox;
    dy = pf[1] / pf[3] - oy;
    dz = pf[2] / pf[3] - oz;
    const float ln = sqrtf(dx * dx + dy * dy + dz * dz);
    dx = dx / ln;
    dy = dy / ln;
    dz = dz / ln;
    if (Mode == kRaw && a.xform) {
      // World s against the world apex, then the row's object transform
      // (_raygen_rows with xform_off): d_o = R^T d_w, three 3-term sums
      // left to right; s scales by 1/scale (|d_o| = 1, R a rotation).
      const float* xf = fr + rg + 18 + 6;
      s = (ox - xf[10]) * dx + (oy - xf[11]) * dy + (oz - xf[12]) * dz;
      const float dxo = xf[0] * dx + xf[1] * dy + xf[2] * dz;
      const float dyo = xf[3] * dx + xf[4] * dy + xf[5] * dz;
      const float dzo = xf[6] * dx + xf[7] * dy + xf[8] * dz;
      dx = dxo;
      dy = dyo;
      dz = dzo;
      s = s * xf[9];
    } else {
      s = (ox - ax) * dx + (oy - ay) * dy + (oz - az) * dz;
    }
    mx = ay * dz - az * dy;
    my = az * dx - ax * dz;
    mz = ax * dy - ay * dx;
  } else {
    // Ray-matrix input: rows [d, a x d, s, 1] of this tile's rays.
    const float* rm = a.raymat + static_cast<size_t>(row) * 8 * kTile + tid;
    dx = rm[0 * kTile];
    dy = rm[1 * kTile];
    dz = rm[2 * kTile];
    mx = rm[3 * kTile];
    my = rm[4 * kTile];
    mz = rm[5 * kTile];
    s = rm[6 * kTile];
  }

  // Per-ray reach: slab exit through the inflated scene AABB, which
  // follows the raygen scalars when the pack has them.
  const float* box = fr + 3 + 12 * a.nsub + (raygen ? 18 : 0);
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

  const int nsub = a.nsub;
  const int ncols = nsub / a.nrows;
  const int sub_lanes = kTileW / ncols;
  const int my_sub = (pr / (kTileH / a.nrows)) * ncols + pc / sub_lanes;

  // The running best: fresh (fused, raw), or carried from earlier windows.
  float bt = kBig, bnx = 0.0f, bny = 0.0f, bnz = 0.0f;
  int nv = 0, ne = 0;
  if (Windowed) {
    bt = a.t_in[ray];
    bnx = a.n_in[(static_cast<size_t>(row) * 3 + 0) * kTile + tid];
    bny = a.n_in[(static_cast<size_t>(row) * 3 + 1) * kTile + tid];
    bnz = a.n_in[(static_cast<size_t>(row) * 3 + 2) * kTile + tid];
    nv = a.vis_in[row];
    ne = a.elig_in[row];
  }
  if (Compressed && a.tab.corners != nullptr && tid < 3 * kLpu) {
    const int c = a.tab.corners[tid];         // shared corner lanes
    sh.cidx[0][tid / kLpu][tid % kLpu] = c;
    sh.cidx[1][tid / kLpu][tid % kLpu] = c;
  }
  float wmax = worst_subs(sh, bt, s, exit_t, my_sub, nsub, sub_lanes, tid);
  const int* cand = a.ccand + static_cast<size_t>(row) * a.kc;
  const float* entry = a.centry + static_cast<size_t>(row) * a.kc;
  // Cluster stop rule (cluster_cond): no remaining cluster can beat the
  // tile's worst bound.
  for (int ci = 0; ci < ccnt && wmax >= entry[min(ci, a.kc - 1)]; ++ci) {
    const int cl = cand[ci];
    load_cluster(sh, a.meta, cl, fr, nsub, ax, ay, az, tid);
    pick2(sh, nsub, tid);
    int ua = sh.pick[0], ub = sh.pick[1];
    while (ua < 128) {
      const bool hasb = ub < 128;
      if (Compressed)
        stage_grid_units(sh, a.tab, cl, ua, ub, hasb ? 2 : 1, ax, ay, az, tid);
      else
        stage_units(sh, a.tab.unit_qn, cl, ua, ub, hasb ? 2 : 1, ax, ay, az,
                    tid);
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

  if (Windowed) {
    // Carries out: best t, unnormalised summed winner normal, counters.
    a.t_out[ray] = bt;
    a.n_out[(static_cast<size_t>(row) * 3 + 0) * kTile + tid] = bnx;
    a.n_out[(static_cast<size_t>(row) * 3 + 1) * kTile + tid] = bny;
    a.n_out[(static_cast<size_t>(row) * 3 + 2) * kTile + tid] = bnz;
  } else if (Mode == kRaw) {
    // Compact row: best t (object units under a transform) and the
    // unnormalised summed winner normal.
    float* ro = a.raw_out + static_cast<size_t>(row) * 4 * kTile + tid;
    ro[0 * kTile] = bt;
    ro[1 * kTile] = bnx;
    ro[2 * kTile] = bny;
    ro[3 * kTile] = bnz;
  } else {
    // Epilogue: normalise the selected normal, shade against -d.
    const float nn = jmax(sqrtf(bnx * bnx + bny * bny + bnz * bnz), 1e-20f);
    float rgb[3];
    shade_rows(bnx / nn, bny / nn, bnz / nn, -dx, -dy, -dz, bt < kBig, P,
               rgb);
    out[0] = rgb[0];
    out[1] = rgb[1];
    out[2] = rgb[2];
  }
  if (tid == 0) {
    a.visits[row] = nv;
    a.eligible[row] = ne;
  }
}

template <int Mode>
int launch(const Args& a, int n_rows, const float* host_params,
           int n_params, void* stream) {
  if (n_params != kNumParams || a.nsub < 1 || a.nsub > kMaxSub ||
      a.nrows < 1 || a.nsub % a.nrows != 0 || a.kc < 1 || n_rows < 1 ||
      (a.tab.unit_qn == nullptr) == (a.tab.grid == nullptr) ||
      (a.tab.grid != nullptr && a.tab.grows < (a.tab.corners ? 3 : 6)) ||
      (Mode == kWindowed && a.raymat == nullptr) ||
      // Raw rays: a ray matrix, or the raygen with the object transform.
      (a.xform != 0) != (Mode == kRaw && a.raymat == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  std::memcpy(&p, host_params, sizeof(Params));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.tab.grid != nullptr)
    tile_trace_kernel<true, Mode><<<n_rows, kTile, 0, st>>>(a, p);
  else
    tile_trace_kernel<false, Mode><<<n_rows, kTile, 0, st>>>(a, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Fused trace + shade over n_rows tile rows on `stream` (K1a, K1c).
// raymat null = in-kernel raygen; exactly one of unit_qn (precomputed) and
// grid (compressed records, grows rows each; corners null = per-unit index
// rows 3-5) is set. host_params points to kNumParams floats in host memory
// (Params). Returns the CUDA error code of the launch (0 = launched).
extern "C" int rtmm_tile_trace_fused(
    const int* ccand, const int* ccount, const float* centry,
    const float* frus, const float* raymat, const float* meta,
    const float* unit_qn, const float* grid, const int* corners, int grows,
    float* image, int* visits, int* eligible, int n_rows, int kc, int pack,
    int tiles_per_frame, int tx, int pw, int ph, int nsub, int nrows,
    const float* host_params, int n_params, void* stream) {
  Args a = {};
  a.ccand = ccand;
  a.ccount = ccount;
  a.centry = centry;
  a.frus = frus;
  a.raymat = raymat;
  a.meta = meta;
  a.tab = Tables{unit_qn, grid, corners, grows};
  a.image = image;
  a.visits = visits;
  a.eligible = eligible;
  a.kc = kc;
  a.pack = pack;
  a.tiles_per_frame = tiles_per_frame;
  a.tx = tx;
  a.pw = pw;
  a.ph = ph;
  a.nsub = nsub;
  a.nrows = nrows;
  if (image == nullptr || tiles_per_frame < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch<kFused>(a, n_rows, host_params, n_params, stream);
}

// One cluster window over n_rows tile rows (K1b, with K1c when grid is
// set): carries t_in (N, 1024), n_in (N, 3, 1024), vis_in / elig_in (N,)
// fold into t_out, n_out, vis_out, elig_out. Tables and params as above.
extern "C" int rtmm_tile_trace_windowed(
    const int* ccand, const int* ccount, const float* centry,
    const float* frus, const float* raymat, const float* meta,
    const float* unit_qn, const float* grid, const int* corners, int grows,
    const float* t_in, const float* n_in, const int* vis_in,
    const int* elig_in, float* t_out, float* n_out, int* vis_out,
    int* elig_out, int n_rows, int kc, int pack, int nsub, int nrows,
    const float* host_params, int n_params, void* stream) {
  Args a = {};
  a.ccand = ccand;
  a.ccount = ccount;
  a.centry = centry;
  a.frus = frus;
  a.raymat = raymat;
  a.meta = meta;
  a.tab = Tables{unit_qn, grid, corners, grows};
  a.t_in = t_in;
  a.n_in = n_in;
  a.vis_in = vis_in;
  a.elig_in = elig_in;
  a.t_out = t_out;
  a.n_out = n_out;
  a.visits = vis_out;
  a.eligible = elig_out;
  a.kc = kc;
  a.pack = pack;
  a.nsub = nsub;
  a.nrows = nrows;
  return launch<kWindowed>(a, n_rows, host_params, n_params, stream);
}

// Raw trace over n_rows tile rows (K1d, with K1c when grid is set): every
// row starts fresh and writes raw_out (N, 4, 1024) = [t, nx, ny, nz] and
// its visit / eligible counters. raymat null = world raygen + the row's
// object transform, frus packed [apex_o 3, sub planes 12 nsub, px0, py0,
// ivp 16, object-space exit box 6, R^T 9, 1/scale, apex_w 3]; raymat set =
// rows read from it, frus packed without raygen scalars. Tables and
// params as above.
extern "C" int rtmm_tile_trace_raw(
    const int* ccand, const int* ccount, const float* centry,
    const float* frus, const float* raymat, const float* meta,
    const float* unit_qn, const float* grid, const int* corners, int grows,
    float* raw_out, int* visits, int* eligible, int n_rows, int kc, int pack,
    int nsub, int nrows, const float* host_params, int n_params,
    void* stream) {
  Args a = {};
  a.ccand = ccand;
  a.ccount = ccount;
  a.centry = centry;
  a.frus = frus;
  a.raymat = raymat;
  a.meta = meta;
  a.tab = Tables{unit_qn, grid, corners, grows};
  a.raw_out = raw_out;
  a.visits = visits;
  a.eligible = eligible;
  a.kc = kc;
  a.pack = pack;
  a.nsub = nsub;
  a.nrows = nrows;
  a.xform = raymat == nullptr;
  if (raw_out == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch<kRaw>(a, n_rows, host_params, n_params, stream);
}

extern "C" const char* rtmm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
