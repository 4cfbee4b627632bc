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
// Design. One block per 32x32 ray tile, kThreads = 1,024 / kRpt threads,
// each owning kRpt rays: thread (warp w, lane l) owns the rays of pixel
// rows w * kRpt .. w * kRpt + kRpt - 1 in column l, so global reads and
// writes of a ray row stay coalesced and a thread's rays lie in one
// sub-tile. The block walks the tile's front-to-back cluster list: the
// first 64 threads cull the cluster's 64 units against the tile's
// sub-cones and hold each unit's apex distance and integer key (distance
// bits | lane); per step the block picks the two nearest units that some
// sub-tile can still use (pick-2 with a warp butterfly over the two
// smallest keys), stages them in shared memory as packed leaf records,
// and every thread runs Möller-Trumbore over the 2 x 64 leaves for each
// of its rays, keeping the rays and their closest hits in registers.
// Per-sub worst-hit bounds are block max-reductions (a thread's max over
// its own rays, then warp shuffles and shared atomics on order-preserving
// integer keys: a max is exact in any order). The tile stops when the
// worst bound is below the next cluster's entry distance; empty tiles
// write the background (fused), pass the carries through (windowed) or
// write a miss (raw).
//
// Leaf records. A staged leaf is one record of 24 floats (six float4):
// the det column's rows 0-2, the u, v and w columns' rows 0-5 (w formed
// on the q columns as (det - u) - v) and the per-frame t numerator; its
// normal is a separate float4. A thread reads both with seven 16-byte
// broadcast loads and uses them for all kRpt of its rays: 7 / kRpt shared
// loads per (ray, leaf), where one ray per thread and a row-major table
// took 25. The kRpt tests of a leaf are one branch-free block (the fold
// by selects, 1 / det by a Newton-refined reciprocal that equals the
// correctly rounded division), so their independent chains interleave.
//
// Zero terms. The det column's moment rows (3-5) are zero by
// construction: the table is [-n | -w1 | -w2] over the d rows and
// [0 | e2 | -e1] over the moment rows (pallas_tiled.py:732-735). det sums
// only rows 0-2, left to right, here and in the plain version
// (tile_trace.py, DET_ROWS). Dropping a +-0 * x term changes a sum only
// where the partial sum is exactly +-0 (-0 + +0 is +0; the sign of det
// then decides the sign of 1/det) or where x is inf or NaN; the ray rows
// are finite, and both versions drop the same terms, so they still agree
// bit for bit (tests/test_torch_k1_terms.py holds the three terms against
// the six). The w column keeps all six rows: (det - u) - v is formed on
// the table's own det entries, zeros included.
//
// Compressed staging loads the two records' <= 45 positions into shared
// memory and derives one (unit, leaf) record per thread on 128 threads;
// the corner gather is an indexed load (the TPU's one-hot matmul gathers
// the same value exactly).
//
// What bounds it: instruction issue. Each (ray, leaf) test is ~49 float32
// operations over the table's non-zero terms (a 3-term and three 6-term
// dot products, one reciprocal, four products and the compares), ~80
// instructions with the selects and no FMA (-fmad=false); the unit
// tables or records are read once per visit from L2 into shared memory,
// so device-memory traffic is small (chip_smoke.py prints both bounds).
// The raw mode writes 16 KB per row, its largest stream, and stays bound
// by arithmetic. Most launches end on a few long tiles (config 9: ~256
// non-empty tiles of up to 252 visits), so a tile's own warps must keep
// the SM busy: a second resident tile helped only launches of many short
// tiles, and cost registers the long ones need (see kRpt). It uses no
// tensor cores.
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
constexpr int kTile = kTileW * kTileH;     // rays per tile (block)
constexpr int kLpu = 64;                   // leaves per unit
constexpr int kUpc = 64;                   // units per cluster
constexpr int kMetaLanes = 128;            // cluster_unit_meta row width
constexpr int kQnCols = 4 * kLpu + 128;    // unit_qn row: det|u|v|t|normals
constexpr int kMaxSub = 8;
constexpr int kGridLanes = 128;            // compressed record row width
constexpr float kBig = 1e30f;              // miss sentinel
constexpr float kUvEps = 1e-3f;            // MT_UV_EPS, intersection.hlsl:413
constexpr int kIMax = 0x7FFFFFFF;          // removed / ineligible key
// Rays per thread and tiles per SM, chosen by tools/k1_ab.py on an H100
// (PERF.md section 6): 2 rays per thread, one 512-thread tile per SM at
// up to 128 registers (96-127 used, no spills). It beat 1 ray per thread
// (1,024 threads, 64 registers) on every launch timed, by 1-12%. Two
// tiles per SM lost where a launch ends on long tiles: at 512 threads
// they leave 64 registers a thread (spills; 1.2-1.6x slower on configs
// 3, 7 and 9), and at 4 rays per thread (256 threads) a tile's 8 warps
// walk a long tile alone at the end of the launch (1.1-1.6x slower; 5%
// faster only on config 8's many short rows).
constexpr int kRpt = 2;
constexpr int kMinBlocks = 1;
constexpr int kThreads = kTile / kRpt;
constexpr int kRec4 = 6;                   // float4s per packed leaf record

static_assert(kTile % (32 * kRpt) == 0, "whole warps");
static_assert(kRpt <= kTileH / kMaxSub, "a thread's rays share a sub-tile");
static_assert(kThreads >= 3 * kLpu, "corner lanes: one thread each");

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
  // Staged units, one packed record per leaf: [d0 d1 d2 u0 | u1 u2 u3 u4 |
  // u5 v0 v1 v2 | v3 v4 v5 w0 | w1 w2 w3 w4 | w5 t_num 0 0].
  float4 rec[2][kLpu][kRec4];
  float4 nrm[2][kLpu];       // staged units: leaf normals [x y z 0]
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

// A thread's rays: direction, moment a x d about the apex, apex offset s,
// the p-form window and the scene-exit reach.
struct Rays {
  float dx[kRpt], dy[kRpt], dz[kRpt], mx[kRpt], my[kRpt], mz[kRpt];
  float s[kRpt], pmin[kRpt], pmax[kRpt], exit_t[kRpt];
};

// A thread's running best: apex-relative t and the summed winner normal.
struct Best {
  float t[kRpt], nx[kRpt], ny[kRpt], nz[kRpt];
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
__device__ float worst_subs(Shared& sh, const Best& b, const Rays& r,
                            int my_sub, int nsub, int sub_lanes, int tid) {
  if (tid < kMaxSub) sh.ws_key[tid] = INT_MIN;
  __syncthreads();
  int key = INT_MIN;
#pragma unroll
  for (int i = 0; i < kRpt; ++i) {
    float v = b.t[i] < kBig ? b.t[i] + r.s[i] : r.exit_t[i];
    if (nsub > 1) v = v > 0.0f ? v : 0.0f;
    key = max(key, ord_key(v));
  }
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

// Write one leaf's packed record and normal: the det column's rows 0-2,
// the u and v columns, the w column formed on the q columns ((det - u) -
// v, all six rows, before any dot product) and t_num.
__device__ __forceinline__ void put_record(Shared& sh, int slot, int k,
                                           const float (&qd)[6],
                                           const float (&qu)[6],
                                           const float (&qv)[6], float tn,
                                           float nx, float ny, float nz) {
  float w[6];
#pragma unroll
  for (int r = 0; r < 6; ++r) w[r] = (qd[r] - qu[r]) - qv[r];
  float4* rec = sh.rec[slot][k];
  rec[0] = make_float4(qd[0], qd[1], qd[2], qu[0]);
  rec[1] = make_float4(qu[1], qu[2], qu[3], qu[4]);
  rec[2] = make_float4(qu[5], qv[0], qv[1], qv[2]);
  rec[3] = make_float4(qv[3], qv[4], qv[5], w[0]);
  rec[4] = make_float4(w[1], w[2], w[3], w[4]);
  rec[5] = make_float4(w[5], tn, 0.0f, 0.0f);
  sh.nrm[slot][k] = make_float4(nx, ny, nz, 0.0f);
}

// Stage the picked units' records from unit_qn, one thread per (unit,
// leaf): the det|u|v columns, the normals and t_num = -((a-c).(-n)) -
// e2.w2 (unit_tables).
__device__ void stage_units(Shared& sh, const float* __restrict__ unit_qn,
                            int cl, int ua, int ub, int nslot, float ax,
                            float ay, float az, int tid) {
  if (tid < nslot * kLpu) {
    const int slot = tid / kLpu;
    const int k = tid % kLpu;
    const int u = slot ? ub : ua;
    const float* q = unit_qn
        + static_cast<size_t>(cl * kUpc + u) * 8 * kQnCols + k;
    float qd[6], qu[6], qv[6];
#pragma unroll
    for (int r = 0; r < 6; ++r) {
      qd[r] = q[r * kQnCols];
      qu[r] = q[r * kQnCols + kLpu];
      qv[r] = q[r * kQnCols + 2 * kLpu];
    }
    const float cx = sh.ctr[0][u], cy = sh.ctr[1][u], cz = sh.ctr[2][u];
    const float s_neg = (ax - cx) * qd[0] + (ay - cy) * qd[1]
                      + (az - cz) * qd[2];
    const float* qn = q + 4 * kLpu;
    put_record(sh, slot, k, qd, qu, qv, -s_neg - qn[3 * kQnCols],
               qn[0 * kQnCols], qn[1 * kQnCols], qn[2 * kQnCols]);
  }
  __syncthreads();
}

// Derive the picked units' records from their compressed records
// (_derive_unit): positions into shared memory, then one thread per
// (unit, leaf) forms e1, e2, n, w1, w2 recentered on the unit AABB center,
// e2.w2, t_num = (a-c).n - e2.w2 and the normalised normal, in
// _derive_unit's order, into the packed records. Shared corner lanes were
// loaded into sh.cidx once per block; indexed records carry their own.
__device__ void stage_grid_units(Shared& sh, const Tables& tab, int cl,
                                 int ua, int ub, int nslot, float ax,
                                 float ay, float az, int tid) {
  constexpr int kPos = 3 * kGridLanes;
  for (int i = tid; i < nslot * kPos; i += kThreads) {
    const int slot = i / kPos;
    const int r = (i % kPos) / kGridLanes;
    const int l = i % kGridLanes;
    const int u = slot ? ub : ua;
    sh.pos[slot][r][l] = tab.grid[
        (static_cast<size_t>(cl * kUpc + u) * tab.grows + r) * kGridLanes + l];
  }
  if (tab.corners == nullptr) {
    for (int i = tid; i < nslot * 3 * kLpu; i += kThreads) {
      const int slot = i / (3 * kLpu);
      const int j = (i % (3 * kLpu)) / kLpu;
      const int k = i % kLpu;
      const int u = slot ? ub : ua;
      const float f = tab.grid[
          (static_cast<size_t>(cl * kUpc + u) * tab.grows + 3 + j)
          * kGridLanes + k];
      // Lane indices are small integers in float32 (truncating cast, as
      // astype(int32)); the clamp only guards memory against a bad record.
      sh.cidx[slot][j][k] = min(max(static_cast<int>(f), 0), kGridLanes - 1);
    }
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
    const float tn = (ax - cx) * nx + (ay - cy) * ny + (az - cz) * nz - e2w2;
    // q rows [-n | -w1 | -w2] over the d rows, [0 | e2 | -e1] over the
    // moment rows.
    const float qd[6] = {-nx, -ny, -nz, 0.0f, 0.0f, 0.0f};
    const float qu[6] = {-w1x, -w1y, -w1z, e2x, e2y, e2z};
    const float qv[6] = {-w2x, -w2y, -w2z, -e1x, -e1y, -e1z};
    const float nn = jmax(sqrtf(nx * nx + ny * ny + nz * nz), 1e-20f);
    put_record(sh, slot, k, qd, qu, qv, tn, nx / nn, ny / nn, nz / nn);
  }
  __syncthreads();
}

// 1 / x rounded to nearest, as 1.0f / x rounds it, without a branch: the
// hardware's approximate reciprocal refined by one Newton step whose
// residual and update are each one FMA (y + y (1 - x y)). Exact where
// rcp_in_range(x) holds (normal x, |x| < 2^126: neither x nor 1 / x is
// subnormal), as rtmm_tile_trace_rcp_check shows on all 2^32 inputs;
// elsewhere (0, subnormals, inf, NaN, |x| >= 2^126) the caller divides.
__device__ __forceinline__ float rcp_newton(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return __fmaf_rn(y, __fmaf_rn(-x, y, 1.0f), y);
}
__device__ __forceinline__ bool rcp_in_range(float x) {
  return ((__float_as_uint(x) >> 23) & 0xFFu) - 1u < 252u;
}

// One unit visit for this thread's rays (process_unit + ep_fold): each
// leaf record and normal is loaded once and tested against all kRpt rays.
// The tests of the kRpt rays are one branch-free block (the fold by
// selects, 1 / det by rcp_newton), so their independent chains
// interleave; only a det outside rcp_in_range (a zero-area leaf's 0)
// takes the branch to a true division.
__device__ __forceinline__ void process_unit(const Shared& sh, int slot,
                                             int u, const Rays& r,
                                             Best& b) {
  const float cx = sh.ctr[0][u], cy = sh.ctr[1][u], cz = sh.ctr[2][u];
  // Recentered moment m' = (a - c) x d = m - c x d.
  float mpx[kRpt], mpy[kRpt], mpz[kRpt];
  float pb[kRpt], nsx[kRpt], nsy[kRpt], nsz[kRpt];
#pragma unroll
  for (int i = 0; i < kRpt; ++i) {
    mpx[i] = r.mx[i] - (cy * r.dz[i] - cz * r.dy[i]);
    mpy[i] = r.my[i] - (cz * r.dx[i] - cx * r.dz[i]);
    mpz[i] = r.mz[i] - (cx * r.dy[i] - cy * r.dx[i]);
    pb[i] = kBig;
    nsx[i] = nsy[i] = nsz[i] = 0.0f;
  }
  const float4 (*rec)[kRec4] = sh.rec[slot];
  const float4* nrm = sh.nrm[slot];
  for (int k = 0; k < kLpu; ++k) {
    const float4 a0 = rec[k][0], a1 = rec[k][1], a2 = rec[k][2];
    const float4 a3 = rec[k][3], a4 = rec[k][4], a5 = rec[k][5];
    const float4 n = nrm[k];
    float det[kRpt], iv[kRpt];
    bool divide = false;
#pragma unroll
    for (int i = 0; i < kRpt; ++i) {
      det[i] = a0.x * r.dx[i] + a0.y * r.dy[i] + a0.z * r.dz[i];
      iv[i] = rcp_newton(det[i]);
      divide = divide || !rcp_in_range(det[i]);
    }
    // No det guard: det == 0 gives inf/NaN quotients that fail the window.
    if (divide) {
#pragma unroll
      for (int i = 0; i < kRpt; ++i)
        if (!rcp_in_range(det[i])) iv[i] = 1.0f / det[i];
    }
#pragma unroll
    for (int i = 0; i < kRpt; ++i) {
      const float dx = r.dx[i], dy = r.dy[i], dz = r.dz[i];
      const float un = a0.w * dx + a1.x * dy + a1.y * dz
                     + a1.z * mpx[i] + a1.w * mpy[i] + a2.x * mpz[i];
      const float vn = a2.y * dx + a2.z * dy + a2.w * dz
                     + a3.x * mpx[i] + a3.y * mpy[i] + a3.z * mpz[i];
      const float wn = a3.w * dx + a4.x * dy + a4.y * dz
                     + a4.z * mpx[i] + a4.w * mpy[i] + a5.x * mpz[i];
      const float uu = un * iv[i], vv = vn * iv[i], ww = wn * iv[i];
      const float pp = a5.y * iv[i];
      // w-form acceptance, min(u, v, w) >= -eps (a NaN fails every compare).
      const bool ok = uu >= -kUvEps && vv >= -kUvEps && ww >= -kUvEps
                   && pp >= r.pmin[i];
      const float p = ok ? pp : kBig;
      // Leaf minimum with the winner normal summed over exact ties.
      const bool take = k == 0 || p < pb[i];
      const bool tie = p == pb[i];
      nsx[i] = take ? n.x : (tie ? nsx[i] + n.x : nsx[i]);
      nsy[i] = take ? n.y : (tie ? nsy[i] + n.y : nsy[i]);
      nsz[i] = take ? n.z : (tie ? nsz[i] + n.z : nsz[i]);
      pb[i] = take ? p : pb[i];
    }
  }
#pragma unroll
  for (int i = 0; i < kRpt; ++i) {
    // Upper t-window on the leaf minimum; the 1e30 sentinel survives - s.
    const float tb = pb[i] <= r.pmax[i] ? pb[i] - r.s[i] : kBig;
    if (tb < b.t[i]) {
      b.t[i] = tb;
      b.nx[i] = nsx[i];
      b.ny[i] = nsy[i];
      b.nz[i] = nsz[i];
    }
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

// Ray i of this thread, pixel (pr, pc) of the tile: from the in-kernel
// raygen (_raygen_rows: explicit unproject, true divisions; with the
// row's object transform in the raw mode's xform) or from the ray matrix.
template <int Mode>
__device__ __forceinline__ void make_ray(const Args& a, const Params& P,
                                         const float* __restrict__ fr,
                                         int row, int pr, int pc, int i,
                                         Rays& r) {
  const float ax = fr[0], ay = fr[1], az = fr[2];
  float dx, dy, dz, s;
  const bool raygen = a.raymat == nullptr;
  if (raygen) {
    const int rg = 3 + a.nsub * 12;
    const float* m = fr + rg + 2;
    const float u = (fr[rg] + static_cast<float>(pc) + 0.5f) / P.width;
    const float v = (fr[rg + 1] + static_cast<float>(pr) + 0.5f) / P.height;
    const float ndc_x = u * 2.0f - 1.0f;
    const float ndc_y = -(v * 2.0f - 1.0f);
    float pn[4], pf[4];
    for (int j = 0; j < 4; ++j) {
      pn[j] = m[4 * j] * ndc_x + m[4 * j + 1] * ndc_y + m[4 * j + 3];
      pf[j] = m[4 * j] * ndc_x + m[4 * j + 1] * ndc_y
            + (m[4 * j + 2] + m[4 * j + 3]);
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
    r.mx[i] = ay * dz - az * dy;
    r.my[i] = az * dx - ax * dz;
    r.mz[i] = ax * dy - ay * dx;
  } else {
    // Ray-matrix input: rows [d, a x d, s, 1] of this tile's rays.
    const float* rm = a.raymat + static_cast<size_t>(row) * 8 * kTile
                    + pr * kTileW + pc;
    dx = rm[0 * kTile];
    dy = rm[1 * kTile];
    dz = rm[2 * kTile];
    r.mx[i] = rm[3 * kTile];
    r.my[i] = rm[4 * kTile];
    r.mz[i] = rm[5 * kTile];
    s = rm[6 * kTile];
  }
  r.dx[i] = dx;
  r.dy[i] = dy;
  r.dz[i] = dz;
  r.s[i] = s;
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
  r.exit_t[i] = exit_t;
  r.pmin[i] = P.t_min + s;
  r.pmax[i] = P.t_max + s;
}

template <bool Compressed, int Mode>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
tile_trace_kernel(const Args a, const Params P) {
  constexpr bool Windowed = Mode == kWindowed;
  __shared__ Shared sh;
  const int row = blockIdx.x;                 // tile row, frame-major
  const int tid = threadIdx.x;
  // Ray i of this thread: pixel row pr0 + i, column pc of the tile.
  const int pr0 = (tid / 32) * kRpt, pc = tid % 32;
  const float* fr = a.frus + static_cast<size_t>(row) * a.pack;
  const size_t ray0 = static_cast<size_t>(row) * kTile + pr0 * kTileW + pc;
  float* out = nullptr;                       // fused: pixel of ray 0
  if (Mode == kFused) {
    const int frame = row / a.tiles_per_frame, t = row % a.tiles_per_frame;
    const int py = (t / a.tx) * kTileH + pr0, px = (t % a.tx) * kTileW + pc;
    out = a.image + ((static_cast<size_t>(frame) * a.ph + py) * a.pw + px) * 3;
  }
  const size_t out_step = static_cast<size_t>(a.pw) * 3;  // one pixel row
  const int ccnt = min(a.ccount[row], a.kc);
  if (ccnt <= 0) {
#pragma unroll
    for (int i = 0; i < kRpt; ++i) {
      const size_t ray = ray0 + i * kTileW;
      if (Windowed) {                         // empty tile: carries through
        a.t_out[ray] = a.t_in[ray];
        for (int c = 0; c < 3; ++c) {
          const size_t j = ray + (static_cast<size_t>(row) * 2 + c) * kTile;
          a.n_out[j] = a.n_in[j];
        }
      } else if (Mode == kRaw) {              // empty row: a miss
        float* ro = a.raw_out + ray + static_cast<size_t>(row) * 3 * kTile;
        ro[0 * kTile] = kBig;
        ro[1 * kTile] = 0.0f;
        ro[2 * kTile] = 0.0f;
        ro[3 * kTile] = 0.0f;
      } else {                                // empty tile: background
        float* o = out + i * out_step;
        o[0] = P.bg[0];
        o[1] = P.bg[1];
        o[2] = P.bg[2];
      }
    }
    if (tid == 0) {
      a.visits[row] = Windowed ? a.vis_in[row] : 0;
      a.eligible[row] = Windowed ? a.elig_in[row] : 0;
    }
    return;
  }

  // The pack head is the apex of the walk: the camera, or with an object
  // transform the camera in the row's object space.
  const float ax = fr[0], ay = fr[1], az = fr[2];
  Rays r;
#pragma unroll
  for (int i = 0; i < kRpt; ++i)
    make_ray<Mode>(a, P, fr, row, pr0 + i, pc, i, r);

  const int nsub = a.nsub;
  const int ncols = nsub / a.nrows;
  const int sub_lanes = kTileW / ncols;
  const int my_sub = (pr0 / (kTileH / a.nrows)) * ncols + pc / sub_lanes;

  // The running best: fresh (fused, raw), or carried from earlier windows.
  Best b;
#pragma unroll
  for (int i = 0; i < kRpt; ++i) {
    b.t[i] = kBig;
    b.nx[i] = b.ny[i] = b.nz[i] = 0.0f;
  }
  int nv = 0, ne = 0;
  if (Windowed) {
#pragma unroll
    for (int i = 0; i < kRpt; ++i) {
      const size_t ray = ray0 + i * kTileW;
      const size_t n0 = ray + static_cast<size_t>(row) * 2 * kTile;
      b.t[i] = a.t_in[ray];
      b.nx[i] = a.n_in[n0 + 0 * kTile];
      b.ny[i] = a.n_in[n0 + 1 * kTile];
      b.nz[i] = a.n_in[n0 + 2 * kTile];
    }
    nv = a.vis_in[row];
    ne = a.elig_in[row];
  }
  if (Compressed && a.tab.corners != nullptr && tid < 3 * kLpu) {
    const int c = a.tab.corners[tid];         // shared corner lanes
    sh.cidx[0][tid / kLpu][tid % kLpu] = c;
    sh.cidx[1][tid / kLpu][tid % kLpu] = c;
  }
  float wmax = worst_subs(sh, b, r, my_sub, nsub, sub_lanes, tid);
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
      process_unit(sh, 0, ua, r, b);
      // (The TPU kernel recomputes unit A in a slot with no B: an
      // idempotent fold, skipped here.)
      if (hasb) process_unit(sh, 1, ub, r, b);
      nv += 1 + hasb;
      ne += 1 + hasb;
      wmax = worst_subs(sh, b, r, my_sub, nsub, sub_lanes, tid);
      pick2(sh, nsub, tid);
      ua = sh.pick[0];
      ub = sh.pick[1];
    }
  }

#pragma unroll
  for (int i = 0; i < kRpt; ++i) {
    const size_t ray = ray0 + i * kTileW;
    if (Windowed) {
      // Carries out: best t, unnormalised summed winner normal.
      const size_t n0 = ray + static_cast<size_t>(row) * 2 * kTile;
      a.t_out[ray] = b.t[i];
      a.n_out[n0 + 0 * kTile] = b.nx[i];
      a.n_out[n0 + 1 * kTile] = b.ny[i];
      a.n_out[n0 + 2 * kTile] = b.nz[i];
    } else if (Mode == kRaw) {
      // Compact row: best t (object units under a transform) and the
      // unnormalised summed winner normal.
      float* ro = a.raw_out + ray + static_cast<size_t>(row) * 3 * kTile;
      ro[0 * kTile] = b.t[i];
      ro[1 * kTile] = b.nx[i];
      ro[2 * kTile] = b.ny[i];
      ro[3 * kTile] = b.nz[i];
    } else {
      // Epilogue: normalise the selected normal, shade against -d.
      const float bnx = b.nx[i], bny = b.ny[i], bnz = b.nz[i];
      const float nn = jmax(sqrtf(bnx * bnx + bny * bny + bnz * bnz), 1e-20f);
      float rgb[3];
      shade_rows(bnx / nn, bny / nn, bnz / nn, -r.dx[i], -r.dy[i], -r.dz[i],
                 b.t[i] < kBig, P, rgb);
      float* o = out + i * out_step;
      o[0] = rgb[0];
      o[1] = rgb[1];
      o[2] = rgb[2];
    }
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
    tile_trace_kernel<true, Mode><<<n_rows, kThreads, 0, st>>>(a, p);
  else
    tile_trace_kernel<false, Mode><<<n_rows, kThreads, 0, st>>>(a, p);
  return static_cast<int>(cudaGetLastError());
}

// rcp_newton against 1.0f / x on every float32 bit pattern where
// rcp_in_range holds: out[0] += mismatches, out[1] += inputs in range.
__global__ void rcp_check_kernel(unsigned long long* out) {
  unsigned long long bad = 0, n = 0;
  const unsigned long long step =
      static_cast<unsigned long long>(gridDim.x) * blockDim.x;
  for (unsigned long long i = blockIdx.x * blockDim.x + threadIdx.x;
       i < (1ull << 32); i += step) {
    const float x = __uint_as_float(static_cast<unsigned>(i));
    if (!rcp_in_range(x)) continue;
    ++n;
    bad += __float_as_uint(rcp_newton(x)) != __float_as_uint(1.0f / x);
  }
  atomicAdd(out, bad);
  atomicAdd(out + 1, n);
}

// Registers, local (spill) bytes, static shared bytes, resident blocks per
// SM, threads per block and rays per thread of one instantiation.
template <typename Kernel>
cudaError_t occupancy(Kernel kernel, int* out) {
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      kThreads, 0);
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.localSizeBytes);
  out[2] = static_cast<int>(fa.sharedSizeBytes);
  out[3] = blocks;
  out[4] = kThreads;
  out[5] = kRpt;
  return err;
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

// Occupancy of the six instantiations, in the order fused, windowed, raw,
// each precomputed then compressed: out[6 * j + 0..5] = registers, local
// bytes, static shared bytes, resident blocks per SM, threads per block,
// rays per thread. Returns the first CUDA error (0 = all read).
extern "C" int rtmm_tile_trace_occupancy(int* out) {
  cudaError_t errs[6] = {
      occupancy(tile_trace_kernel<false, kFused>, out + 0),
      occupancy(tile_trace_kernel<true, kFused>, out + 6),
      occupancy(tile_trace_kernel<false, kWindowed>, out + 12),
      occupancy(tile_trace_kernel<true, kWindowed>, out + 18),
      occupancy(tile_trace_kernel<false, kRaw>, out + 24),
      occupancy(tile_trace_kernel<true, kRaw>, out + 30)};
  for (cudaError_t e : errs)
    if (e != cudaSuccess) return static_cast<int>(e);
  return 0;
}

// The exhaustive check of the tests' reciprocal (rcp_check_kernel) into
// out, two zeroed unsigned 64-bit counters on the device.
extern "C" int rtmm_tile_trace_rcp_check(unsigned long long* out,
                                         void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  rcp_check_kernel<<<132 * 8, 256, 0, st>>>(out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rtmm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
