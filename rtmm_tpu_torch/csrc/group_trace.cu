// Grouped trace for NVIDIA Hopper (sm_90a): the path tracer's secondary
// rays (K2).
//
// Replaces the TPU kernel rtmm_tpu/ops/pallas_grouped.py::_launch (body
// _trace_group_nonempty :164-483, the compressed derive _derive_q16_unit
// :50-113; pallas_call at pallas_grouped.py:686), as the template modes
// <Compressed> of one kernel: unit tables read from unit_q16 /
// unit_nrm_pad, or derived per visited unit from its grid record (shared
// corner lanes, or each indexed record's own). The plain PyTorch version
// is rtmm_tpu_torch/ops/group_trace.py::trace_group_plain; it does the
// same float32 operations in the same order, and this file is built with
// -fmad=false and without fast math, so the two agree bit for bit except
// where several leaves hit at exactly the same t (the winner normals are
// summed in another order).
//
// Design. One block per group of 1,024 sorted rays; warps 4j..4j+3 own
// sub-group j (128 rays with their own origin and reach boxes, held in
// shared memory with the scene-exit tail), and each thread owns one ray's
// running best in registers. The block walks the group's front-to-back
// cluster list. Per cluster, 64 threads cull the cluster's units against
// the 8 reach boxes (one bit per sub) and hold each unit's distance from
// every sub's origin box. Picks are a warp arg-min of the nearest eligible
// distance (ties to the lowest lane) over the two warps of unit lanes,
// combined by thread 0. The pick order is the TPU kernel's two-deep
// pipeline order: u0 and u1 are picked with the cluster's entry bounds,
// and each step picks the next unit with the current bounds before it
// processes the current one. A processed unit's gate bits (inside[j] &&
// dist[j] <= ws[j], with the current bounds) say which sub-groups it
// tests. Per-sub worst bounds (a hit's t, or a miss's scene-exit t,
// floored at 0; dead lanes carry t = 0) are block max-reductions on
// order-preserving int keys, refreshed after every unit. The walk stops
// when the largest sub bound is below the next cluster's entry distance.
//
// The test step of a visit:
// - Listing. The lanes of the gated sub-groups whose running best exceeds
//   t_min are listed in shared memory in lane order (warp ballots, a
//   prefix over the 32 warp counts). The others cannot change: an
//   accepted leaf has t >= t_min and the take is strict, so skipping them
//   changes no output, bound or visit. A visit with no listed lane stages
//   nothing.
// - Staging. Only the table's non-zero terms: over the ray rows [d, o x d,
//   o, 1], det uses rows 0-2, u, v and the w column (det - u) - v rows 0-5,
//   t rows 6-9: 25 row-blocks of 64 leaves (6.4 KB), copied from unit_q16
//   or derived from the record, one thread per leaf.
// - Work split. Each listed lane gets S leaf slices, S the largest power
//   of two <= 32 with S x listed <= 1,024, so one pass covers the visit
//   and a visit with few live rays spreads their leaves over every warp.
//   Slice s holds the leaf pairs (2s, 2s + 1), (2s + 2S, 2s + 2S + 1), ...
//   (each row read as one float2; the S threads of a lane read
//   neighbouring banks) and folds them in leaf order with the kernel's
//   rule (first leaf or t < tb replaces, t == tb adds the normal); the S
//   consecutive threads combine their partials by warp shuffles, and the
//   lane's owner applies the t_max window and the strict-< take. A listed
//   lane's ray rows are read from rv (L1-resident): staging them in
//   shared memory measured the same on config 5, and needs dynamic shared
//   memory. Pairs cut the shared loads per test from 28 to 14 and took
//   3-7% off every bounce against one leaf at a time.
// The minimum over leaves is exact in any grouping, so t and every count
// equal the plain version's; only the normals summed over exact-t ties
// are added in another order.
//
// What bounds it now (config 5 on an H100, tools/k2_ab.py): the busiest
// group sets the launch time, and one block walks it alone on one SM. At
// bounces 1 and 2 that block visits all 320 units of the scene with ~230
// and ~130 listed lanes per visit, ~9.8 and ~7.0 us a visit; a visit with
// 3 listed lanes (bounce 3) still costs ~2.9 us: its ~9 barriers, the
// pick and the unit staging's round trip to L2. By its instruction count
// a busy visit runs at about 3 of the SM's 4 warp instructions per cycle
// (a test is ~90 instructions: 55 float32 operations, 14 shared loads,
// the correctly rounded division, the compares and the fold). What is left
// is structural: one SM per group (54 of 132 busy at bounce 1, one at
// bounces 2-3) and the staging latency on each visit's critical path.
//
// The TPU mechanics are left behind: the bf16 hi/lo splits of the ray
// rows, tables and normals, the one-hot matmul gathers, the DMA ring and
// semaphores, groups_per_block, and the RTMM_SUBGATE / RTMM_MT_WFORM /
// RTMM_MT_NODET knobs (their defaults are the semantics here).

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kGroup = 1024;            // rays per group = threads per block
constexpr int kSub = 128;               // rays per sub-group
constexpr int kNs = kGroup / kSub;      // sub-groups per group
constexpr int kLpu = 64;                // leaves per unit
constexpr int kUpc = 64;                // units per cluster
constexpr int kMetaLanes = 128;         // cluster_unit_meta row width
constexpr int kQ16Cols = 4 * kLpu;      // unit_q16 row: det|u|v|t
constexpr int kRows = 10;               // ray rows [d, o x d, o, 1]
constexpr int kWarps = kGroup / 32;
constexpr int kMaxSlices = 32;          // leaf slices per listed lane
// Staged row-blocks: the table's non-zero terms over the ray rows.
constexpr int kQDet = 0;                // det: rows 0-2
constexpr int kQU = 3;                  // u: rows 0-5
constexpr int kQV = 9;                  // v: rows 0-5
constexpr int kQT = 15;                 // t: rows 6-9
constexpr int kQW = 19;                 // w = (det - u) - v: rows 0-5
constexpr int kQRows = 25;
constexpr int kBox = kNs * 16 + 16;     // per-sub boxes, then the exit box
constexpr int kGridLanes = 128;         // compressed record row width
constexpr float kBig = 1e30f;           // miss sentinel
constexpr float kUvEps = 1e-3f;         // MT_UV_EPS, intersection.hlsl:413
constexpr float kTiny = 1e-12f;

struct Shared {
  float q[kQRows][kLpu];        // staged unit: non-zero table rows
  float nrm[3][kLpu];           // staged unit: leaf normals
  float box[kBox];
  float dist[kNs][kUpc];        // sub origin box -> unit AABB distance
  unsigned inside[kUpc];        // bit j: unit overlaps sub j's reach box
  int removed[kUpc];            // picked already
  int ws_key[kNs];              // per-sub worst bound, order-preserving int
  float pk_key[2];              // per-warp arg-min of the pick
  int pk_lane[2];
  int pick;
  float pos[3][kGridLanes];     // compressed: the staged record's positions
  int cidx[3][kLpu];            // compressed: leaf-corner lanes
  int wcount[kWarps];           // listed lanes per warp
  int list[kGroup];             // listed lanes, in lane order
  float4 part[kGroup];          // per listed lane: leaf minimum, normal
};

// Kernel arguments.
struct Args {
  const float* rv;       // (g, 16, kGroup) ray rows
  const float* box;      // (g, kBox)
  const int* ccand;      // (g, kc) front-to-back cluster lists
  const int* ccount;     // (g,)
  const float* centry;   // (g, kc) cluster entry distances
  const float* t_in;     // (g, kGroup) running best t
  const float* n_in;     // (g, 3, kGroup) summed winner normals
  const float* meta;     // (C, 8, kMetaLanes) per-cluster unit AABBs
  const float* q16;      // (U, 16, kQ16Cols), precomputed scenes
  const float* nrm;      // (U, 8, npad), precomputed scenes
  int npad;
  const float* grid;     // (U, grows, kGridLanes), compressed scenes
  int grows;
  const int* corners;    // (3, kLpu) shared lanes; null: record rows 3-5
  float* t_out;
  float* n_out;
  int* visits;           // (g,) units whose gate let MT run
  int* gated;            // (g,) sub-groups those units ran on
  int* tests;            // (g,) listed lanes summed over those units
  int kc;
  float t_min, t_max;
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

// Per-sub worst-case reach (worst_subs): a ray contributes its hit's t, or
// — while it still misses — its scene-exit t; each sub's max is floored at
// 0 (the TPU kernel takes the max over the whole row with the other subs'
// lanes at 0). Every thread gets all kNs bounds in ws.
__device__ void worst_subs(Shared& sh, float bt, float exit_t, int sub,
                           int tid, float ws[kNs]) {
  __syncthreads();                        // the last reads of ws_key are done
  if (tid < kNs) sh.ws_key[tid] = ord_key(0.0f);
  __syncthreads();
  int key = ord_key(bt < kBig ? bt : exit_t);
  for (int o = 16; o >= 1; o >>= 1)
    key = max(key, __shfl_xor_sync(0xffffffffu, key, o));
  if ((tid & 31) == 0) atomicMax(&sh.ws_key[sub], key);
  __syncthreads();
  for (int j = 0; j < kNs; ++j) ws[j] = ord_val(sh.ws_key[j]);
}

// Cull one cluster's units against the sub-groups' reach boxes and their
// distances from the sub origin boxes (cluster_body).
__device__ void load_cluster(Shared& sh, const float* __restrict__ meta,
                             int cl, int tid) {
  if (tid < kUpc) {
    const float* mt = meta + static_cast<size_t>(cl) * 8 * kMetaLanes + tid;
    const float mn[3] = {mt[0 * kMetaLanes], mt[1 * kMetaLanes],
                         mt[2 * kMetaLanes]};
    const float mx[3] = {mt[3 * kMetaLanes], mt[4 * kMetaLanes],
                         mt[5 * kMetaLanes]};
    const bool valid = mt[6 * kMetaLanes] > 0.0f;
    unsigned in = 0;
    for (int j = 0; j < kNs; ++j) {
      const float* b = sh.box + 16 * j;   // omin 0-2, omax 3-5, reach 6-11
      bool inside = valid;
      float dd[3];
      for (int a = 0; a < 3; ++a) {
        inside = inside && mn[a] <= b[9 + a] && mx[a] >= b[6 + a];
        dd[a] = jmax(jmax(mn[a] - b[3 + a], b[a] - mx[a]), 0.0f);
      }
      if (inside) in |= 1u << j;
      sh.dist[j][tid] = sqrtf(dd[0] * dd[0] + dd[1] * dd[1] + dd[2] * dd[2]);
    }
    sh.inside[tid] = in;
    sh.removed[tid] = 0;
  }
  __syncthreads();
}

// first(elig_key(ws, removed)): the unremoved unit lane with the smallest
// distance over the subs it is eligible for (inside and no farther than
// the sub's bound), ties to the lowest lane; 128 when there is none. The
// pick is marked removed. Returns the same lane in every thread.
__device__ int pick(Shared& sh, const float ws[kNs], int tid) {
  if (tid < kUpc) {
    const unsigned in = sh.inside[tid];
    float key = __int_as_float(0x7f800000);   // +inf
    for (int j = 0; j < kNs; ++j) {
      const float d = sh.dist[j][tid];
      if (((in >> j) & 1u) && d <= ws[j]) key = fminf(key, d);
    }
    if (sh.removed[tid]) key = __int_as_float(0x7f800000);
    int lane = key < __int_as_float(0x7f800000) ? tid : 128;
    for (int o = 16; o >= 1; o >>= 1) {
      const float k2 = __shfl_xor_sync(0xffffffffu, key, o);
      const int l2 = __shfl_xor_sync(0xffffffffu, lane, o);
      if (k2 < key || (k2 == key && l2 < lane)) {
        key = k2;
        lane = l2;
      }
    }
    if ((tid & 31) == 0) {
      sh.pk_key[tid >> 5] = key;
      sh.pk_lane[tid >> 5] = lane;
    }
  }
  __syncthreads();
  if (tid == 0) {
    const bool second = sh.pk_key[1] < sh.pk_key[0] ||
        (sh.pk_key[1] == sh.pk_key[0] && sh.pk_lane[1] < sh.pk_lane[0]);
    const int u = second ? sh.pk_lane[1] : sh.pk_lane[0];
    if (u < kUpc) sh.removed[u] = 1;
    sh.pick = u;
  }
  __syncthreads();
  return sh.pick;
}

// Stage a precomputed unit: the non-zero q16 rows of the det|u|v|t
// blocks, the w column (det - u) - v formed on rows 0-5, and the normal
// rows 0-2.
__device__ void stage_unit(Shared& sh, const Args& a, int unit, int tid) {
  const float* q = a.q16 + static_cast<size_t>(unit) * 16 * kQ16Cols;
  const int r = tid / kLpu, k = tid % kLpu;
  if (r < 6) {
    const float* qr = q + r * kQ16Cols;
    const float qd = qr[k], qu = qr[kLpu + k], qv = qr[2 * kLpu + k];
    if (r < 3) sh.q[kQDet + r][k] = qd;
    sh.q[kQU + r][k] = qu;
    sh.q[kQV + r][k] = qv;
    sh.q[kQW + r][k] = (qd - qu) - qv;
  } else if (r < kRows) {
    sh.q[kQT + r - 6][k] = q[r * kQ16Cols + 3 * kLpu + k];
  } else if (r < kRows + 3) {
    sh.nrm[r - kRows][k] =
        a.nrm[(static_cast<size_t>(unit) * 8 + r - kRows) * a.npad + k];
  }
  __syncthreads();
}

// Derive a compressed unit's table into shared memory
// (_derive_q16_unit, absolute coordinates): positions and, for indexed
// records, the corner lanes, then one thread per leaf forms e1, e2,
// n = e1 x e2, w1 = e2 x v0, w2 = v0 x e1 and e2.w2 in derive_q16's order.
__device__ void stage_grid_unit(Shared& sh, const Args& a, int unit,
                                int tid) {
  const float* rec = a.grid + static_cast<size_t>(unit) * a.grows * kGridLanes;
  if (tid < 3 * kGridLanes) sh.pos[tid / kGridLanes][tid % kGridLanes] =
      rec[tid];
  if (a.corners == nullptr && tid >= 3 * kGridLanes &&
      tid < 3 * kGridLanes + 3 * kLpu) {
    const int i = tid - 3 * kGridLanes;
    const int j = i / kLpu, k = i % kLpu;
    // Lane indices are small integers in float32 (truncating cast); the
    // clamp only guards memory against a bad record.
    sh.cidx[j][k] = min(max(static_cast<int>(
        rec[(3 + j) * kGridLanes + k]), 0), kGridLanes - 1);
  }
  __syncthreads();
  if (tid < kLpu) {
    const int k = tid;
    const int i0 = sh.cidx[0][k], i1 = sh.cidx[1][k], i2 = sh.cidx[2][k];
    const float v0x = sh.pos[0][i0], v0y = sh.pos[1][i0], v0z = sh.pos[2][i0];
    const float e1x = sh.pos[0][i1] - v0x, e1y = sh.pos[1][i1] - v0y;
    const float e1z = sh.pos[2][i1] - v0z;
    const float e2x = sh.pos[0][i2] - v0x, e2y = sh.pos[1][i2] - v0y;
    const float e2z = sh.pos[2][i2] - v0z;
    const float nx = e1y * e2z - e1z * e2y;
    const float ny = e1z * e2x - e1x * e2z;
    const float nz = e1x * e2y - e1y * e2x;
    const float w1x = e2y * v0z - e2z * v0y;
    const float w1y = e2z * v0x - e2x * v0z;
    const float w1z = e2x * v0y - e2y * v0x;
    const float w2x = v0y * e1z - v0z * e1y;
    const float w2y = v0z * e1x - v0x * e1z;
    const float w2z = v0x * e1y - v0y * e1x;
    const float e2w2 = e2x * w2x + e2y * w2y + e2z * w2z;
    // Rows [-n|-w1|-w2|0] over d, [0|e2|-e1|0] over o x d, [0|0|0|n] over
    // o, [0|0|0|-e2.w2] over the ones row.
    const float qd[kRows] = {-nx, -ny, -nz, 0, 0, 0, 0, 0, 0, 0};
    const float qu[kRows] = {-w1x, -w1y, -w1z, e2x, e2y, e2z, 0, 0, 0, 0};
    const float qv[kRows] = {-w2x, -w2y, -w2z, -e1x, -e1y, -e1z,
                             0, 0, 0, 0};
    const float qt[kRows] = {0, 0, 0, 0, 0, 0, nx, ny, nz, -e2w2};
    for (int r = 0; r < 6; ++r) {
      if (r < 3) sh.q[kQDet + r][k] = qd[r];
      sh.q[kQU + r][k] = qu[r];
      sh.q[kQV + r][k] = qv[r];
      sh.q[kQW + r][k] = (qd[r] - qu[r]) - qv[r];
    }
    for (int r = 6; r < kRows; ++r) sh.q[kQT + r - 6][k] = qt[r];
    const float nn = jmax(sqrtf(nx * nx + ny * ny + nz * nz), 1e-20f);
    sh.nrm[0][k] = nx / nn;
    sh.nrm[1][k] = ny / nn;
    sh.nrm[2][k] = nz / nn;
  }
  __syncthreads();
}

// Leaves k and k + 1 (k even) of n staged rows from row q0, read as
// float2, dotted with the ray rows r[0..n), each summed left to right.
__device__ __forceinline__ float2 dot_rows(const Shared& sh, int q0, int k,
                                           const float* r, int n) {
  float2 q = *reinterpret_cast<const float2*>(&sh.q[q0][k]);
  float2 acc = make_float2(q.x * r[0], q.y * r[0]);
#pragma unroll
  for (int i = 1; i < n; ++i) {
    q = *reinterpret_cast<const float2*>(&sh.q[q0 + i][k]);
    acc.x = acc.x + q.x * r[i];
    acc.y = acc.y + q.y * r[i];
  }
  return acc;
}

// Möller-Trumbore of one quotient set: t when accepted, else kBig.
__device__ __forceinline__ float mt_accept(float det, float un, float vn,
                                           float tn, float wn, float t_min) {
  // No det guard: det == 0 gives inf/NaN quotients that fail the window.
  const float iv = 1.0f / det;
  const float uu = un * iv, vv = vn * iv, ww = wn * iv, tt = tn * iv;
  // w-form acceptance, min(u, v, w) >= -eps (a NaN fails every compare).
  const bool ok = uu >= -kUvEps && vv >= -kUvEps && ww >= -kUvEps &&
                  tt >= t_min;
  return ok ? tt : kBig;
}

// Möller-Trumbore of the staged leaves k, k + 1 against ray rows r.
__device__ __forceinline__ float2 mt_pair(const Shared& sh, int k,
                                          const float r[kRows],
                                          float t_min) {
  const float2 det = dot_rows(sh, kQDet, k, r, 3);
  const float2 un = dot_rows(sh, kQU, k, r, 6);
  const float2 vn = dot_rows(sh, kQV, k, r, 6);
  const float2 tn = dot_rows(sh, kQT, k, r + 6, 4);
  const float2 wn = dot_rows(sh, kQW, k, r, 6);
  return make_float2(mt_accept(det.x, un.x, vn.x, tn.x, wn.x, t_min),
                     mt_accept(det.y, un.y, vn.y, tn.y, wn.y, t_min));
}

// The leaf fold: a smaller t replaces the minimum and its normal, an equal
// one adds its normal (winner normals summed over exact ties).
__device__ __forceinline__ void fold(float t, float nx, float ny, float nz,
                                     float& tb, float& sx, float& sy,
                                     float& sz) {
  if (t < tb) {
    tb = t;
    sx = nx;
    sy = ny;
    sz = nz;
  } else if (t == tb) {
    sx += nx;
    sy += ny;
    sz += nz;
  }
}

// Test the staged unit on the nl listed lanes: S slices of leaf pairs per
// lane over the block's threads, partials combined across the S threads
// by shuffles, each lane's (leaf minimum, summed normal) left in
// sh.part[slot]. Ends with the block barrier that publishes it.
__device__ void test_listed(Shared& sh, const float* __restrict__ rv,
                            int nl, float t_min, int tid) {
  int sl = kMaxSlices;
  while (sl > 1 && nl * sl > kGroup) sl >>= 1;
  const int slot = tid / sl, s = tid % sl;
  float tb = kBig, sx = 0.0f, sy = 0.0f, sz = 0.0f;
  if (slot < nl) {
    const float* row = rv + sh.list[slot];
    float r[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) r[i] = __ldg(row + i * kGroup);
    for (int k = 2 * s; k < kLpu; k += 2 * sl) {
      const float2 t = mt_pair(sh, k, r, t_min);
      const float2 nx = *reinterpret_cast<const float2*>(&sh.nrm[0][k]);
      const float2 ny = *reinterpret_cast<const float2*>(&sh.nrm[1][k]);
      const float2 nz = *reinterpret_cast<const float2*>(&sh.nrm[2][k]);
      if (k == 2 * s) {                     // the slice's first leaf
        tb = t.x;
        sx = nx.x;
        sy = ny.x;
        sz = nz.x;
      } else {
        fold(t.x, nx.x, ny.x, nz.x, tb, sx, sy, sz);
      }
      fold(t.y, nx.y, ny.y, nz.y, tb, sx, sy, sz);
    }
  }
  for (int o = 1; o < sl; o <<= 1) {
    const float t2 = __shfl_xor_sync(0xffffffffu, tb, o);
    const float x2 = __shfl_xor_sync(0xffffffffu, sx, o);
    const float y2 = __shfl_xor_sync(0xffffffffu, sy, o);
    const float z2 = __shfl_xor_sync(0xffffffffu, sz, o);
    fold(t2, x2, y2, z2, tb, sx, sy, sz);
  }
  if (s == 0 && slot < nl) sh.part[slot] = make_float4(tb, sx, sy, sz);
  __syncthreads();
}

template <bool Compressed>
__global__ void __launch_bounds__(kGroup, 1)
group_trace_kernel(const Args a) {
  __shared__ Shared sh;
  const int g = blockIdx.x;
  const int tid = threadIdx.x;
  const int sub = tid / kSub;
  const size_t ray = static_cast<size_t>(g) * kGroup + tid;
  const size_t nrow = static_cast<size_t>(g) * 3 * kGroup + tid;
  const int ccnt = min(a.ccount[g], a.kc);
  if (ccnt <= 0) {                          // empty group: carries through
    a.t_out[ray] = a.t_in[ray];
    for (int c = 0; c < 3; ++c) a.n_out[nrow + c * kGroup] =
        a.n_in[nrow + c * kGroup];
    if (tid == 0) {
      a.visits[g] = 0;
      a.gated[g] = 0;
      a.tests[g] = 0;
    }
    return;
  }
  const int warp = tid / 32, lane = tid % 32;
  const float* rv = a.rv + static_cast<size_t>(g) * 16 * kGroup;
  float r[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) r[i] = rv[i * kGroup + tid];
  if (tid < kBox) sh.box[tid] = a.box[static_cast<size_t>(g) * kBox + tid];
  if (Compressed && a.corners != nullptr && tid < 3 * kLpu)
    sh.cidx[tid / kLpu][tid % kLpu] = a.corners[tid];
  __syncthreads();

  // Per-ray scene-exit reach through the inflated scene box (the tail).
  float exit_t = 0.0f;
  for (int k = 0; k < 3; ++k) {
    const float dk = fabsf(r[k]) < kTiny ? (r[k] >= 0.0f ? kTiny : -kTiny)
                                         : r[k];
    const float e0 = (sh.box[kNs * 16 + k] - r[6 + k]) / dk;
    const float e1 = (sh.box[kNs * 16 + 3 + k] - r[6 + k]) / dk;
    const float ek = jmax(e0, e1);
    exit_t = k == 0 ? ek : jmin(exit_t, ek);
  }

  float bt = a.t_in[ray];
  float bnx = a.n_in[nrow], bny = a.n_in[nrow + kGroup];
  float bnz = a.n_in[nrow + 2 * kGroup];
  int nv = 0, ngated = 0, ntests = 0;
  float ws[kNs];
  worst_subs(sh, bt, exit_t, sub, tid, ws);
  const int* cand = a.ccand + static_cast<size_t>(g) * a.kc;
  const float* entry = a.centry + static_cast<size_t>(g) * a.kc;
  for (int ci = 0; ci < ccnt; ++ci) {
    // Cluster stop rule (cluster_cond): no remaining cluster can beat the
    // largest sub bound.
    float wmax = ws[0];
    for (int j = 1; j < kNs; ++j) wmax = jmax(wmax, ws[j]);
    if (!(wmax >= entry[min(ci, a.kc - 1)])) break;
    const int cl = cand[ci];
    load_cluster(sh, a.meta, cl, tid);
    // The two-deep pick order: u0, u1 with the entry bounds, then each
    // step picks n2 with the current bounds before processing u.
    int u = pick(sh, ws, tid);
    int n1 = pick(sh, ws, tid);
    while (u < 128) {
      const int n2 = pick(sh, ws, tid);
      unsigned bits = 0;
      const unsigned in = sh.inside[u];
      for (int j = 0; j < kNs; ++j)
        if (((in >> j) & 1u) && sh.dist[j][u] <= ws[j]) bits |= 1u << j;
      if (bits) {
        // List the gated lanes that a hit can still improve.
        const bool listed = ((bits >> sub) & 1u) && bt > a.t_min;
        const unsigned bal = __ballot_sync(0xffffffffu, listed);
        if (lane == 0) sh.wcount[warp] = __popc(bal);
        __syncthreads();
        int c = sh.wcount[lane];                // inclusive warp-count scan
        for (int o = 1; o < kWarps; o <<= 1) {
          const int v = __shfl_up_sync(0xffffffffu, c, o);
          if (lane >= o) c += v;
        }
        const int nl = __shfl_sync(0xffffffffu, c, kWarps - 1);
        const int before = __shfl_sync(0xffffffffu, c, max(warp - 1, 0));
        const int slot = (warp > 0 ? before : 0) +
                         __popc(bal & ((1u << lane) - 1u));
        if (nl > 0) {
          if (listed) sh.list[slot] = tid;
          const int unit = cl * kUpc + u;
          if (Compressed)
            stage_grid_unit(sh, a, unit, tid);
          else
            stage_unit(sh, a, unit, tid);
          test_listed(sh, rv, nl, a.t_min, tid);
          if (listed) {
            // The t_max window on the leaf minimum, then the strict-< take.
            const float4 p = sh.part[slot];
            const float tb = p.x <= a.t_max ? p.x : kBig;
            if (tb < bt) {
              bt = tb;
              bnx = p.y;
              bny = p.z;
              bnz = p.w;
            }
          }
        }
        nv += 1;
        ngated += __popc(bits);
        ntests += nl;
      }
      worst_subs(sh, bt, exit_t, sub, tid, ws);
      u = n1;
      n1 = n2;
    }
  }
  a.t_out[ray] = bt;
  a.n_out[nrow] = bnx;
  a.n_out[nrow + kGroup] = bny;
  a.n_out[nrow + 2 * kGroup] = bnz;
  if (tid == 0) {
    a.visits[g] = nv;
    a.gated[g] = ngated;
    a.tests[g] = ntests;
  }
}

}  // namespace

// One cluster window over n_groups groups on `stream` (K2). Exactly one of
// q16 (precomputed: with nrm (U, 8, npad)) and grid (compressed records of
// grows rows; corners null = per-unit index rows 3-5) is set. Returns the
// CUDA error code of the launch (0 = launched).
extern "C" int rtmm_group_trace(
    const float* rv, const float* box, const int* ccand, const int* ccount,
    const float* centry, const float* t_in, const float* n_in,
    const float* meta, const float* q16, int npad, const float* nrm,
    const float* grid, int grows, const int* corners, float* t_out,
    float* n_out, int* visits, int* gated, int* tests, int n_groups, int kc,
    int n_clusters, float t_min, float t_max, void* stream) {
  Args a = {};
  a.rv = rv;
  a.box = box;
  a.ccand = ccand;
  a.ccount = ccount;
  a.centry = centry;
  a.t_in = t_in;
  a.n_in = n_in;
  a.meta = meta;
  a.q16 = q16;
  a.nrm = nrm;
  a.npad = npad;
  a.grid = grid;
  a.grows = grows;
  a.corners = corners;
  a.t_out = t_out;
  a.n_out = n_out;
  a.visits = visits;
  a.gated = gated;
  a.tests = tests;
  a.kc = kc;
  a.t_min = t_min;
  a.t_max = t_max;
  if (n_groups < 1 || kc < 1 || n_clusters < 1 ||
      (q16 == nullptr) == (grid == nullptr) ||
      (q16 != nullptr && (nrm == nullptr || npad < kLpu)) ||
      (grid != nullptr && grows < (corners ? 3 : 6)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (grid != nullptr)
    group_trace_kernel<true><<<n_groups, kGroup, 0, st>>>(a);
  else
    group_trace_kernel<false><<<n_groups, kGroup, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rtmm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
