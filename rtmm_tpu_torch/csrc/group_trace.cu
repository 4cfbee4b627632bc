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
// Design. One block per group of 1,024 sorted rays, one thread per ray;
// warps 4j..4j+3 are sub-group j (128 rays with their own origin and
// reach boxes, held in shared memory with the scene-exit tail). The block
// walks the group's front-to-back cluster list. Per cluster, 64 threads
// cull the cluster's units against the 8 reach boxes (one bit per sub)
// and hold each unit's distance from every sub's origin box. Picks are a
// warp arg-min of the nearest eligible distance (ties to the lowest lane)
// over the two warps of unit lanes, combined by thread 0. The pick order
// is the TPU kernel's two-deep pipeline order: u0 and u1 are picked with
// the cluster's entry bounds, and each step picks the next unit with the
// current bounds before it processes the current one. A processed unit's
// gate bits (inside[j] && dist[j] <= ws[j], with the current bounds) say
// which sub-groups run Möller-Trumbore on it; its q16 rows 0-9 (with the
// w column (det - u) - v formed on the table) and normals are staged in
// shared memory, or derived there from the record, one thread per leaf.
// Each thread keeps its ray's closest hit in registers. Per-sub worst
// bounds (a hit's t, or a miss's scene-exit t, floored at 0; dead lanes
// carry t = 0) are block max-reductions on order-preserving int keys,
// refreshed after every unit. The walk stops when the largest sub bound
// is below the next cluster's entry distance.
//
// What bounds it: arithmetic. Each (ray, leaf) test here is ~106 float32
// operations (five 10-term dot products over the ray rows [d, o x d, o,
// 1], one correctly rounded division, four quotients, four compares, the
// leaf minimum), run only on the gated sub-groups; the unit tables (10 KB)
// or records (1.5-2.5 KB) are read from L2 once per visit and broadcast
// from shared memory. The table has a fixed layout of zeros (det uses 3
// of the 10 ray rows, u, v and w 6, t 4), so the test needs ~55 of those
// operations. This first version aims to be right: it does not skip the
// zeros and uses no tensor cores.
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
constexpr int kCols = 5 * kLpu;         // staged: det|u|v|t|w
constexpr int kBox = kNs * 16 + 16;     // per-sub boxes, then the exit box
constexpr int kGridLanes = 128;         // compressed record row width
constexpr float kBig = 1e30f;           // miss sentinel
constexpr float kUvEps = 1e-3f;         // MT_UV_EPS, intersection.hlsl:413
constexpr float kTiny = 1e-12f;

struct Shared {
  float q[kRows][kCols];        // staged unit: det|u|v|t|w over rows 0-9
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

// Stage a precomputed unit: q16 rows 0-9 of the det|u|v|t blocks, the w
// column (det - u) - v formed on them, and the normal rows 0-2.
__device__ void stage_unit(Shared& sh, const Args& a, int unit, int tid) {
  if (tid < kRows * kLpu) {
    const int r = tid / kLpu, k = tid % kLpu;
    const float* q = a.q16 + (static_cast<size_t>(unit) * 16 + r) * kQ16Cols;
    const float qd = q[k], qu = q[kLpu + k], qv = q[2 * kLpu + k];
    sh.q[r][k] = qd;
    sh.q[r][kLpu + k] = qu;
    sh.q[r][2 * kLpu + k] = qv;
    sh.q[r][3 * kLpu + k] = q[3 * kLpu + k];
    sh.q[r][4 * kLpu + k] = (qd - qu) - qv;
  } else if (tid < kRows * kLpu + 3 * kLpu) {
    const int i = tid - kRows * kLpu;
    const int r = i / kLpu, k = i % kLpu;
    sh.nrm[r][k] = a.nrm[(static_cast<size_t>(unit) * 8 + r) * a.npad + k];
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
    for (int r = 0; r < kRows; ++r) {
      sh.q[r][k] = qd[r];
      sh.q[r][kLpu + k] = qu[r];
      sh.q[r][2 * kLpu + k] = qv[r];
      sh.q[r][3 * kLpu + k] = qt[r];
      sh.q[r][4 * kLpu + k] = (qd[r] - qu[r]) - qv[r];
    }
    const float nn = jmax(sqrtf(nx * nx + ny * ny + nz * nz), 1e-20f);
    sh.nrm[0][k] = nx / nn;
    sh.nrm[1][k] = ny / nn;
    sh.nrm[2][k] = nz / nn;
  }
  __syncthreads();
}

// One 10-term dot product of a staged column with the ray rows, summed
// left to right.
__device__ __forceinline__ float dot10(const Shared& sh, int c,
                                       const float r[kRows]) {
  float acc = sh.q[0][c] * r[0];
#pragma unroll
  for (int i = 1; i < kRows; ++i) acc = acc + sh.q[i][c] * r[i];
  return acc;
}

// Fold the staged unit's 64 leaves into this thread's running best
// (process_unit's mt_lanes).
__device__ __forceinline__ void process_unit(const Shared& sh,
                                             const float r[kRows],
                                             float t_min, float t_max,
                                             float& bt, float& bnx,
                                             float& bny, float& bnz) {
  float tb = kBig, nsx = 0.0f, nsy = 0.0f, nsz = 0.0f;
#pragma unroll 2
  for (int k = 0; k < kLpu; ++k) {
    const float det = dot10(sh, k, r);
    const float un = dot10(sh, kLpu + k, r);
    const float vn = dot10(sh, 2 * kLpu + k, r);
    const float tn = dot10(sh, 3 * kLpu + k, r);
    const float wn = dot10(sh, 4 * kLpu + k, r);
    // No det guard: det == 0 gives inf/NaN quotients that fail the window.
    const float iv = 1.0f / det;
    const float uu = un * iv, vv = vn * iv, ww = wn * iv, tt = tn * iv;
    // w-form acceptance, min(u, v, w) >= -eps (a NaN fails every compare).
    const bool ok = uu >= -kUvEps && vv >= -kUvEps && ww >= -kUvEps &&
                    tt >= t_min;
    const float t = ok ? tt : kBig;
    // Leaf minimum with the winner normal summed over exact ties.
    if (k == 0 || t < tb) {
      tb = t;
      nsx = sh.nrm[0][k];
      nsy = sh.nrm[1][k];
      nsz = sh.nrm[2][k];
    } else if (t == tb) {
      nsx += sh.nrm[0][k];
      nsy += sh.nrm[1][k];
      nsz += sh.nrm[2][k];
    }
  }
  // The t_max window on the leaf minimum, then the strict-< take.
  tb = tb <= t_max ? tb : kBig;
  if (tb < bt) {
    bt = tb;
    bnx = nsx;
    bny = nsy;
    bnz = nsz;
  }
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
    }
    return;
  }
  float r[kRows];
  const float* rv = a.rv + static_cast<size_t>(g) * 16 * kGroup + tid;
#pragma unroll
  for (int i = 0; i < kRows; ++i) r[i] = rv[i * kGroup];
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
  int nv = 0, ngated = 0;
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
        const int unit = cl * kUpc + u;
        if (Compressed)
          stage_grid_unit(sh, a, unit, tid);
        else
          stage_unit(sh, a, unit, tid);
        if ((bits >> sub) & 1u)
          process_unit(sh, r, a.t_min, a.t_max, bt, bnx, bny, bnz);
        nv += 1;
        ngated += __popc(bits);
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
    float* n_out, int* visits, int* gated, int n_groups, int kc,
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
