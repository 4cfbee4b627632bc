// Frame-prologue kernels for NVIDIA Hopper (sm_90a): the tile frusta and
// the cluster cull + front-to-back select that build the trace kernel's
// per-tile cluster lists on every K1 path.
//
// Replaces no Pallas kernel: on the TPU this work is XLA-fused, no Pallas
// kernel behind it, inside the JAX package's jitted prologue
// (render_pallas_frames' jax.vmap(frame_inputs),
// rtmm_tpu/ops/pallas_tiled.py:1490-1509). Two kernels:
//
// - tile_frusta: rtmm_tpu/ops/culling.py::tile_frustums (:56) and
//   tile_sub_frustums (:159), with tiled.py::frustum_scalars (:291). Per
//   frame the apex, the closest point of two corner pixel rays; per tile
//   the 4 planes of its cone and of each of its n_sub sub-cones, from the
//   unit directions of the sub-cone grid's corner pixels (the tile's cone
//   takes the grid's outer corners, which are the same pixels); and
//   optionally the trace kernel's per-tile scalar pack. Inputs: the
//   frames' inverse view-projections, the frame and padded sizes, a tile
//   range.
// - cluster_select: culling.py::cull_units (:207) and aabb_distance
//   (:219), tiled.py::_select_nearest_clusters (:193) and cluster_window
//   (:264), jax.lax.top_k at pallas_tiled.py:1503, the instanced cull and
//   top-k at rtmm_tpu/render/instances.py:478-480 and :548-554. Per row
//   (a (frame, tile) or an (instance, tile)): every cluster culled by the
//   p-vertex test against the row's 4 planes (or read from a `remaining`
//   mask), its apex -> AABB distance, and the kc nearest in (distance,
//   cluster index) order, with the window's cleared mask and next bound.
//
// The plain PyTorch versions are rtmm_tpu_torch/ops/prologue.py::
// tile_frusta_plain and cluster_select_plain, which compose the port's
// culling / tiled functions. This file does their float32 operations in
// their order, each 3-term .sum(-1) as PyTorch's CUDA reduction sums it
// (sum3), and is built with -fmad=false and without fast math, so every
// output equals the plain version's on the card bit for bit; ties go to
// the lower cluster index, as a stable sort and top_k give them.
//
// What bounds them on an H100: both are tiny. tile_frusta writes ~0.56 KB
// per tile row (planes and pack, the sub-planes only inside the pack when
// a pack is built; ~37 MB for a 32-frame 1080p chunk) for ~1,000 float32
// operations per row: bytes, ~0.011 ms.
// cluster_select does ~40 float32 operations per (row, cluster) of the
// cull and distance and writes its lists (8 bytes per (row, slot)); a
// window also reads and writes a (row, cluster) mask. What the design does
// about that: tile_frusta keeps the corner directions and planes of a tile
// in shared memory (no (tiles, corners, 3) intermediate in device
// memory), one 64-thread group per tile; cluster_select keeps one
// block per row and never stores a (row, plane, cluster, 3) temporary or
// sorts a whole row: when the row's clusters exceed kc it finds the
// kc-th (distance, index) key by a block-wide radix select over the keys
// (recomputed per pass, so there is no cap on the cluster count), keeps
// the selected keys in shared memory and sorts only those (bitonic), in
// chunks of kListCap when kc is larger.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTile = 32;
constexpr int kMaxCorners = 18;  // (n_rows + 1)(n_cols + 1), n_sub <= 8
constexpr int kMaxSub = 8;
constexpr int kFrustaThreads = 64;  // per tile
constexpr int kFrustaTiles = 4;     // tiles per block
constexpr int kListCap = 1024;      // selected keys sorted at once
constexpr uint32_t kInfBits = 0x7f800000u;
constexpr uint32_t kNanBits = 0x7fc00000u;
// The plain version's Python-scalar constants, as PyTorch casts them to
// float32 before the operation.
constexpr float kDenTiny = static_cast<float>(1e-12);

// ---------------------------------------------------------------------
// tile_frusta

struct FrustaArgs {
  const float* ivp;  // (F, 4, 4) row-major
  float width, height, rw, rh;  // the NDC size, the padded size
  int tx, tile0, n_tiles, n_frames, nsub, nrows, pack, raygen;
  const float* aabb;  // (6,) scene exit box, for the pack
  float* apex;        // (F, 3)
  float* normals;     // (F, n_tiles, 4, 3)
  float* sub;         // (F, n_tiles, nsub, 4, 3) or null (in the pack)
  float* frus;        // (F, n_tiles, pack) or null
};

// m (row i) . [ndc_x, ndc_y, z, 1] as culling.tile_frustums' unproject
// writes it, then the perspective divide.
__device__ __forceinline__ void unproject(const float* m, float ndc_x,
                                          float ndc_y, float z, float out[3]) {
  float p[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    p[i] = (m[4 * i] * ndc_x + m[4 * i + 1] * ndc_y) +
           (m[4 * i + 2] * z + m[4 * i + 3]);
  out[0] = p[0] / p[3];
  out[1] = p[1] / p[3];
  out[2] = p[2] / p[3];
}

// x0 + x1 + x2 as PyTorch's CUDA reduction sums a contiguous last axis
// of 3 (ATen/native/cuda/Reduce.cuh): two lanes, lane 0 holding x0 and
// x2 in two of its four accumulators, lane 1 holding x1, each accumulator
// starting at 0; lane 0 folds its accumulators in order, then adds lane
// 1's. The zeros turn a -0 into +0 as the reduction's do. (The CPU sums
// left to right, so the plain version's sums differ between devices.)
__device__ __forceinline__ float sum3(float x0, float x1, float x2) {
  float s = (0.0f + x0) + (0.0f + x2);
  s = s + 0.0f;
  s = s + 0.0f;
  return s + (0.0f + x1);
}

// (a * b).sum(-1) over 3 components, on the card.
__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return sum3(a[0] * b[0], a[1] * b[1], a[2] * b[2]);
}

// culling._ray_closest_point of the corner rays (0, 0) and (rw, rh).
__device__ void frame_apex(const float* m, float width, float height, float rw,
                           float rh, float apex[3]) {
  const float x0 = (0.0f / width) * 2.0f - 1.0f;
  const float y0 = -((0.0f / height) * 2.0f - 1.0f);
  const float x1 = (rw / width) * 2.0f - 1.0f;
  const float y1 = -((rh / height) * 2.0f - 1.0f);
  float o1[3], f1[3], o2[3], f2[3], d1[3], d2[3], w[3];
  unproject(m, x0, y0, 0.0f, o1);
  unproject(m, x0, y0, 1.0f, f1);
  unproject(m, x1, y1, 0.0f, o2);
  unproject(m, x1, y1, 1.0f, f2);
  for (int k = 0; k < 3; ++k) {
    d1[k] = f1[k] - o1[k];
    d2[k] = f2[k] - o2[k];
    w[k] = o1[k] - o2[k];
  }
  const float a = dot3(d1, d1), b = dot3(d1, d2), c = dot3(d2, d2);
  const float d = dot3(d1, w), e = dot3(d2, w);
  float den = a * c - b * b;
  den = fabsf(den) < kDenTiny ? kDenTiny : den;
  const float s = (b * e - c * d) / den;
  const float t = (a * e - b * d) / den;
  for (int k = 0; k < 3; ++k)
    apex[k] = 0.5f * ((o1[k] + s * d1[k]) + (o2[k] + t * d2[k]));
}

// Plane k of the cone with corners tl, tr, br, bl (inward normal): the
// cross product of edge k's corner directions, flipped toward the corner
// sum (a zero or NaN dot keeps the sign, as torch.sign's 0 does).
__device__ void cone_plane(const float* tl, const float* tr, const float* br,
                           const float* bl, int k, float n[3]) {
  const float* cs[4] = {tl, tr, br, bl};
  const float* a = cs[k];
  const float* b = cs[(k + 1) & 3];
  n[0] = a[1] * b[2] - a[2] * b[1];
  n[1] = a[2] * b[0] - a[0] * b[2];
  n[2] = a[0] * b[1] - a[1] * b[0];
  float dc[3];
  for (int j = 0; j < 3; ++j) dc[j] = ((tl[j] + tr[j]) + br[j]) + bl[j];
  const float sign = dot3(n, dc) < 0.0f ? -1.0f : 1.0f;
  for (int j = 0; j < 3; ++j) n[j] = n[j] * sign;
}

__global__ void __launch_bounds__(kFrustaThreads* kFrustaTiles)
    tile_frusta_kernel(FrustaArgs g) {
  __shared__ float s_dir[kFrustaTiles][kMaxCorners][3];
  __shared__ float s_plane[kFrustaTiles][(kMaxSub + 1) * 4][3];
  __shared__ float s_apex[kFrustaTiles][3];
  const int slot = threadIdx.y;
  const int lane = threadIdx.x;
  const long long row =
      static_cast<long long>(blockIdx.x) * kFrustaTiles + slot;
  const bool live =
      row < static_cast<long long>(g.n_frames) * g.n_tiles;
  const int f = live ? static_cast<int>(row / g.n_tiles) : 0;
  const int t = live ? static_cast<int>(row % g.n_tiles) : 0;
  const int tile = g.tile0 + t;
  const float* m = g.ivp + 16 * f;
  const int ncols = g.nsub / g.nrows;
  const int sw = kTile / ncols, sh = kTile / g.nrows;
  const int ncorner = (g.nrows + 1) * (ncols + 1);
  if (live && lane < ncorner) {
    // Corner (r, c) of the tile's sub-cone grid: its pixel, NDC and the
    // unit direction unproject(1) - unproject(0).
    const int r = lane / (ncols + 1), c = lane % (ncols + 1);
    const float px = static_cast<float>((tile % g.tx) * kTile) +
                     static_cast<float>(c * sw);
    const float py = static_cast<float>((tile / g.tx) * kTile) +
                     static_cast<float>(r * sh);
    const float ndc_x = (px / g.width) * 2.0f - 1.0f;
    const float ndc_y = -((py / g.height) * 2.0f - 1.0f);
    float pf[3], pn[3], d[3];
    unproject(m, ndc_x, ndc_y, 1.0f, pf);
    unproject(m, ndc_x, ndc_y, 0.0f, pn);
    for (int k = 0; k < 3; ++k) d[k] = pf[k] - pn[k];
    const float len = sqrtf(dot3(d, d));
    for (int k = 0; k < 3; ++k) s_dir[slot][lane][k] = d[k] / len;
  } else if (live && lane == kFrustaThreads - 1) {
    float a[3];
    frame_apex(m, g.width, g.height, g.rw, g.rh, a);
    for (int k = 0; k < 3; ++k) s_apex[slot][k] = a[k];
  }
  __syncthreads();
  if (live && lane < (g.nsub + 1) * 4) {
    // Planes 0 .. 4 nsub - 1: sub-cone j = lane / 4 (row-major in the
    // grid); the last four: the tile's own cone, the grid's corners.
    const int j = lane / 4, k = lane % 4;
    int r0, c0, r1, c1;
    if (j < g.nsub) {
      r0 = j / ncols;
      c0 = j % ncols;
      r1 = r0 + 1;
      c1 = c0 + 1;
    } else {
      r0 = 0;
      c0 = 0;
      r1 = g.nrows;
      c1 = ncols;
    }
    const int w1 = ncols + 1;
    float n[3];
    cone_plane(s_dir[slot][r0 * w1 + c0], s_dir[slot][r0 * w1 + c1],
               s_dir[slot][r1 * w1 + c1], s_dir[slot][r1 * w1 + c0], k, n);
    for (int q = 0; q < 3; ++q) s_plane[slot][lane][q] = n[q];
  }
  __syncthreads();
  if (!live) return;
  const size_t trow = static_cast<size_t>(f) * g.n_tiles + t;
  if (t == 0 && lane < 3) g.apex[3 * f + lane] = s_apex[slot][lane];
  for (int i = lane; i < 12; i += kFrustaThreads)
    g.normals[trow * 12 + i] = s_plane[slot][g.nsub * 4 + i / 3][i % 3];
  const int ns = g.nsub * 12;
  if (g.sub != nullptr)
    for (int i = lane; i < ns; i += kFrustaThreads)
      g.sub[trow * ns + i] = s_plane[slot][i / 3][i % 3];
  if (g.frus != nullptr) {
    float* out = g.frus + trow * g.pack;
    const int rg = 3 + ns;
    const int box = rg + (g.raygen ? 18 : 0);
    for (int i = lane; i < g.pack; i += kFrustaThreads) {
      float v = 0.0f;
      if (i < 3)
        v = s_apex[slot][i];
      else if (i < rg)
        v = s_plane[slot][(i - 3) / 3][(i - 3) % 3];
      else if (g.raygen && i == rg)
        v = static_cast<float>((tile % g.tx) * kTile);
      else if (g.raygen && i == rg + 1)
        v = static_cast<float>((tile / g.tx) * kTile);
      else if (g.raygen && i < rg + 18)
        v = m[i - rg - 2];
      else if (i < box + 6)
        v = g.aabb[i - box];
      out[i] = v;
    }
  }
}

// ---------------------------------------------------------------------
// cluster_select

struct SelectArgs {
  int n_rows, n_cl, kc;  // kc: list length (0: the cull alone)
  const float* apex;     // (n_rows / rows_per_apex, 3)
  int rows_per_apex;
  const float* planes;               // (n_rows, 4, 3), or null
  const unsigned char* remaining;    // (n_rows, n_cl), or null: cull
  const unsigned char* row_valid;    // (n_rows,), or null
  const float* bmin;                 // (n_cl, 3) cluster boxes
  const float* bmax;
  const unsigned char* valid;        // (n_cl,)
  unsigned char* hit;                // (n_rows, n_cl), or null
  unsigned char* any;                // (n_rows,), or null
  int* ccand;                        // (n_rows, kc)
  int* ccount;                       // (n_rows,)
  float* centry;                     // (n_rows, kc)
  unsigned char* new_rem;            // (n_rows, n_cl), or null
  float* next_bound;                 // (n_rows,), or null
};

// torch.maximum and clamp_min(., 0): NaN propagates.
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || b != b) ? a + b : (a > b ? a : b);
}

__device__ __forceinline__ float clamp0(float a) {
  return a != a ? a : (a < 0.0f ? 0.0f : a);
}

// One row's view of the scene: its apex and planes in registers.
struct Row {
  const SelectArgs* g;
  size_t r;
  float a[3];
  float n[4][3];
  bool ok;

  // culling.aabb_distance: the clamp, then the norm (sum3).
  __device__ float dist(int c) const {
    float x[3];
    for (int k = 0; k < 3; ++k) {
      const float lo = __ldg(g->bmin + 3 * c + k);
      const float hi = __ldg(g->bmax + 3 * c + k);
      x[k] = clamp0(max_nan(lo - a[k], a[k] - hi));
    }
    return sqrtf(dot3(x, x));
  }

  // culling.cull_units' p-vertex test: a plane rejects when (n . pvert)
  // (sum3) is < 0; then the cluster's valid flag.
  __device__ bool cull(int c) const {
    float pmin[3], pmax[3];
    for (int k = 0; k < 3; ++k) {
      pmin[k] = __ldg(g->bmin + 3 * c + k) - a[k];
      pmax[k] = __ldg(g->bmax + 3 * c + k) - a[k];
    }
    bool inside = true;
    for (int p = 0; p < 4; ++p) {
      float pv[3];
      for (int k = 0; k < 3; ++k) pv[k] = n[p][k] >= 0.0f ? pmax[k] : pmin[k];
      inside = inside && !(dot3(n[p], pv) < 0.0f);
    }
    return inside && __ldg(g->valid + c) != 0;
  }

  __device__ bool candidate(int c) const {
    if (!ok) return false;
    if (g->remaining != nullptr)
      return __ldg(g->remaining + r * g->n_cl + c) != 0;
    return cull(c);
  }

  // The sort key's high word: the distance's bits (distances are >= 0, so
  // their bits order as the floats), +inf for clusters not in the row,
  // one NaN for all NaN distances (a stable sort puts NaN last, in index
  // order).
  __device__ uint32_t key32(int c) const {
    if (!candidate(c)) return kInfBits;
    const float d = dist(c);
    return d != d ? kNanBits : __float_as_uint(d);
  }

  __device__ uint64_t key64(int c) const {
    return (static_cast<uint64_t>(key32(c)) << 32) |
           static_cast<uint32_t>(c);
  }
};

struct SelectShared {
  uint64_t list[kListCap];
  unsigned hist[256];
  int warp_sum[32];
  int n_list, n_finite, bin, rank, found;
  float bound;
};

// The (rank)-th smallest 64-bit key of the row (0-based): a radix select
// over the 32-bit high words, 8 bits a pass from the top, then the tie
// among equal high words resolved by index, in index order.
__device__ uint64_t key_of_rank(const Row& row, int rank, SelectShared& sh) {
  const int tid = threadIdx.x, nthr = blockDim.x;
  uint32_t prefix = 0, pmask = 0;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int i = tid; i < 256; i += nthr) sh.hist[i] = 0;
    __syncthreads();
    for (int c = tid; c < row.g->n_cl; c += nthr) {
      const uint32_t k = row.key32(c);
      if ((k & pmask) == prefix) atomicAdd(&sh.hist[(k >> shift) & 255u], 1u);
    }
    __syncthreads();
    if (tid < 32) {
      // Lane l holds bins 8l .. 8l + 7; the lane whose span holds the
      // rank finds the bin.
      unsigned own = 0;
      for (int j = 0; j < 8; ++j) own += sh.hist[8 * tid + j];
      unsigned incl = own;
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned v = __shfl_up_sync(0xffffffffu, incl, o);
        if (tid >= o) incl += v;
      }
      const unsigned excl = incl - own;
      if (excl <= static_cast<unsigned>(rank) &&
          static_cast<unsigned>(rank) < incl) {
        unsigned acc = excl;
        for (int j = 0; j < 8; ++j) {
          const unsigned h = sh.hist[8 * tid + j];
          if (acc + h > static_cast<unsigned>(rank)) {
            sh.bin = 8 * tid + j;
            sh.rank = rank - static_cast<int>(acc);
            break;
          }
          acc += h;
        }
      }
    }
    __syncthreads();
    prefix |= static_cast<uint32_t>(sh.bin) << shift;
    pmask |= 255u << shift;
    rank = sh.rank;
    __syncthreads();
  }
  // The rank-th cluster, in index order, of those whose high word is
  // `prefix`: a block-wide count of the matches, chunk by chunk.
  const int lane = tid & 31, warp = tid >> 5, nwarp = nthr >> 5;
  int before = 0;
  for (int c0 = 0; c0 < row.g->n_cl; c0 += nthr) {
    const int c = c0 + tid;
    const bool match = c < row.g->n_cl && row.key32(c) == prefix;
    const unsigned ballot = __ballot_sync(0xffffffffu, match);
    if (lane == 0) sh.warp_sum[warp] = __popc(ballot);
    __syncthreads();
    int offset = 0, total = 0;
    for (int w = 0; w < nwarp; ++w) {
      if (w < warp) offset += sh.warp_sum[w];
      total += sh.warp_sum[w];
    }
    if (match &&
        before + offset + __popc(ballot & ((1u << lane) - 1u)) == rank)
      sh.found = c;
    before += total;
    __syncthreads();
    if (before > rank) break;
  }
  return (static_cast<uint64_t>(prefix) << 32) |
         static_cast<uint32_t>(sh.found);
}

// Ascending bitonic sort of sh.list[0 .. n) padded to a power of two.
__device__ void sort_list(SelectShared& sh, int n) {
  const int tid = threadIdx.x, nthr = blockDim.x;
  int p = 1;
  while (p < n) p <<= 1;
  for (int i = n + tid; i < p; i += nthr) sh.list[i] = ~0ull;
  __syncthreads();
  for (int k = 2; k <= p; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < p; i += nthr) {
        const int l = i ^ j;
        if (l > i) {
          const uint64_t x = sh.list[i], y = sh.list[l];
          if ((x > y) == ((i & k) == 0)) {
            sh.list[i] = y;
            sh.list[l] = x;
          }
        }
      }
      __syncthreads();
    }
  }
}

__global__ void __launch_bounds__(256) cluster_select_kernel(SelectArgs g) {
  __shared__ SelectShared sh;
  const int tid = threadIdx.x, nthr = blockDim.x;
  Row row;
  row.g = &g;
  row.r = blockIdx.x;
  const size_t ai = row.r / g.rows_per_apex;
  for (int k = 0; k < 3; ++k) row.a[k] = g.apex[3 * ai + k];
  if (g.planes != nullptr)
    for (int p = 0; p < 4; ++p)
      for (int k = 0; k < 3; ++k) row.n[p][k] = g.planes[row.r * 12 + 3 * p + k];
  row.ok = g.row_valid == nullptr || g.row_valid[row.r] != 0;
  const size_t base = row.r * g.n_cl;

  if (g.hit != nullptr || g.any != nullptr) {
    bool seen = false;
    for (int c0 = 0; c0 < g.n_cl; c0 += nthr) {
      const int c = c0 + tid;
      const bool h = c < g.n_cl && row.candidate(c);
      if (g.hit != nullptr && c < g.n_cl) g.hit[base + c] = h;
      seen = __syncthreads_or(h) || seen;
      if (seen && g.hit == nullptr) break;
    }
    if (g.any != nullptr && tid == 0) g.any[row.r] = seen;
  }
  if (g.kc == 0) return;

  // Ranks [done, done + m) per chunk: the keys in [lo, hi), sorted.
  if (tid == 0) sh.n_finite = 0;
  uint64_t lo = 0, last = 0;
  for (int done = 0; done < g.kc; done += kListCap) {
    const int m = min(kListCap, g.kc - done);
    const uint64_t hi =
        done + m < g.n_cl ? key_of_rank(row, done + m, sh) : ~0ull;
    if (tid == 0) sh.n_list = 0;
    __syncthreads();
    for (int c = tid; c < g.n_cl; c += nthr) {
      const uint64_t k = row.key64(c);
      if (k >= lo && k < hi) sh.list[atomicAdd(&sh.n_list, 1)] = k;
    }
    __syncthreads();
    sort_list(sh, m);
    int finite = 0;
    for (int i = tid; i < m; i += nthr) {
      const uint64_t k = sh.list[i];
      const uint32_t hw = static_cast<uint32_t>(k >> 32);
      g.ccand[row.r * g.kc + done + i] = static_cast<int>(k & 0xffffffffu);
      g.centry[row.r * g.kc + done + i] = __uint_as_float(hw);
      finite += hw < kInfBits;
    }
    if (finite) atomicAdd(&sh.n_finite, finite);
    last = sh.list[m - 1];
    lo = hi;
    __syncthreads();
  }
  if (tid == 0) g.ccount[row.r] = sh.n_finite;
  if (g.new_rem == nullptr) return;

  // The window's rule: what stays is strictly after the kc-th selected
  // (distance, index) pair, or nothing when fewer than kc were selected;
  // the next bound is the nearest distance that stays.
  const uint32_t hw = static_cast<uint32_t>(last >> 32);
  const bool sel = hw < kInfBits;
  const float kd = sel ? __uint_as_float(hw) : __uint_as_float(kInfBits);
  const int ki = sel ? static_cast<int>(last & 0xffffffffu) : g.n_cl;
  float nearest = __uint_as_float(kInfBits);
  for (int c = tid; c < g.n_cl; c += nthr) {
    const float d = row.dist(c);
    const bool stays =
        row.candidate(c) && (d > kd || (d == kd && c > ki));
    g.new_rem[base + c] = stays;
    if (stays) nearest = fminf(nearest, d);
  }
  for (int o = 16; o > 0; o >>= 1)
    nearest = fminf(nearest, __shfl_xor_sync(0xffffffffu, nearest, o));
  if (tid == 0) sh.bound = __uint_as_float(kInfBits);
  __syncthreads();
  if ((tid & 31) == 0) atomicMin(reinterpret_cast<int*>(&sh.bound),
                                 __float_as_int(nearest));
  __syncthreads();
  if (tid == 0) g.next_bound[row.r] = sh.bound;
}

int select_threads(int n_cl) {
  int t = 32;
  while (t < n_cl && t < 256) t <<= 1;
  return t;
}

}  // namespace

extern "C" int rtmm_tile_frusta(const float* ivp, int n_frames, float width,
                                float height, float rw, float rh, int tx,
                                int tile0, int n_tiles, int nsub, int nrows,
                                const float* aabb, int pack, int raygen,
                                float* apex, float* normals, float* sub,
                                float* frus, void* stream) {
  if (n_frames < 0 || n_tiles < 0 || nsub < 1 || nsub > kMaxSub ||
      nrows < 1 || nsub % nrows != 0 || kTile % nrows != 0 ||
      kTile % (nsub / nrows) != 0 || tx < 1 ||
      (sub == nullptr && frus == nullptr) ||
      (frus != nullptr && (aabb == nullptr || pack < 3 + 12 * nsub + 6)))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = static_cast<long long>(n_frames) * n_tiles;
  if (rows == 0) return 0;
  FrustaArgs g{ivp,   width,    height, rw,   rh,     tx,     tile0,
               n_tiles, n_frames, nsub,   nrows, pack,   raygen, aabb,
               apex,  normals,  sub,    frus};
  const unsigned blocks =
      static_cast<unsigned>((rows + kFrustaTiles - 1) / kFrustaTiles);
  tile_frusta_kernel<<<blocks, dim3(kFrustaThreads, kFrustaTiles), 0,
                       static_cast<cudaStream_t>(stream)>>>(g);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rtmm_cluster_select(
    int n_rows, int n_cl, int kc, const float* apex, int rows_per_apex,
    const float* planes, const unsigned char* remaining,
    const unsigned char* row_valid, const float* bmin, const float* bmax,
    const unsigned char* valid, unsigned char* hit, unsigned char* any,
    int* ccand, int* ccount, float* centry, unsigned char* new_rem,
    float* next_bound, void* stream) {
  if (n_rows == 0) return 0;
  if (n_rows < 0 || n_cl < 1 || kc < 0 || kc > n_cl || rows_per_apex < 1 ||
      (remaining == nullptr && (planes == nullptr || valid == nullptr)) ||
      (kc > 0 && (ccand == nullptr || ccount == nullptr ||
                  centry == nullptr)) ||
      ((new_rem == nullptr) != (next_bound == nullptr)) ||
      (new_rem != nullptr && kc == 0))
    return static_cast<int>(cudaErrorInvalidValue);
  SelectArgs g{n_rows, n_cl,   kc,     apex,   rows_per_apex, planes,
               remaining, row_valid, bmin, bmax, valid,  hit,
               any,    ccand,  ccount, centry, new_rem, next_bound};
  cluster_select_kernel<<<n_rows, select_threads(n_cl), 0,
                          static_cast<cudaStream_t>(stream)>>>(g);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rtmm_prologue_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
