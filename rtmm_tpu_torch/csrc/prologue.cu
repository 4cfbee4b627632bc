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
// their order, each 3-term .sum(-1) whose value is kept as PyTorch's CUDA
// reduction sums it (sum3), and is built with -fmad=false and without
// fast math, so every output equals the plain version's on the card bit
// for bit; ties go to the lower cluster index, as a stable sort and top_k
// give them.
//
// What bounds them on an H100: tile_frusta writes ~0.56 KB per tile (the
// pack and the planes; ~37 MB for a 32-frame 1080p chunk) for ~1,000
// float32 operations: bytes. cluster_select culls with ~42 float32
// operations per (row, cluster) and writes 8 bytes per list slot (a
// window also reads and writes a (row, cluster) mask): operations for a
// cull of many clusters, bytes for long lists.
//
// The design. A cluster's sort key, (distance bits, index), depends on
// the apex and the cluster only, and every row of a frame shares one
// apex; so cluster_select orders each apex's clusters once and every row
// takes its held clusters in that order:
// - select_warp (C <= 32): a warp per run of rows (up to 8, fewer when
//   rows are few); it sorts its apex's keys across its lanes (bitonic,
//   shuffles) when the apex changes, then per row one ballot of the held
//   mask places every list entry; the next row's planes load meanwhile.
// - select_block (32 < C <= kSortCap): a block per run of one apex's
//   rows; the block computes the C distances once into shared memory and
//   orders them, by a rank count up to 256 clusters, else by a stable LSD
//   radix sort (4 passes of 8 bits; shared atomics count a warp's digits,
//   __match_any_sync ranks them); then a
//   warp per row keeps the row's held mask as bits (a remaining row read
//   as 16-byte words), walks the order until it has its kc finite
//   entries, fills the tail (+inf keys, then NaN keys, each in index
//   order) by ballots, and, for a window, writes the cleared mask a
//   4-byte word a lane from the distances on chip.
// - select_radix (C > kSortCap, past shared memory): a block per row; the
//   kc-th (distance, index) key by a radix select over recomputed keys,
//   the selected keys sorted in shared memory (bitonic, kListCap at a
//   time): no cap on C.
// - cull (kc = 0: the hit and any-hit forms): C <= 32, lanes in groups of
//   C rounded up to a power of two, several rows a warp; else a block per
//   (16 rows, 2,048 clusters; all clusters when the any-hit is asked for),
//   each tile of 512 boxes staged in shared memory once for the 16 rows,
//   a warp stopping its plane tests once every lane is out.
// tile_frusta runs a block per (frame, group of up to 8 x 4 tiles, the
// largest that still gives two blocks per SM): the group's corner pixels
// form one lattice whose directions are computed once (a corner is a
// pixel of up to four tiles, the same integer pixel, so the same
// direction bits), the apex once per block, then a warp per tile makes
// its planes and writes its pack row, and the block writes its other
// tile rows as contiguous float4 spans.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTile = 32;
constexpr int kMaxSub = 8;
constexpr uint32_t kInfBits = 0x7f800000u;
constexpr uint32_t kNanBits = 0x7fc00000u;
constexpr unsigned kFull = 0xffffffffu;
// The plain version's Python-scalar constants, as PyTorch casts them to
// float32 before the operation.
constexpr float kDenTiny = static_cast<float>(1e-12);

// ---------------------------------------------------------------------
// tile_frusta

constexpr int kGroupX = 8, kGroupY = 4;  // the largest tile group a block takes
constexpr int kGroupTiles = kGroupX * kGroupY;
constexpr int kFrustaThreads = 256;      // the most threads a block has
// The largest corner lattice of a block: (8 ncols + 1)(4 nrows + 1) over
// the sub-grids ncols x nrows <= 8 (8 x 1: 65 x 5).
constexpr int kMaxLattice = 325;
constexpr int kMaxPack = 128;  // frustum_pack_len(8, raygen)

struct FrustaArgs {
  const float* ivp;  // (F, 4, 4) row-major
  float width, height, rw, rh;  // the NDC size, the padded size
  int tx, tile0, n_tiles, n_frames, nsub, nrows, pack, raygen;
  int trow0, n_trows;  // the tile rows the range spans
  int gw, gh, ngx;     // a block's tile group; groups per tile row
  const float* aabb;   // (6,) scene exit box, for the pack
  float* apex;         // (F, 3)
  float* normals;      // (F, n_tiles, 4, 3)
  float* sub;          // (F, n_tiles, nsub, 4, 3) or null (in the pack)
  float* frus;         // (F, n_tiles, pack) or null
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

__global__ void __launch_bounds__(kFrustaThreads)
    tile_frusta_kernel(FrustaArgs g) {
  __shared__ float s_dir[kMaxLattice][3];
  __shared__ float s_plane[kGroupTiles][(kMaxSub + 1) * 12];
  // The pack row's values that do not depend on the tile: the apex, the
  // inverse view-projection, the scene box, zeros.
  __shared__ float s_tpl[kMaxPack];
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarp = nthr >> 5;
  const int f = blockIdx.y;
  const int gx = blockIdx.x % g.ngx, gy = blockIdx.x / g.ngx;
  const int tx0 = gx * g.gw, ty0 = g.trow0 + gy * g.gh;
  const int kx = min(g.gw, g.tx - tx0);
  const int ky = min(g.gh, g.trow0 + g.n_trows - ty0);
  const int ncols = g.nsub / g.nrows;
  const int sw = kTile / ncols, sh = kTile / g.nrows;
  const int lw = kx * ncols + 1, lh = ky * g.nrows + 1;
  const int rg = 3 + 12 * g.nsub;  // the pack's raygen scalars start here
  const int box = rg + (g.raygen ? 18 : 0);
  const float* m = g.ivp + 16 * f;
  if (g.frus != nullptr)
    for (int i = 3 + tid; i < g.pack; i += nthr) {
      float v = 0.0f;
      if (g.raygen && i >= rg + 2 && i < rg + 18)
        v = m[i - rg - 2];
      else if (i >= box && i < box + 6)
        v = g.aabb[i - box];
      s_tpl[i] = v;
    }
  if (tid == nthr - 1) {
    float a[3];
    frame_apex(m, g.width, g.height, g.rw, g.rh, a);
    for (int k = 0; k < 3; ++k) s_tpl[k] = a[k];
  }
  // The lattice's corners: corner (R, Q) is pixel (32 tx0 + Q sw, 32 ty0
  // + R sh), the integer pixel of corner (R % nrows, Q % ncols) of its
  // tile (and of the neighbour's far corner): its NDC and the unit
  // direction unproject(1) - unproject(0).
  for (int i = tid; i < lw * lh; i += nthr) {
    const int r = i / lw, q = i % lw;
    const float px = static_cast<float>(tx0 * kTile + q * sw);
    const float py = static_cast<float>(ty0 * kTile + r * sh);
    const float ndc_x = (px / g.width) * 2.0f - 1.0f;
    const float ndc_y = -((py / g.height) * 2.0f - 1.0f);
    float pf[3], pn[3], d[3];
    unproject(m, ndc_x, ndc_y, 1.0f, pf);
    unproject(m, ndc_x, ndc_y, 0.0f, pn);
    for (int k = 0; k < 3; ++k) d[k] = pf[k] - pn[k];
    const float len = sqrtf(dot3(d, d));
    for (int k = 0; k < 3; ++k) s_dir[i][k] = d[k] / len;
  }
  __syncthreads();
  // A warp per tile, a lane per (cone, plane): cones 0 .. nsub - 1 the
  // sub-cones (row-major in the tile's grid), cone nsub the tile's own
  // cone, the grid's outer corners.
  const int per_tile = (g.nsub + 1) * 4;
  for (int lt = warp; lt < kx * ky; lt += nwarp) {
    const int lx = lt % kx, ly = lt / kx;
    const int base = ly * g.nrows * lw + lx * ncols;
    for (int i = lane; i < per_tile; i += 32) {
      const int j = i >> 2, k = i & 3;
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
      float n[3];
      cone_plane(s_dir[base + r0 * lw + c0], s_dir[base + r0 * lw + c1],
                 s_dir[base + r1 * lw + c1], s_dir[base + r1 * lw + c0], k,
                 n);
      for (int q = 0; q < 3; ++q) s_plane[lt][12 * j + 3 * k + q] = n[q];
    }
  }
  __syncthreads();
  // Each tile row of the block holds consecutive flat tiles, so its rows
  // of every output are one contiguous span: consecutive threads store
  // consecutive float4s of it (a warp a pack row).
  const int end = g.tile0 + g.n_tiles;
  for (int ly = 0; ly < ky; ++ly) {
    const int row0 = (ty0 + ly) * g.tx + tx0;
    const int t_a = max(row0, g.tile0), t_b = min(row0 + kx, end);
    if (t_a >= t_b) continue;
    const int nt = t_b - t_a, lt0 = ly * kx + (t_a - row0);
    const size_t trow = static_cast<size_t>(f) * g.n_tiles + (t_a - g.tile0);
    if (t_a == g.tile0 && tid < 3) g.apex[3 * f + tid] = s_tpl[tid];
    float4* nrm = reinterpret_cast<float4*>(g.normals + trow * 12);
    for (int i = tid; i < nt * 3; i += nthr) {
      const float* src = s_plane[lt0 + i / 3] + 12 * g.nsub + 4 * (i % 3);
      nrm[i] = make_float4(src[0], src[1], src[2], src[3]);
    }
    if (g.sub != nullptr) {
      const int q4 = 3 * g.nsub;  // float4s per tile
      float4* out = reinterpret_cast<float4*>(g.sub + trow * 12 * g.nsub);
      for (int i = tid; i < nt * q4; i += nthr) {
        const float* src = s_plane[lt0 + i / q4] + 4 * (i % q4);
        out[i] = make_float4(src[0], src[1], src[2], src[3]);
      }
    }
    if (g.frus != nullptr)
      for (int t = warp; t < nt; t += nwarp) {
        // [apex, sub-cone planes, (raygen: the tile's pixel origin, the
        // inverse view-projection), the scene box, zeros]
        const int tile = t_a + t;
        const float* planes = s_plane[lt0 + t];
        const float px0 = static_cast<float>((tile % g.tx) * kTile);
        const float py0 = static_cast<float>((tile / g.tx) * kTile);
        float4* out = reinterpret_cast<float4*>(
            g.frus + (trow + t) * static_cast<size_t>(g.pack));
        for (int e = lane; e < g.pack / 4; e += 32) {
          float v[4];
          for (int j = 0; j < 4; ++j) {
            const int i = 4 * e + j;
            v[j] = i >= 3 && i < rg ? planes[i - 3] : s_tpl[i];
            if (g.raygen && i == rg) v[j] = px0;
            if (g.raygen && i == rg + 1) v[j] = py0;
          }
          out[e] = make_float4(v[0], v[1], v[2], v[3]);
        }
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

// culling.aabb_distance of apex a to box [lo, hi]: the clamp, then the
// norm (sum3). Never -0: sum3 turns a zero sum into +0.
__device__ __forceinline__ float box_distance(const float a[3],
                                              const float lo[3],
                                              const float hi[3]) {
  float x[3];
  for (int k = 0; k < 3; ++k) x[k] = clamp0(max_nan(lo[k] - a[k], a[k] - hi[k]));
  return sqrtf(dot3(x, x));
}

// A distance's sort key: its bits (distances are +0 or more, so their bits
// order as the floats), one NaN key for every NaN (a stable sort puts NaN
// after +inf, in index order).
__device__ __forceinline__ uint32_t sort_key(uint32_t bits) {
  return bits > kInfBits ? kNanBits : bits;
}

__device__ __forceinline__ unsigned lanes_below(int lane) {
  return (1u << lane) - 1u;
}

// One row's view of the scene: its apex and planes in registers.
struct Row {
  float a[3];
  float n[4][3];
  bool ok;

  __device__ void load(const SelectArgs& g, int r) {
    const int ai = r / g.rows_per_apex;  // 32-bit: rows fit an int
    for (int k = 0; k < 3; ++k) a[k] = g.apex[3 * ai + k];
    if (g.planes != nullptr) {
      // 16-byte aligned: the wrapper hands planes over so (12 floats a row).
      const float4* p =
          reinterpret_cast<const float4*>(g.planes + 12LL * r);
      const float4 q0 = p[0], q1 = p[1], q2 = p[2];
      const float v[12] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y,
                           q1.z, q1.w, q2.x, q2.y, q2.z, q2.w};
      for (int i = 0; i < 12; ++i) n[i / 3][i % 3] = v[i];
    }
    ok = g.row_valid == nullptr || g.row_valid[r] != 0;
  }

  // culling.cull_units' p-vertex test of box [lo, hi] for the lanes that
  // are `live`: a plane rejects when (n . pvert) is < 0, as the plain
  // version's sum3 gives it. Whether a sum is < 0 does not depend on
  // sum3's zeros (they change only a zero's sign), so (x0 + x2) + x1
  // decides the same. With kStop (a warp calls it together) the warp
  // stops once no lane is inside.
  template <bool kStop = true>
  __device__ bool cull(bool live, const float lo[3], const float hi[3]) const {
    float pmin[3], pmax[3];
    for (int k = 0; k < 3; ++k) {
      pmin[k] = lo[k] - a[k];
      pmax[k] = hi[k] - a[k];
    }
    bool inside = live;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      if (kStop && !__any_sync(kFull, inside)) break;
      float pv[3];
      for (int k = 0; k < 3; ++k) pv[k] = n[p][k] >= 0.0f ? pmax[k] : pmin[k];
      const float s = (n[p][0] * pv[0] + n[p][2] * pv[2]) + n[p][1] * pv[1];
      inside = inside && !(s < 0.0f);
    }
    return inside;
  }

  // Whether row r holds cluster c (c < n_cl on the live lanes; every lane
  // of the warp calls it): culled in and valid, or its remaining byte.
  __device__ bool held(const SelectArgs& g, long long r, int c,
                       bool live) const {
    live = live && ok;
    if (g.remaining != nullptr)
      return live && __ldg(g.remaining + r * g.n_cl + c) != 0;
    float lo[3] = {0.0f, 0.0f, 0.0f}, hi[3] = {0.0f, 0.0f, 0.0f};
    if (live)
      for (int k = 0; k < 3; ++k) {
        lo[k] = __ldg(g.bmin + 3 * c + k);
        hi[k] = __ldg(g.bmax + 3 * c + k);
      }
    return cull(live, lo, hi) && __ldg(g.valid + c) != 0;
  }
};

// ---- cull (kc = 0) ---------------------------------------------------

// C <= 32: lanes in groups of cp (C rounded up to a power of two), a group
// per row, 32 / cp rows a warp.
__global__ void __launch_bounds__(256) cull_small_kernel(SelectArgs g, int cp) {
  const int lane = threadIdx.x & 31;
  const int warp_id = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int r = warp_id * (32 / cp) + lane / cp;
  const int c = lane & (cp - 1);
  const bool live = r < g.n_rows;
  Row row = {};
  if (live) row.load(g, r);
  const bool h = row.held(g, r, c, live && c < g.n_cl);
  if (g.hit != nullptr && live && c < g.n_cl)
    g.hit[static_cast<long long>(r) * g.n_cl + c] = h;
  const unsigned group =
      (cp == 32 ? kFull : (1u << cp) - 1u) << (lane & ~(cp - 1));
  const unsigned b = __ballot_sync(kFull, h);
  if (g.any != nullptr && live && c == 0) g.any[r] = (b & group) != 0u;
}

// C > 32: a block per (16 rows, a segment of the clusters), a warp per
// two rows. Each tile of 512 boxes is staged in shared memory once for the
// block's rows, with the tile's bounding box; a row whose planes put the
// bounding box outside skips the tile: every box in it is outside too,
// since a rounded product by a fixed normal, a rounded difference and a
// rounded sum are each monotone, so a box's (n . pvert) is at most its
// bounding box's (a NaN coordinate in the tile turns the skip off).
constexpr int kCullRows = 16;
constexpr int kCullThreads = 256;
constexpr int kCullWarps = kCullThreads / 32;
constexpr int kBoxTile = 512;
constexpr int kCullSegment = 2048;  // clusters per block when no any-hit

__global__ void __launch_bounds__(kCullThreads)
    cull_kernel(SelectArgs g, int seg) {
  __shared__ float s_lo[kBoxTile * 3], s_hi[kBoxTile * 3];
  __shared__ unsigned char s_valid[kBoxTile];
  __shared__ float s_ulo[3], s_uhi[3];
  __shared__ int s_unan;
  __shared__ int s_seen[kCullRows];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = blockIdx.x * kCullRows;
  const int nr = min(kCullRows, g.n_rows - r0);
  const int c_begin = blockIdx.y * seg;
  const int c_end = min(g.n_cl, c_begin + seg);
  const bool any_only = g.hit == nullptr;
  constexpr int kMine = kCullRows / kCullWarps;  // rows of a warp
  Row rows[kMine];
  for (int j = 0; j < kMine; ++j) {
    const int rr = warp + kCullWarps * j;
    rows[j] = Row{};
    if (rr < nr) rows[j].load(g, r0 + rr);
  }
  if (tid < kCullRows) s_seen[tid] = 0;
  for (int c0 = c_begin; c0 < c_end; c0 += kBoxTile) {
    // The any-hit form ends once every row of the block has seen one.
    if (any_only) {
      bool open = false;
      for (int j = 0; j < kMine; ++j) {
        const int rr = warp + kCullWarps * j;
        open = open || (rr < nr && rows[j].ok && !s_seen[rr]);
      }
      if (!__syncthreads_or(open && lane == 0)) break;
    }
    const int n = min(kBoxTile, c_end - c0);
    __syncthreads();
    if (g.remaining == nullptr) {
      for (int i = tid; i < 3 * n; i += kCullThreads) {
        s_lo[i] = g.bmin[3 * c0 + i];
        s_hi[i] = g.bmax[3 * c0 + i];
      }
      for (int i = tid; i < n; i += kCullThreads) s_valid[i] = g.valid[c0 + i];
      __syncthreads();
      if (warp == 0) {
        // The tile's bounding box, and whether a coordinate is NaN.
        float lo[3], hi[3];
        bool nan = false;
        for (int k = 0; k < 3; ++k) {
          lo[k] = __uint_as_float(kInfBits);
          hi[k] = -__uint_as_float(kInfBits);
        }
        for (int i = lane; i < n; i += 32)
          for (int k = 0; k < 3; ++k) {
            const float l = s_lo[3 * i + k], h = s_hi[3 * i + k];
            nan = nan || l != l || h != h;
            lo[k] = fminf(lo[k], l);
            hi[k] = fmaxf(hi[k], h);
          }
        for (int o = 16; o > 0; o >>= 1)
          for (int k = 0; k < 3; ++k) {
            lo[k] = fminf(lo[k], __shfl_xor_sync(kFull, lo[k], o));
            hi[k] = fmaxf(hi[k], __shfl_xor_sync(kFull, hi[k], o));
          }
        nan = __any_sync(kFull, nan);
        if (lane == 0) {
          for (int k = 0; k < 3; ++k) {
            s_ulo[k] = lo[k];
            s_uhi[k] = hi[k];
          }
          s_unan = nan;
        }
      }
    }
    __syncthreads();
    for (int j = 0; j < kMine; ++j) {
      const int rr = warp + kCullWarps * j;
      if (rr >= nr || (any_only && s_seen[rr])) continue;
      const long long r = r0 + rr;
      const Row& row = rows[j];
      bool skip = !row.ok;
      if (g.remaining == nullptr && !skip && !s_unan) {
        const float ulo[3] = {s_ulo[0], s_ulo[1], s_ulo[2]};
        const float uhi[3] = {s_uhi[0], s_uhi[1], s_uhi[2]};
        skip = !__any_sync(kFull, row.cull(true, ulo, uhi));
      }
      bool seen = false;
      for (int i0 = 0; i0 < n; i0 += 32) {
        const int i = i0 + lane;
        const bool in = i < n;
        bool h = false;
        if (skip) {
          h = false;
        } else if (g.remaining != nullptr) {
          h = in && g.remaining[r * g.n_cl + c0 + i] != 0;
        } else {
          float lo[3] = {0.0f, 0.0f, 0.0f}, hi[3] = {0.0f, 0.0f, 0.0f};
          if (in)
            for (int k = 0; k < 3; ++k) {
              lo[k] = s_lo[3 * i + k];
              hi[k] = s_hi[3 * i + k];
            }
          h = row.cull(in, lo, hi) && s_valid[i] != 0;
        }
        if (g.hit != nullptr && in) g.hit[r * g.n_cl + c0 + i] = h;
        seen = seen || h;
      }
      if (g.any != nullptr && __any_sync(kFull, seen) && lane == 0)
        s_seen[rr] = 1;
    }
  }
  __syncthreads();
  if (g.any != nullptr && tid < nr) g.any[r0 + tid] = s_seen[tid] != 0;
}

// ---- one row's list from its apex's order ------------------------------

// The list of row r, which holds `nhf` clusters at a finite distance,
// given its held mask by cluster index (held(c)) and its apex's order:
// the held finite clusters first in (distance, index) order (walking the
// order's finite prefix: cluster ord(p) at position p < nfin, its distance
// bits entry(p)), then the +inf keys (a cluster not held, or held at +inf)
// and then the NaN keys (held at NaN), each in index order; ccount the
// finite ones among the first kc. For a window: the clusters held strictly
// after the kc-th selected (distance, index) pair (none when fewer were
// selected), written 4 to a word, and their nearest distance. A warp calls
// it together; key(c) is cluster c's distance bits; ord(p) and entry(p)
// are asked for p = p0 + lane only.
template <int kUnroll, class Held, class Ord, class Entry, class Key>
__device__ void row_list(const SelectArgs& g, long long r, int lane, int nhf,
                         int nfin, Held held, Ord ord, Entry entry, Key key) {
  const int n = g.n_cl, kc = g.kc;
  int* ccand = g.ccand + r * kc;
  float* centry = g.centry + r * kc;
  const int want = min(nhf, kc);
  int got = 0;
  uint32_t kth_key = kInfBits;
  int kth_c = n;
  for (int p0 = 0; got < want && p0 < nfin; p0 += 32 * kUnroll) {
    // kUnroll chunks of the order at a time.
    int c[kUnroll];
    bool sel[kUnroll];
    unsigned bal[kUnroll];
    for (int u = 0; u < kUnroll; ++u) {
      const int p = p0 + 32 * u + lane;
      c[u] = p < nfin ? ord(p) : 0;
      sel[u] = p < nfin && held(c[u]);
    }
    for (int u = 0; u < kUnroll; ++u) bal[u] = __ballot_sync(kFull, sel[u]);
    for (int u = 0; u < kUnroll; ++u) {
      const int pos = got + __popc(bal[u] & lanes_below(lane));
      if (sel[u] && pos < kc) {
        const uint32_t k = entry(p0 + 32 * u + lane);
        ccand[pos] = c[u];
        centry[pos] = __uint_as_float(k);
        if (pos == kc - 1) {
          kth_key = k;
          kth_c = c[u];
        }
      }
      got += __popc(bal[u]);
    }
  }
  int filled = want;
  for (int c0 = 0; c0 < n && filled < kc; c0 += 32) {
    const int c = c0 + lane;
    const bool t = c < n && (!held(c) || key(c) == kInfBits);
    const unsigned bal = __ballot_sync(kFull, t);
    const int pos = filled + __popc(bal & lanes_below(lane));
    if (t && pos < kc) {
      ccand[pos] = c;
      centry[pos] = __uint_as_float(kInfBits);
    }
    filled += __popc(bal);
  }
  for (int c0 = 0; c0 < n && filled < kc; c0 += 32) {
    const int c = c0 + lane;
    const bool t = c < n && held(c) && key(c) > kInfBits;
    const unsigned bal = __ballot_sync(kFull, t);
    const int pos = filled + __popc(bal & lanes_below(lane));
    if (t && pos < kc) {
      ccand[pos] = c;
      centry[pos] = __uint_as_float(key(c));
    }
    filled += __popc(bal);
  }
  if (lane == 0) g.ccount[r] = want;
  if (g.new_rem == nullptr) return;
  // The kc-th selected pair, from the lane that placed it.
  const unsigned has = __ballot_sync(kFull, kth_c < n);
  float kd = __uint_as_float(kInfBits);
  int ki = n;
  if (has != 0u) {
    const int src = __ffs(has) - 1;
    kd = __uint_as_float(__shfl_sync(kFull, kth_key, src));
    ki = __shfl_sync(kFull, kth_c, src);
  }
  // The row's bytes as aligned words, 128 clusters a step (a lane a
  // cluster of each 32, four ballots; then lane l stores word l): a word
  // wholly in the row is stored, one shared with a neighbouring row has
  // only this row's bytes changed.
  const uintptr_t addr = reinterpret_cast<uintptr_t>(g.new_rem + r * n);
  const int e = static_cast<int>(addr & 3u);
  uint32_t* out = reinterpret_cast<uint32_t*>(addr - e);
  float nearest = __uint_as_float(kInfBits);
  for (int c0 = -e; c0 < n; c0 += 128) {
    // The held clusters first; the keys only where the step holds one.
    bool h[4];
    for (int u = 0; u < 4; ++u) {
      const int c = c0 + 32 * u + lane;
      h[u] = c >= 0 && c < n && held(c);
    }
    unsigned bal[4] = {0u, 0u, 0u, 0u};
    if (__any_sync(kFull, h[0] || h[1] || h[2] || h[3]))
      for (int u = 0; u < 4; ++u) {
        const int c = c0 + 32 * u + lane;
        bool stays = false;
        if (h[u]) {
          const float d = __uint_as_float(key(c));
          stays = d > kd || (d == kd && c > ki);
          if (stays) nearest = fminf(nearest, d);
        }
        bal[u] = __ballot_sync(kFull, stays);
      }
    const int q = lane >> 3;  // the ballot of this lane's word
    const unsigned b = (q == 0 ? bal[0] : q == 1 ? bal[1] : q == 2 ? bal[2]
                                                               : bal[3]) >>
                       (4 * (lane & 7));
    uint32_t word = 0u, mask = 0u;
    for (int j = 0; j < 4; ++j) {
      const int cj = c0 + 4 * lane + j;
      if (cj < 0 || cj >= n) continue;
      mask |= 0xffu << (8 * j);
      word |= ((b >> j) & 1u) << (8 * j);
    }
    uint32_t* w = out + (c0 + e) / 4 + lane;
    if (mask == kFull) {
      *w = word;
    } else if (mask != 0u) {
      atomicAnd(w, ~mask);
      atomicOr(w, word);
    }
  }
  for (int o = 16; o > 0; o >>= 1)
    nearest = fminf(nearest, __shfl_xor_sync(kFull, nearest, o));
  if (lane == 0) g.next_bound[r] = nearest;
}

// ---- select_warp (C <= 32) -------------------------------------------

constexpr int kWarpSelectWarps = 8;

__global__ void __launch_bounds__(kWarpSelectWarps * 32)
    select_warp_kernel(SelectArgs g, int rows_per_warp) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = (blockIdx.x * kWarpSelectWarps + warp) * rows_per_warp;
  const int r1 = min(r0 + rows_per_warp, g.n_rows);
  __shared__ uint32_t s_kraw[kWarpSelectWarps][32];
  const int n = g.n_cl;
  const bool mine = lane < n;  // lane c holds cluster c
  // The lane's cluster: its box and valid flag, for every row.
  float blo[3], bhi[3];
  for (int k = 0; k < 3; ++k) {
    blo[k] = mine ? __ldg(g.bmin + 3 * lane + k) : 0.0f;
    bhi[k] = mine ? __ldg(g.bmax + 3 * lane + k) : 0.0f;
  }
  const bool bvalid = mine && (g.valid == nullptr || g.valid[lane] != 0);
  int cur = -1;
  uint32_t kraw = kInfBits;  // cluster `lane`'s distance bits
  uint64_t skey = ~0ull;     // the apex's order: lane p holds position p
  int nfin = 0;
  Row next;
  if (r0 < r1) next.load(g, r0);
  int ai = r0 / g.rows_per_apex, left = g.rows_per_apex - r0 % g.rows_per_apex;
  for (int r = r0; r < r1; ++r, --left) {
    const Row row = next;
    if (r + 1 < r1) next.load(g, r + 1);  // in flight while this row runs
    if (left == 0) {
      ++ai;
      left = g.rows_per_apex;
    }
    if (ai != cur) {
      cur = ai;
      kraw = mine ? __float_as_uint(box_distance(row.a, blo, bhi)) : kInfBits;
      __syncwarp();
      s_kraw[warp][lane] = kraw;
      __syncwarp();
      skey = mine ? (static_cast<uint64_t>(sort_key(kraw)) << 32) |
                        static_cast<uint32_t>(lane)
                  : ~0ull;
      // Bitonic sort of the 32 keys across the lanes, ascending.
      for (int k = 2; k <= 32; k <<= 1)
        for (int j = k >> 1; j > 0; j >>= 1) {
          const uint64_t o = __shfl_xor_sync(kFull, skey, j);
          const bool keep_min = ((lane & j) == 0) == ((lane & k) == 0);
          skey = keep_min ? (o < skey ? o : skey) : (o > skey ? o : skey);
        }
      nfin = __popc(__ballot_sync(kFull, (skey >> 32) < kInfBits));
    }
    bool h = mine && row.ok;
    const long long rn = static_cast<long long>(r) * n;
    if (g.remaining != nullptr)
      h = h && __ldg(g.remaining + rn + lane) != 0;
    else
      h = h && bvalid && row.cull<false>(true, blo, bhi);
    if (g.hit != nullptr && mine) g.hit[rn + lane] = h;
    const unsigned hb = __ballot_sync(kFull, h);
    if (g.any != nullptr && lane == 0) g.any[r] = hb != 0u;
    const int nhf = __popc(__ballot_sync(kFull, h && kraw < kInfBits));
    // With C <= 32 a list position p = p0 + lane is the lane's own.
    const int ord_lane = static_cast<int>(skey & 0xffffffffu);
    const uint32_t entry_lane = static_cast<uint32_t>(skey >> 32);
    row_list<1>(
        g, r, lane, nhf, nfin,
        [&](int c) { return ((hb >> c) & 1u) != 0u; },
        [&](int) { return ord_lane; }, [&](int) { return entry_lane; },
        [&](int c) { return s_kraw[warp][c]; });
  }
}

// ---- select_block (32 < C <= kSortCap) ---------------------------------

// A block of kWarps warps: 16 where a rank count orders (C up to 256), 32
// for the radix sort, whose passes then run over half as many chunks a
// warp; a warp per row.
constexpr int kRankSortMax = 256;  // C up to which a rank count orders
constexpr int kRankWarps = 16, kRadixWarps = 32;
constexpr int kBlockRowsMax = 64;  // rows a block takes, at most
constexpr int kRadixBins = 256;
constexpr int kHistStride = kRadixBins + 1;  // a warp's histogram, padded
// Dynamic shared memory of a block over n clusters, 4-byte words: per
// cluster its distance bits, its place in the order and the radix scratch
// (later the rows' held bits, at least a warp's worth each), a bit of the
// finite keys' array; and the per-warp radix histograms. The opt-in limit
// is 227 KB a block, less the static arrays.
constexpr int kMaxDynSmem = 232448 - 8192;

__host__ __device__ constexpr int block_warps(int n) {
  return n <= kRankSortMax ? kRankWarps : kRadixWarps;
}

__host__ __device__ constexpr int block_smem(int n) {
  const int nf = (n + 31) / 32, w = block_warps(n);
  const int tmp = n > w * (nf + 2) ? n : w * (nf + 2);
  return 4 * (2 * n + nf + tmp + (n > kRankSortMax ? kHistStride * w : 0));
}

constexpr int sort_cap() {
  int n = kMaxDynSmem / 12;
  while (block_smem(n) > kMaxDynSmem) --n;
  return n;
}

constexpr int kSortCap = sort_cap();

// The histogram word of (digit, warp): warp-major, each warp's 256 bins
// padded to 257 words, so a warp's lanes on different digits use
// different banks.
__device__ __forceinline__ int hist_at(unsigned digit, int warp) {
  return warp * kHistStride + static_cast<int>(digit);
}

// Exclusive prefix sum of the histograms in place, in (digit, warp)
// order, by the block: thread t takes that order's entries 8t .. 8t + 7.
template <int kWarps>
__device__ void block_scan(uint32_t* s, uint32_t* warp_sum) {
  constexpr int per = kRadixBins / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  uint32_t v[per], sum = 0;
  for (int j = 0; j < per; ++j) {
    const int o = tid * per + j;  // = digit * kWarps + warp
    v[j] = s[hist_at(o / kWarps, o % kWarps)];
    sum += v[j];
  }
  uint32_t incl = sum;
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    uint32_t x = lane < kWarps ? warp_sum[lane] : 0u;
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t y = __shfl_up_sync(kFull, x, o);
      if (lane >= o) x += y;
    }
    if (lane < kWarps) warp_sum[lane] = x;
  }
  __syncthreads();
  uint32_t base = (warp > 0 ? warp_sum[warp - 1] : 0u) + incl - sum;
  for (int j = 0; j < per; ++j) {
    const int o = tid * per + j;
    s[hist_at(o / kWarps, o % kWarps)] = base;
    base += v[j];
  }
  __syncthreads();
}

// Stable LSD radix sort of the cluster indices ord[0 .. n) by
// sort_key(key[c]), 8 bits a pass (the keys are below 2^31): warp w owns a
// contiguous segment of each pass's input, so equal digits keep their
// order across warps; a warp's digits are counted with shared atomics
// into its own histogram and ranked among its lanes by
// __match_any_sync, two chunks of 32 at a time. Four passes leave the
// result in ord.
template <int kWarps>
__device__ void radix_sort(const uint32_t* key, uint32_t* ord, uint32_t* tmp,
                           uint32_t* hist, uint32_t* warp_sum, int n) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int seg = (n + kWarps - 1) / kWarps;
  const int lo = min(n, warp * seg), hi = min(n, lo + seg);
  uint32_t* src = ord;
  uint32_t* dst = tmp;
  for (int shift = 0; shift < 32; shift += 8) {
    for (int i = lane; i < kRadixBins; i += 32) hist[hist_at(i, warp)] = 0;
    __syncwarp();
    for (int i = lo + lane; i < hi; i += 32)
      atomicAdd(hist + hist_at((sort_key(key[src[i]]) >> shift) & 255u, warp),
                1u);
    __syncthreads();
    block_scan<kWarps>(hist, warp_sum);
    for (int i0 = lo; i0 < hi; i0 += 64) {
      uint32_t c[2];
      unsigned digit[2], peers[2];
      bool live[2];
      for (int u = 0; u < 2; ++u) {
        const int i = i0 + 32 * u + lane;
        live[u] = i < hi;
        c[u] = live[u] ? src[i] : 0u;
        digit[u] = live[u] ? (sort_key(key[c[u]]) >> shift) & 255u : 0u;
      }
      for (int u = 0; u < 2; ++u)
        peers[u] = __match_any_sync(kFull, live[u] ? digit[u] : 256u);
      for (int u = 0; u < 2; ++u) {
        uint32_t* slot = hist + hist_at(digit[u], warp);
        if (live[u]) dst[*slot + __popc(peers[u] & lanes_below(lane))] = c[u];
        __syncwarp();
        if (live[u] && lane == __ffs(peers[u]) - 1) *slot += __popc(peers[u]);
        __syncwarp();
      }
    }
    __syncthreads();
    uint32_t* t = src;
    src = dst;
    dst = t;
  }
}

// 32 bits of the bit array f (nf words, zero past them) from bit `start`
// on; start may be negative.
__device__ __forceinline__ uint32_t bits_at(const uint32_t* f, int nf,
                                            int start) {
  const int w = start >> 5, s = start & 31;
  const uint32_t lo = w >= 0 && w < nf ? f[w] : 0u;
  const uint32_t hi = w + 1 >= 0 && w + 1 < nf ? f[w + 1] : 0u;
  return s ? (lo >> s) | (hi << (32 - s)) : lo;
}

// Four bool bytes of a word as four bits.
__device__ __forceinline__ uint32_t nibble(uint32_t w) {
  return (w | (w >> 7) | (w >> 14) | (w >> 21)) & 0xfu;
}

template <int kWarps>
__global__ void __launch_bounds__(32 * kWarps)
    select_block_kernel(SelectArgs g, int rows_per_block) {
  constexpr int kThreads = 32 * kWarps;
  extern __shared__ uint32_t s_dyn[];
  __shared__ uint32_t s_warp_sum[32];
  __shared__ float s_n[kBlockRowsMax][12];
  __shared__ int s_ok[kBlockRowsMax];
  __shared__ int s_nfin;
  const int n = g.n_cl;
  const int nf = (n + 31) / 32;              // words of a bit array
  const int hw = nf + 2;                     // a warp's held bits
  uint32_t* s_key = s_dyn;                   // distance bits by cluster
  uint32_t* s_ord = s_key + n;               // the apex's order
  uint32_t* s_fin = s_ord + n;               // finite distances' bits
  uint32_t* s_tmp = s_fin + nf;              // radix scratch, then held bits
  uint32_t* s_hist = s_tmp + max(n, kWarps * hw);  // [digit][warp]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per_apex = (g.rows_per_apex + rows_per_block - 1) / rows_per_block;
  const long long ai = blockIdx.x / per_apex;
  const long long r0 = ai * g.rows_per_apex +
                       static_cast<long long>(blockIdx.x % per_apex) *
                           rows_per_block;
  const int nr = static_cast<int>(
      min(static_cast<long long>(rows_per_block),
          (ai + 1) * static_cast<long long>(g.rows_per_apex) - r0));
  float a[3];
  for (int k = 0; k < 3; ++k) a[k] = g.apex[3 * ai + k];
  if (tid == 0) s_nfin = 0;
  if (tid < nr) s_ok[tid] = g.row_valid == nullptr || g.row_valid[r0 + tid];
  if (g.planes != nullptr)
    for (int i = tid; i < 12 * nr; i += kThreads)
      s_n[i / 12][i % 12] = g.planes[r0 * 12 + i];
  __syncthreads();
  // The apex's distances and their order, once for the block's rows;
  // four boxes a thread loaded at a time.
  int fin = 0;
  for (int c0 = 0; c0 < n; c0 += 4 * kThreads) {
    float lo[4][3], hi[4][3];
    for (int u = 0; u < 4; ++u) {
      const int c = c0 + u * kThreads + tid;
      for (int k = 0; k < 3; ++k) {
        lo[u][k] = c < n ? __ldg(g.bmin + 3 * c + k) : 0.0f;
        hi[u][k] = c < n ? __ldg(g.bmax + 3 * c + k) : 0.0f;
      }
    }
    for (int u = 0; u < 4; ++u) {
      const int c = c0 + u * kThreads + tid;
      uint32_t bits = kInfBits;
      if (c < n) {
        bits = __float_as_uint(box_distance(a, lo[u], hi[u]));
        s_key[c] = bits;
        s_ord[c] = c;
      }
      const unsigned f = __ballot_sync(kFull, c < n && bits < kInfBits);
      const int cw = c0 + u * kThreads + 32 * warp;
      if (lane == 0 && cw < n) s_fin[cw >> 5] = f;
      fin += __popc(f);
    }
  }
  if (lane == 0 && fin) atomicAdd(&s_nfin, fin);
  __syncthreads();
  if (n <= kRankSortMax) {
    // A rank count: cluster c goes where the keys before it end. Threads
    // c and c + 256 count over the two halves of the keys.
    uint32_t* s_rank = s_tmp;
    const int c = tid & (kRankSortMax - 1), half = tid / kRankSortMax;
    if (tid < kRankSortMax && c < n) s_rank[c] = 0;
    __syncthreads();
    if (c < n) {
      const uint32_t k = sort_key(s_key[c]);
      const int lo = half * ((n + 1) / 2), hi = half ? n : (n + 1) / 2;
      int rank[4] = {0, 0, 0, 0};
      int c2 = lo;
      for (; c2 + 4 <= hi; c2 += 4)
        for (int u = 0; u < 4; ++u) {
          const uint32_t k2 = sort_key(s_key[c2 + u]);
          rank[u] += k2 < k || (k2 == k && c2 + u < c);
        }
      for (; c2 < hi; ++c2) {
        const uint32_t k2 = sort_key(s_key[c2]);
        rank[0] += k2 < k || (k2 == k && c2 < c);
      }
      atomicAdd(s_rank + c, static_cast<uint32_t>(rank[0] + rank[1] +
                                                  rank[2] + rank[3]));
    }
    __syncthreads();
    if (tid < n) s_ord[s_rank[tid]] = tid;
    __syncthreads();
  } else {
    radix_sort<kWarps>(s_key, s_ord, s_tmp, s_hist, s_warp_sum, n);
  }
  const int nfin = s_nfin;
  uint32_t* s_held = s_tmp + warp * hw;
  for (int rr = warp; rr < nr; rr += kWarps) {
    const long long r = r0 + rr;
    const bool ok = s_ok[rr];
    // The row's held bits: bit c + d of s_held is cluster c. A remaining
    // row is read as aligned 16-byte words (d: its bytes' offset in the
    // first), two lanes a bit word, four loads a lane in flight; a culled
    // row has d = 0.
    int d = 0;
    if (g.remaining != nullptr) {
      const uintptr_t addr = reinterpret_cast<uintptr_t>(g.remaining + r * n);
      d = static_cast<int>(addr & 15u);
      const uint4* src = reinterpret_cast<const uint4*>(addr - d);
      const int nvec = (d + n + 15) / 16;
      for (int v0 = 0; v0 < nvec; v0 += 128) {
        uint4 q[4];
        for (int u = 0; u < 4; ++u) {
          const int v = v0 + 32 * u + lane;
          q[u] = ok && v < nvec ? __ldg(src + v) : make_uint4(0, 0, 0, 0);
        }
        for (int u = 0; u < 4; ++u) {
          const int v = v0 + 32 * u + lane;
          const uint32_t bits = nibble(q[u].x) | (nibble(q[u].y) << 4) |
                                (nibble(q[u].z) << 8) | (nibble(q[u].w) << 12);
          const uint32_t up = __shfl_down_sync(kFull, bits, 1);
          if ((lane & 1) == 0 && v < nvec) s_held[v >> 1] = bits | (up << 16);
        }
      }
    } else {
      Row row;
      for (int k = 0; k < 3; ++k) row.a[k] = a[k];
      for (int q = 0; q < 12; ++q) row.n[q / 3][q % 3] = s_n[rr][q];
      row.ok = ok;
      for (int c0 = 0; c0 < n; c0 += 32) {
        const int c = c0 + lane;
        const bool h = row.held(g, r, c, c < n);
        const unsigned bal = __ballot_sync(kFull, h);
        if (lane == 0) s_held[c0 >> 5] = bal;
      }
    }
    __syncwarp();
    const int nhw = (d + n + 31) / 32;
    int nhf = 0;
    for (int k = lane; k < nhw; k += 32) {
      // Held clusters at a finite distance (the finite bits are 0 before
      // d and past d + n, other rows' bytes).
      nhf += __popc(s_held[k] & bits_at(s_fin, nf, 32 * k - d));
    }
    for (int o = 16; o > 0; o >>= 1) nhf += __shfl_xor_sync(kFull, nhf, o);
    auto held = [&](int c) {
      return ((s_held[(c + d) >> 5] >> ((c + d) & 31)) & 1u) != 0u;
    };
    if (g.hit != nullptr || g.any != nullptr) {
      bool any_h = false;
      for (int c0 = 0; c0 < n; c0 += 32) {
        const int c = c0 + lane;
        const bool h = c < n && held(c);
        if (g.hit != nullptr && c < n) g.hit[r * n + c] = h;
        any_h = any_h || h;
      }
      any_h = __any_sync(kFull, any_h);
      if (g.any != nullptr && lane == 0) g.any[r] = any_h;
    }
    row_list<2>(
        g, r, lane, nhf, nfin, held,
        [&](int p) { return static_cast<int>(s_ord[p]); },
        [&](int p) { return s_key[s_ord[p]]; },
        [&](int c) { return s_key[c]; });
    __syncwarp();
  }
}

// ---- select_radix (C > kSortCap) ---------------------------------------

constexpr int kListCap = 1024;  // selected keys sorted at once

// One row's view for the radix-select path: keys recomputed per pass.
struct RadixRow {
  const SelectArgs* g;
  long long r;
  Row row;

  __device__ float dist(int c) const {
    float lo[3], hi[3];
    for (int k = 0; k < 3; ++k) {
      lo[k] = __ldg(g->bmin + 3 * c + k);
      hi[k] = __ldg(g->bmax + 3 * c + k);
    }
    return box_distance(row.a, lo, hi);
  }

  // Called by whole warps (the cull's early stop is warp-wide).
  __device__ bool candidate(int c, bool live) const {
    return row.held(*g, r, c, live);
  }

  // The sort key's high word: +inf for clusters not in the row.
  __device__ uint32_t key32(int c, bool live) const {
    const bool h = candidate(c, live);
    if (!h) return kInfBits;
    return sort_key(__float_as_uint(dist(c)));
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
__device__ uint64_t key_of_rank(const RadixRow& row, int rank,
                                SelectShared& sh) {
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int n = row.g->n_cl;
  uint32_t prefix = 0, pmask = 0;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int i = tid; i < 256; i += nthr) sh.hist[i] = 0;
    __syncthreads();
    for (int c0 = 0; c0 < n; c0 += nthr) {
      const int c = c0 + tid;
      const uint32_t k = row.key32(c, c < n);
      if (c < n && (k & pmask) == prefix)
        atomicAdd(&sh.hist[(k >> shift) & 255u], 1u);
    }
    __syncthreads();
    if (tid < 32) {
      // Lane l holds bins 8l .. 8l + 7; the lane whose span holds the
      // rank finds the bin.
      unsigned own = 0;
      for (int j = 0; j < 8; ++j) own += sh.hist[8 * tid + j];
      unsigned incl = own;
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned v = __shfl_up_sync(kFull, incl, o);
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
  for (int c0 = 0; c0 < n; c0 += nthr) {
    const int c = c0 + tid;
    const bool match = row.key32(c, c < n) == prefix && c < n;
    const unsigned ballot = __ballot_sync(kFull, match);
    if (lane == 0) sh.warp_sum[warp] = __popc(ballot);
    __syncthreads();
    int offset = 0, total = 0;
    for (int w = 0; w < nwarp; ++w) {
      if (w < warp) offset += sh.warp_sum[w];
      total += sh.warp_sum[w];
    }
    if (match && before + offset + __popc(ballot & lanes_below(lane)) == rank)
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

__global__ void __launch_bounds__(256) select_radix_kernel(SelectArgs g) {
  __shared__ SelectShared sh;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int n = g.n_cl;
  RadixRow row;
  row.g = &g;
  row.r = blockIdx.x;
  row.row.load(g, row.r);
  const size_t base = static_cast<size_t>(row.r) * n;

  if (g.hit != nullptr || g.any != nullptr) {
    bool seen = false;
    for (int c0 = 0; c0 < n; c0 += nthr) {
      const int c = c0 + tid;
      const bool h = row.candidate(c, c < n);
      if (g.hit != nullptr && c < n) g.hit[base + c] = h;
      seen = __syncthreads_or(h) || seen;
      if (seen && g.hit == nullptr) break;
    }
    if (g.any != nullptr && tid == 0) g.any[row.r] = seen;
  }

  // Ranks [done, done + m) per chunk: the keys in [lo, hi), sorted.
  if (tid == 0) sh.n_finite = 0;
  uint64_t lo = 0, last = 0;
  for (int done = 0; done < g.kc; done += kListCap) {
    const int m = min(kListCap, g.kc - done);
    const uint64_t hi = done + m < n ? key_of_rank(row, done + m, sh) : ~0ull;
    if (tid == 0) sh.n_list = 0;
    __syncthreads();
    for (int c0 = 0; c0 < n; c0 += nthr) {
      const int c = c0 + tid;
      const uint64_t k = (static_cast<uint64_t>(row.key32(c, c < n)) << 32) |
                         static_cast<uint32_t>(c);
      if (c < n && k >= lo && k < hi) sh.list[atomicAdd(&sh.n_list, 1)] = k;
    }
    __syncthreads();
    sort_list(sh, m);
    int finite = 0;
    for (int i = tid; i < m; i += nthr) {
      const uint64_t k = sh.list[i];
      const uint32_t hw = static_cast<uint32_t>(k >> 32);
      const int c = static_cast<int>(k & 0xffffffffu);
      g.ccand[row.r * g.kc + done + i] = c;
      // A NaN key keeps its distance's own bits, as the sort keeps them.
      g.centry[row.r * g.kc + done + i] =
          hw == kNanBits ? row.dist(c) : __uint_as_float(hw);
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
  const int ki = sel ? static_cast<int>(last & 0xffffffffu) : n;
  float nearest = __uint_as_float(kInfBits);
  for (int c0 = 0; c0 < n; c0 += nthr) {
    const int c = c0 + tid;
    const bool h = row.candidate(c, c < n);
    if (c >= n) continue;
    const float d = row.dist(c);
    const bool stays = h && (d > kd || (d == kd && c > ki));
    g.new_rem[base + c] = stays;
    if (stays) nearest = fminf(nearest, d);
  }
  for (int o = 16; o > 0; o >>= 1)
    nearest = fminf(nearest, __shfl_xor_sync(kFull, nearest, o));
  if (tid == 0) sh.bound = __uint_as_float(kInfBits);
  __syncthreads();
  if ((tid & 31) == 0)
    atomicMin(reinterpret_cast<int*>(&sh.bound), __float_as_int(nearest));
  __syncthreads();
  if (tid == 0) g.next_bound[row.r] = sh.bound;
}

int radix_threads(int n_cl) {
  int t = 32;
  while (t < n_cl && t < 256) t <<= 1;
  return t;
}

// The card's SMs (an H100 SXM's 132): only how rows are split over warps
// follows from it, never a result.
constexpr int kSms = 132;

}  // namespace

extern "C" int rtmm_tile_frusta(const float* ivp, int n_frames, float width,
                                float height, float rw, float rh, int tx,
                                int tile0, int n_tiles, int nsub, int nrows,
                                const float* aabb, int pack, int raygen,
                                float* apex, float* normals, float* sub,
                                float* frus, void* stream) {
  if (n_frames < 0 || n_frames > 65535 || n_tiles < 0 || tile0 < 0 ||
      nsub < 1 || nsub > kMaxSub || nrows < 1 || nsub % nrows != 0 ||
      kTile % nrows != 0 || kTile % (nsub / nrows) != 0 || tx < 1 ||
      (sub == nullptr && frus == nullptr) ||
      (frus != nullptr && (aabb == nullptr || pack < 3 + 12 * nsub + 6 ||
                           pack % 4 != 0 || pack > kMaxPack)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_frames == 0 || n_tiles == 0) return 0;
  const int trow0 = tile0 / tx;
  const int n_trows = (tile0 + n_tiles - 1) / tx - trow0 + 1;
  // The largest tile group that still gives two blocks per SM: a group
  // shares its corners, a small launch wants blocks.
  static const int groups[][2] = {{8, 4}, {4, 4}, {4, 2}, {2, 2},
                                  {2, 1}, {1, 1}};
  int gw = 1, gh = 1;
  for (const auto& grp : groups) {
    gw = grp[0];
    gh = grp[1];
    const long long blocks = static_cast<long long>(n_frames) *
                             ((tx + gw - 1) / gw) * ((n_trows + gh - 1) / gh);
    if (blocks >= 2 * kSms) break;
  }
  const int ngx = (tx + gw - 1) / gw;
  const int ngy = (n_trows + gh - 1) / gh;
  const int threads = min(kFrustaThreads, max(64, 32 * gw * gh));
  FrustaArgs g{ivp,    width,   height, rw,      rh,    tx,    tile0,
               n_tiles, n_frames, nsub, nrows,   pack,  raygen, trow0,
               n_trows, gw,      gh,    ngx,     aabb,  apex,  normals,
               sub,    frus};
  tile_frusta_kernel<<<dim3(ngx * ngy, n_frames), threads, 0,
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
      n_rows % rows_per_apex != 0 ||
      (remaining == nullptr && (planes == nullptr || valid == nullptr)) ||
      (planes != nullptr && reinterpret_cast<uintptr_t>(planes) % 16 != 0) ||
      (kc > 0 && (ccand == nullptr || ccount == nullptr ||
                  centry == nullptr)) ||
      ((new_rem == nullptr) != (next_bound == nullptr)) ||
      (new_rem != nullptr && kc == 0))
    return static_cast<int>(cudaErrorInvalidValue);
  SelectArgs g{n_rows, n_cl,   kc,     apex,   rows_per_apex, planes,
               remaining, row_valid, bmin, bmax, valid,  hit,
               any,    ccand,  ccount, centry, new_rem, next_bound};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kc == 0 && n_cl <= 32) {
    int cp = 1;
    while (cp < n_cl) cp <<= 1;
    const long long warps = (n_rows + 32 / cp - 1) / (32 / cp);
    cull_small_kernel<<<static_cast<unsigned>((warps + 7) / 8), 256, 0, st>>>(
        g, cp);
  } else if (kc == 0) {
    // Clusters split over blocks unless the any-hit is asked for.
    const int seg = any != nullptr ? n_cl : kCullSegment;
    cull_kernel<<<dim3((n_rows + kCullRows - 1) / kCullRows,
                       (n_cl + seg - 1) / seg),
                  kCullThreads, 0, st>>>(g, seg);
  } else if (n_cl <= 32) {
    // Rows per warp: enough warps for 32 a SM, each apex sorted once a run.
    const int rows_per_warp = static_cast<int>(min(
        8LL, max(1LL, (n_rows + 32LL * kSms - 1) / (32LL * kSms))));
    const long long warps = (n_rows + rows_per_warp - 1) / rows_per_warp;
    select_warp_kernel<<<static_cast<unsigned>(
                             (warps + kWarpSelectWarps - 1) /
                             kWarpSelectWarps),
                         kWarpSelectWarps * 32, 0, st>>>(g, rows_per_warp);
  } else if (n_cl <= kSortCap) {
    const int smem = block_smem(n_cl);
    // Rows per block: a block orders its apex's clusters once for them.
    const int rows_per_block = n_cl <= kRankSortMax ? kBlockRowsMax
                               : n_cl <= 4096      ? kRadixWarps
                                                   : 16;
    const long long blocks =
        static_cast<long long>(n_rows / rows_per_apex) *
        ((rows_per_apex + rows_per_block - 1) / rows_per_block);
    const auto kernel = n_cl <= kRankSortMax ? select_block_kernel<kRankWarps>
                                             : select_block_kernel<kRadixWarps>;
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    kernel<<<static_cast<unsigned>(blocks), 32 * block_warps(n_cl), smem,
             st>>>(g, rows_per_block);
  } else {
    select_radix_kernel<<<n_rows, radix_threads(n_cl), 0, st>>>(g);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rtmm_prologue_select_cap() { return kSortCap; }

extern "C" const char* rtmm_prologue_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
