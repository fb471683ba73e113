// Tile-list rasterizer kernels for Hopper (sm_90a), bound with a plain C
// interface and loaded with ctypes (metalrenderer_tpu_torch/raster/_build.py).
//
// K1 raster_depth_kernel<NS> replaces the depth-only specialization of
//    the Pallas band kernel (metalrenderer_tpu/raster/raster_pallas.py,
//    _make_kernel(with_attrs=False), launched by rasterize_tiles): the
//    shadow pass, on the tile walk of K2 and K3 with a fragment stage that
//    stores the per-sample depth and, where the caller asks, the winner.
// K2 render_fused_kernel replaces its fused-shade specialization (launched
//    by raster_pallas.render_fused): 4x MSAA visibility, the first covered
//    sample's attributes, Blinn-Phong/emissive shading, the exact
//    REPEAT-bilinear shadow test and the coverage resolve: the main pass.
// K3 raster_gbuffer_kernel replaces its per-pixel G-buffer specialization
//    (_make_kernel(with_attrs=True, attr_px=True), launched by
//    rasterize_tiles): K2's tile walk and fragment selection with another
//    fragment stage, which writes the first covered sample's raw attribute
//    value/w and the covered count instead of shading them: the split
//    path's main pass.
// K3s raster_gbuffer_samples_kernel replaces its per-sample G-buffer
//    specialization (_make_kernel(with_attrs=True, attr_px=False), launched
//    by rasterize_tiles): the same visibility, then for every sample its own
//    winner's raw attribute value/w at that sample and the
//    sample's depth: supersampled shading, and main-pass tiles other than
//    8x128.
// K4, K5, K6 are the same three kernels over a frame batch, replacing the
//    frame-folded Pallas launches raster_pallas.rasterize_depth_batch,
//    rasterize_tiles_batch and render_fused_batch: blockIdx.z is the frame
//    (in the split kernels of K5 and K6, each item's).
//    Each block offsets its tables (vis, attr, tile_off, tile_tris, big_*),
//    its uniforms, its shadow map and its outputs by its frame's base and
//    then runs the per-frame code unchanged, so a batch frame is bit-equal
//    to a per-frame launch on the same bins. A per-frame launch is the
//    batch of one (gridDim.z == 1). Frame offsets are size_t: K5's output
//    at 8 frames of 1080p is 1.06 GB.
//
// What bounds K3s on the H100: it writes 64 B per SAMPLE (531 MB at 1080p
// x 4) and is bound by those bytes. One thread per pixel, 32x8 blocks that
// lie inside one binning tile (tiles are 8x128 or 16x128 there): each
// thread walks its tile's list and the gated big list (visibility()
// below), keeps the per-sample depth and winner in registers, then stores
// its pixel's S x 16 values plane by plane, each store coalesced across
// the warp's 32 consecutive pixels.
//
// K2 and K6 (render_fused_kernel) replace raster_pallas.render_fused
// (pallas_call raster_pallas.py:1106) and render_fused_batch (:1380). Their
// least time is set by bytes: 20 B of rgba and covered fraction per pixel,
// 41 MB or 0.0137 ms a 1080p frame at 3.35 TB/s; their FP32 operations
// (16 per candidate and sample, 60 per covered pixel) take ~0.008 ms at
// 67 TFLOP/s. What bounds them is issued instructions: in the per-pixel
// form every thread repeated its tile's big-list gate (an integer division
// per entry) and the tile-anchored plane constants, and tested every
// candidate on every sample. So K2 and K6 run one 256-thread block per
// binning tile and frame (walk_tile). The block splits the tile's list and
// the live big list over its threads, gates each entry once, compacts the
// valid candidates into shared memory with a warp ballot (stage_chunk), and
// stores for each its three edges and its z plane as (a, b, c') with c'
// anchored on the tile corner, the edge flags and the tid beside them:
// 64 B a candidate, 256 candidates (16 KB) a chunk, longer lists in
// several chunks. Every warp then reads the staged candidates by
// broadcast and tests them on 4 pixels of one row per lane, with the
// sample count a template parameter; a candidate that plane_max shows
// outside the warp's row, or outside one lane column group of 32 pixels,
// is skipped there exactly (test_staged). The fragment stage (attribute
// weights, IEEE division and sqrt, powf, the shadow lookup) runs once per
// pixel and stores rgba (float4) and the covered fraction coalesced
// across the warp; on the H100 it takes about half of the kernel's time
// at the flagship frame (PERF.md). No tensor core or TMA fits: there is
// no matrix product, and the inputs are a gather of a few 68-byte rows by
// triangle id.
//
// K3 and K5 (raster_gbuffer_kernel) replace rasterize_tiles(attr_px=True)
// (pallas_call raster_pallas.py:951) and rasterize_tiles_batch (:1254) on
// the same tile walk: only the fragment stage differs. Their least time is
// set by bytes: gout is 64 B a pixel (16 planes), 133 MB or 0.040 ms a
// 1080p frame at 3.35 TB/s, three times K2's output, and it does not fit
// in the 50 MB L2. The per-pixel form that came before walked every
// candidate and gated the whole big list in every thread, which left it at
// 3.3x that bound. On the tile walk the visibility costs what it costs K2,
// and the fragment stage is 12 float4 loads of the winner's attribute row
// (a few KB a frame, served by L1) and 16 stores a pixel: each store is 32
// consecutive floats of one plane across the warp (128 B), and uncovered
// pixels store zeros in the same instructions, so every store of an
// interior tile is a whole line.
//
// On long tile lists (a UV sphere's pole tile: 2,243 candidates at 1080p,
// 8,750 at 3840x2160) one block walking a tile set K2's and K3's time: the
// rest of the grid finished and the card waited on that block. So K2, K3,
// K5 and K6 split such a tile's candidates over blocks (the split walk
// below): a split kernel finds the long tiles on the device and walks them
// in slices beside the tile kernel, merging each sample's winner exactly.
//
// K1 and K4 (raster_depth_kernel) replace rasterize_tiles(with_attrs=
// False) (pallas_call raster_pallas.py:951) and rasterize_depth_batch
// (:1184) on the same tile walk, with a fragment stage that stores the
// per-sample depth, and the winner only where the caller keeps it (the
// shadow pass does not; the JAX rasterize_depth_batch returns depth only).
// Their least time is set by bytes: 4 B of depth a sample (4.2 MB a 1024^2
// shadow map), 8 B with the winner; their operations, 16 per candidate and
// sample, are few on the shadow pass's short lists. The per-pixel form
// that came before walked every candidate and gated the whole big list in
// every thread, which left it at 4x the byte bound. The shadow pass bins
// on 64x128 tiles: 128 tiles of a 1024^2 map, fewer than the H100's 132
// SMs, and 8 passes of 8 warps each. So a launch may split every tile's
// passes over blockIdx.y (gridDim.y parts, each staging the tile's
// candidates itself) to keep more warps in flight; the wrapper picks the
// split (raster_cuda._depth_parts: 8 parts for one such map, 4 for eight).
// The stores are coalesced across the warp's 32 consecutive pixels.
//
// Visibility is order-free (see raster_cuda.py): the winner of a sample is
// the lexicographic minimum of (z, -tid) over its candidates, so the tile
// list and the big list are walked in one loop with
//   take = ok && (z < zb || (z == zb && tid > wb)).
// Planes are evaluated on the binning tile's anchor grid with the Pallas
// kernel's association, c' = (c + a*ox) + b*oy, then (a*xr + b*yr) + c'.
// Attributes are not planes: the attr table holds each vertex's value/w,
// and a fragment weights its winner's three vertices by its edge values
// at the sample, normalized by their sum (sample_weights). A
// plane of value/w evaluated at an absolute position cancels on a sliver
// triangle, whose coefficients scale with 1/area, and its 1/w then
// divides a near-zero: the dense sphere's pole fans read hundreds of times
// too bright at x ~ 1900 (ROADMAP C13). The weights lie in [0, 1].
// Built with -fmad=false and without fast math: every multiply and add
// rounds on its own, divisions and sqrtf are IEEE, as in the torch twins.
#include <cuda_runtime.h>

#include <climits>
#include <type_traits>

namespace {

constexpr int kMaxSamples = 4;
constexpr int kVis = 17;        // vis table row: 3 edges, z plane, tl x3, valid, tid
constexpr int kAttr = 48;       // attr table row: V0[16] | V1[16] | V2[16]
constexpr int kAttrV = 16;      // a vertex's 16 value/w groups
constexpr int kGoutRows = 16;   // 15 attribute groups + covered count
constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

// Attribute groups (metalrenderer_tpu_torch/raster/binning.py ROW_*).
constexpr int kRowWorld = 0;
constexpr int kRowNormal = 5;
constexpr int kRowInvW = 8;
constexpr int kRowMatKind = 9;
constexpr int kRowColor = 11;

// Fused uniforms (raster_cuda.py FU_*).
constexpr int kFuM = 0;
constexpr int kFuCam = 16;
constexpr int kFuLPos = 19;
constexpr int kFuLCol = 22;
constexpr int kFuAmb = 25;
constexpr int kFuShin = 26;
constexpr int kFuClear = 27;
constexpr int kFuBias = 31;
constexpr int kFuFactor = 32;
constexpr int kFuLen = 33;

constexpr float kEmissive = 2.0f;            // materials.EMISSIVE
constexpr float kBlinnPhongShadow = 1.0f;    // materials.BLINN_PHONG_SHADOW

struct Samples {
  int n;
  float ox[kMaxSamples];
  float oy[kMaxSamples];
};

// Per frame f of F (F == 1 for a per-frame launch); tids are frame-local.
struct Bins {
  const float* vis;        // [F, T, 17]
  const int* tile_off;     // [F, NT + 1] CSR row pointers into the frame's list
  const int* tile_tris;    // [F, L] tids, grouped by tile
  const int* big_ids;      // [F, cap] live big-list tids first
  const int* big_aabb;     // [F, cap, 4] xmin, ymin, xmax, ymax (floor/ceil)
  const int* big_n;        // [F] live big-list length
  int tile_w, tile_h, ntx;
  int n_tiles, n_tris, n_tile_tris, big_cap;   // NT, T, L, cap
};

struct Shading {
  const float* attr;       // [F, T, 48]
  const float* uni;        // [F, 33]
  const float* smap;       // [F, tex_h, tex_w] or nullptr
  int tex_h, tex_w;
};

// Frame f's slice of the stacked tables.
__device__ __forceinline__ Bins frame_bins(const Bins& B0, int f) {
  Bins B = B0;
  B.vis += (size_t)f * B0.n_tris * kVis;
  B.tile_off += (size_t)f * (B0.n_tiles + 1);
  B.tile_tris += (size_t)f * B0.n_tile_tris;
  B.big_ids += (size_t)f * B0.big_cap;
  B.big_aabb += (size_t)f * B0.big_cap * 4;
  B.big_n += f;
  return B;
}

__device__ __forceinline__ Shading frame_shading(const Shading& SH0,
                                                 int n_tris, int f) {
  Shading SH = SH0;
  SH.attr += (size_t)f * n_tris * kAttr;
  SH.uni += (size_t)f * kFuLen;
  if (SH.smap != nullptr) SH.smap += (size_t)f * SH0.tex_h * SH0.tex_w;
  return SH;
}

__device__ __forceinline__ float plane_at(float a, float b, float c, float ox,
                                          float oy, float xr, float yr) {
  const float cof = __fadd_rn(__fadd_rn(c, __fmul_rn(a, ox)), __fmul_rn(b, oy));
  return __fadd_rn(__fadd_rn(__fmul_rn(a, xr), __fmul_rn(b, yr)), cof);
}

__device__ __forceinline__ bool inside(float e, float tl) {
  return e > 0.0f || (e == 0.0f && tl > 0.0f);
}

__device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

// NaN-propagating max(x, 0), like jnp.maximum / torch.clamp_min.
__device__ __forceinline__ float max0(float x) { return x < 0.0f ? 0.0f : x; }

struct PixelState {
  int tx, ty;
  float ox, oy;
  float xr[kMaxSamples], yr[kMaxSamples];
  float zb[kMaxSamples];
  int wb[kMaxSamples];
};

__device__ __forceinline__ void test_triangle(const float* __restrict__ f,
                                              int tid, int ns, PixelState& p) {
  if (!(f[15] > 0.0f)) return;  // valid flag
  const float a0 = f[0], b0 = f[1], c0 = f[2];
  const float a1 = f[3], b1 = f[4], c1 = f[5];
  const float a2 = f[6], b2 = f[7], c2 = f[8];
  const float az = f[9], bz = f[10], cz = f[11];
  const float tl0 = f[12], tl1 = f[13], tl2 = f[14];
#pragma unroll
  for (int s = 0; s < kMaxSamples; ++s) {
    if (s < ns) {
      const float e0 = plane_at(a0, b0, c0, p.ox, p.oy, p.xr[s], p.yr[s]);
      const float e1 = plane_at(a1, b1, c1, p.ox, p.oy, p.xr[s], p.yr[s]);
      const float e2 = plane_at(a2, b2, c2, p.ox, p.oy, p.xr[s], p.yr[s]);
      const float z = plane_at(az, bz, cz, p.ox, p.oy, p.xr[s], p.yr[s]);
      const bool ok = inside(e0, tl0) && inside(e1, tl1) && inside(e2, tl2) &&
                      z >= 0.0f && z <= 1.0f;
      if (ok && (z < p.zb[s] || (z == p.zb[s] && tid > p.wb[s]))) {
        p.zb[s] = z;
        p.wb[s] = tid;
      }
    }
  }
}

// K3s's per-sample depth and winner of pixel (px, py): its tile's list,
// then the live big list behind the big list's AABB gate (raster_pallas.py:
// 513-518).
__device__ void visibility(const Bins& B, const Samples& S, float clear_depth,
                           int px, int py, PixelState& p) {
  p.tx = px / B.tile_w;
  p.ty = py / B.tile_h;
  const int x0 = p.tx * B.tile_w;
  const int y0 = p.ty * B.tile_h;
  p.ox = (float)x0;
  p.oy = (float)y0;
#pragma unroll
  for (int s = 0; s < kMaxSamples; ++s) {
    p.xr[s] = __fadd_rn((float)(px - x0), S.ox[s]);
    p.yr[s] = __fadd_rn((float)(py - y0), S.oy[s]);
    p.zb[s] = clear_depth;
    p.wb[s] = -1;
  }
  const int t = p.ty * B.ntx + p.tx;
  const int beg = B.tile_off[t];
  const int end = B.tile_off[t + 1];
  for (int i = beg; i < end; ++i) {
    const int tid = B.tile_tris[i];
    test_triangle(B.vis + (size_t)tid * kVis, tid, S.n, p);
  }
  const int nb = B.big_n[0];
  for (int k = 0; k < nb; ++k) {
    const int* bb = B.big_aabb + 4 * k;
    if (!(bb[1] < y0 + B.tile_h && bb[3] > y0)) continue;
    const int sx0 = min(max(floor_div(bb[0], B.tile_w), 0), B.ntx - 1);
    const int sx1 = min(max(floor_div(bb[2] - 1, B.tile_w), 0), B.ntx - 1);
    if (p.tx < sx0 || p.tx > sx1) continue;
    const int tid = B.big_ids[k];
    test_triangle(B.vis + (size_t)tid * kVis, tid, S.n, p);
  }
}

// sampling.sample_bilinear with REPEAT addressing on a single channel, for
// u, v in [0, 1]: then x = u*w - 0.5 lies in [-0.5, w - 0.5], so the texel
// indices xi, xi + 1 lie in [-1, w] and the wrap is one compare each.
__device__ float bilinear_repeat_unit(const float* __restrict__ tex, int h,
                                      int w, float u, float v) {
  const float x = u * (float)w - 0.5f;
  const float y = v * (float)h - 0.5f;
  const float x0 = floorf(x);
  const float y0 = floorf(y);
  const float fx = x - x0;
  const float fy = y - y0;
  const int xi = (int)x0;
  const int yi = (int)y0;
  const int xa = xi < 0 ? xi + w : xi;
  const int xb = xi + 1 >= w ? xi + 1 - w : xi + 1;
  const int ya = yi < 0 ? yi + h : yi;
  const int yb = yi + 1 >= h ? yi + 1 - h : yi + 1;
  const float t00 = tex[(size_t)ya * w + xa];
  const float t10 = tex[(size_t)ya * w + xb];
  const float t01 = tex[(size_t)yb * w + xa];
  const float t11 = tex[(size_t)yb * w + xb];
  const float top = t00 * (1.0f - fx) + t10 * fx;
  const float bot = t01 * (1.0f - fx) + t11 * fx;
  return top * (1.0f - fy) + bot * fy;
}

// The weights of a triangle's three vertices at a sample it covers, at
// offset (ox, oy) in pixel (px, py): its edge values there (vis row f),
// anchored on the pixel, (a*ox + b*oy) + ((c + a*px) + b*py), each at
// least 0 (the walk, anchored on the binning tile, found the sample
// inside every edge; anchored on the pixel, rounding may put it a hair
// outside), normalized by their sum. lambda_0 takes e12, lambda_1 e20, lambda_2 e01
// (binning.py's edge order). Each weight lies in [0, 1] and they sum to 1
// within rounding, however thin the triangle, so an attribute
// interpolated with them stays within its three vertex values; anchored
// on the pixel, they do not depend on the tile grid.
struct Weights {
  float l0, l1, l2;
};

__device__ __forceinline__ Weights sample_weights(const float* __restrict__ f,
                                                  int px, int py, float ox,
                                                  float oy) {
  const float x = (float)px, y = (float)py;
  const float e0 = max0(plane_at(f[0], f[1], f[2], x, y, ox, oy));
  const float e1 = max0(plane_at(f[3], f[4], f[5], x, y, ox, oy));
  const float e2 = max0(plane_at(f[6], f[7], f[8], x, y, ox, oy));
  const float sum = __fadd_rn(__fadd_rn(e1, e2), e0);
  const float r = 1.0f / (sum > 0.0f ? sum : 1.0f);
  return Weights{__fmul_rn(e1, r), __fmul_rn(e2, r), __fmul_rn(e0, r)};
}

// Attribute group g's value/w at the weights' sample, from the row a of
// per-vertex value/w: (l0*v0 + l1*v1) + l2*v2.
__device__ __forceinline__ float attr_at(const float* __restrict__ a, int g,
                                         const Weights& w) {
  return __fadd_rn(__fadd_rn(__fmul_rn(w.l0, a[g]),
                             __fmul_rn(w.l1, a[kAttrV + g])),
                   __fmul_rn(w.l2, a[2 * kAttrV + g]));
}

// K3s: the per-sample G-buffer (raster_pallas.rasterize_tiles with
// with_attrs=True, attr_px=False), one frame. gout[s] rows 0-14 are sample
// s's winner's raw value/w at the sample (sample_weights), row 15 the
// sample's depth; an uncovered sample is zeros with clear_depth in row 15.
// The Pallas kernel rewrites a sample's rows each time a chunk's triangle
// takes it; the order-free walk knows the final winner, so every row is
// interpolated once.
__global__ void __launch_bounds__(kBlockX * kBlockY)
raster_gbuffer_samples_kernel(Bins B, Samples S, float clear_depth,
                              const float* __restrict__ attr, int width,
                              int height, float* __restrict__ gout,
                              float* __restrict__ depth,
                              int* __restrict__ winner) {
  const int px = blockIdx.x * kBlockX + threadIdx.x;
  const int py = blockIdx.y * kBlockY + threadIdx.y;
  if (px >= width || py >= height) return;
  PixelState p;
  visibility(B, S, clear_depth, px, py, p);
  const size_t plane = (size_t)width * height;
  const size_t o = (size_t)py * width + px;
#pragma unroll
  for (int s = 0; s < kMaxSamples; ++s) {
    if (s < S.n) {
      depth[s * plane + o] = p.zb[s];
      winner[s * plane + o] = p.wb[s];
      float* __restrict__ G = gout + (size_t)s * kGoutRows * plane + o;
      if (p.wb[s] >= 0) {
        const float* __restrict__ A = attr + (size_t)p.wb[s] * kAttr;
        const Weights w = sample_weights(B.vis + (size_t)p.wb[s] * kVis, px,
                                         py, S.ox[s], S.oy[s]);
#pragma unroll
        for (int g = 0; g < kGoutRows - 1; ++g) {
          G[g * plane] = attr_at(A, g, w);
        }
      } else {
#pragma unroll
        for (int g = 0; g < kGoutRows - 1; ++g) G[g * plane] = 0.0f;
      }
      G[(kGoutRows - 1) * plane] = p.zb[s];
    }
  }
}

// ---- The tile walk: K2/K6 (render_fused_kernel), K3/K5
// (raster_gbuffer_kernel) and K1/K4 (raster_depth_kernel). --------------

constexpr int kTileThreads = 256;              // one block per binning tile
constexpr int kTileMinBlocks = 2;              // per SM: <= 128 registers
constexpr int kTileWarps = kTileThreads / 32;
constexpr int kChunk = kTileThreads;           // candidates staged per pass
constexpr int kPixPerLane = 4;                 // pixels per lane in a segment
constexpr int kSegW = 32 * kPixPerLane;        // a warp's row segment: 128 px

// A staged candidate: for each edge and for z, (a, b, c') with c' = (c +
// a*ox) + b*oy anchored on the tile corner (plane_at's first line); w holds
// the edge's top-left flag, or for z the tid's bits. 64 B.
struct StagedTri {
  float4 e[3];
  float4 z;
};

struct TileStage {
  StagedTri tri[kChunk];                       // 16 KB
  int warp_count[kTileWarps];
};

// Tile t of B: its corner, its list and the live big-list length.
struct TileRef {
  int tx, x0, y0;
  int beg, n_list, n_big;
};

__device__ __forceinline__ TileRef tile_ref(const Bins& B, int t) {
  TileRef T;
  T.tx = t % B.ntx;
  T.x0 = T.tx * B.tile_w;
  T.y0 = (t / B.ntx) * B.tile_h;
  T.beg = B.tile_off[t];
  T.n_list = B.tile_off[t + 1] - T.beg;
  T.n_big = B.big_n[0];
  return T;
}

__device__ __forceinline__ int tile_chunks(const TileRef& T) {
  return (T.n_list + T.n_big + kChunk - 1) / kChunk;
}

__device__ __forceinline__ float anchored(float a, float b, float c, float ox,
                                          float oy) {
  return __fadd_rn(__fadd_rn(c, __fmul_rn(a, ox)), __fmul_rn(b, oy));
}

// Stage chunk `chunk` of tile T's candidates into `st`: entries chunk *
// kChunk + k of the tile list followed by the live big list, one per
// thread, big entries behind the big list's AABB gate (raster_pallas.py:
// 513-518, the expressions of visibility() above), invalid triangles
// dropped, the rest compacted with a warp ballot and per-warp counts.
// Visibility is order-free, so the order of the staged candidates does
// not matter. Every thread of the block calls it; returns the count.
__device__ int stage_chunk(const Bins& B, const TileRef& T, int chunk,
                           TileStage& st) {
  __syncthreads();                 // the previous chunk's readers are done
  const int k = chunk * kChunk + threadIdx.x;
  int tid = -1;
  if (k < T.n_list) {
    tid = B.tile_tris[T.beg + k];
  } else if (k - T.n_list < T.n_big) {
    const int kb = k - T.n_list;
    const int* bb = B.big_aabb + 4 * kb;
    if (bb[1] < T.y0 + B.tile_h && bb[3] > T.y0) {
      const int sx0 = min(max(floor_div(bb[0], B.tile_w), 0), B.ntx - 1);
      const int sx1 = min(max(floor_div(bb[2] - 1, B.tile_w), 0), B.ntx - 1);
      if (T.tx >= sx0 && T.tx <= sx1) tid = B.big_ids[kb];
    }
  }
  const float* __restrict__ f = B.vis + (size_t)max(tid, 0) * kVis;
  const bool pass = tid >= 0 && f[15] > 0.0f;       // valid flag
  const unsigned mask = __ballot_sync(0xffffffffu, pass);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) st.warp_count[warp] = __popc(mask);
  __syncthreads();
  int base = 0, total = 0;
#pragma unroll
  for (int w = 0; w < kTileWarps; ++w) {
    const int c = st.warp_count[w];
    base += w < warp ? c : 0;
    total += c;
  }
  if (pass) {
    StagedTri& s = st.tri[base + __popc(mask & ((1u << lane) - 1u))];
    const float ox = (float)T.x0, oy = (float)T.y0;
#pragma unroll
    for (int e = 0; e < 3; ++e) {
      s.e[e] = make_float4(f[3 * e], f[3 * e + 1],
                           anchored(f[3 * e], f[3 * e + 1], f[3 * e + 2], ox, oy),
                           f[12 + e]);
    }
    s.z = make_float4(f[9], f[10], anchored(f[9], f[10], f[11], ox, oy),
                      __int_as_float(tid));
  }
  __syncthreads();
  return total;
}

// A lane's kPixPerLane pixels of one tile row (columns c, c + 32, ...):
// tile-relative sample positions and per-sample depth and winner.
template <int NS>
struct SegmentState {
  float xr[kPixPerLane][NS], yr[NS];
  float zb[kPixPerLane][NS];
  int wb[kPixPerLane][NS];
  // The extremes of xr over the warp's pixels j (columns 32j .. 32j + 31
  // of the segment) and of yr, every sample included.
  float xlo[kPixPerLane], xhi[kPixPerLane], ylo, yhi;
};

// The largest value plane_at's second line, (a*xr + b*yr) + c', takes on
// the samples of a box of positions [xlo, xhi] x [ylo, yhi]: each rounded
// multiply and add is monotone in its operands, so it is the value at the
// corner that the signs of a and b pick (NaN if any coefficient is NaN).
__device__ __forceinline__ float plane_max(const float4& e, float xlo,
                                           float xhi, float ylo, float yhi) {
  return __fadd_rn(__fadd_rn(__fmul_rn(e.x, e.x > 0.0f ? xhi : xlo),
                             __fmul_rn(e.y, e.y > 0.0f ? yhi : ylo)),
                   e.z);
}

// Test the n staged candidates on the lane's pixels: plane_at's second
// line, (a*xr + b*yr) + c', with b*yr shared by the segment's pixels, and
// take = ok && (z < zb || (z == zb && tid > wb)). A candidate is skipped
// for the warp's segment, or for its pixels j, when an edge's plane_max
// over them is not inside: then no sample of theirs is inside that edge
// (inside() is monotone), so the skip changes no result. The tests are
// warp-uniform.
template <int NS>
__device__ __forceinline__ void test_staged(const StagedTri* st, int n,
                                            SegmentState<NS>& p) {
  for (int i = 0; i < n; ++i) {
    const float4 e0 = st[i].e[0], e1 = st[i].e[1], e2 = st[i].e[2];
    const float4 zp = st[i].z;
    const int tid = __float_as_int(zp.w);
    float y0[NS], y1[NS], y2[NS], yz[NS];
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      y0[s] = __fmul_rn(e0.y, p.yr[s]);
      y1[s] = __fmul_rn(e1.y, p.yr[s]);
      y2[s] = __fmul_rn(e2.y, p.yr[s]);
      yz[s] = __fmul_rn(zp.y, p.yr[s]);
    }
    const float sl = p.xlo[0], sh = p.xhi[kPixPerLane - 1];
    if (kPixPerLane > 1 &&
        !(inside(plane_max(e0, sl, sh, p.ylo, p.yhi), e0.w) &&
          inside(plane_max(e1, sl, sh, p.ylo, p.yhi), e1.w) &&
          inside(plane_max(e2, sl, sh, p.ylo, p.yhi), e2.w)))
      continue;
#pragma unroll
    for (int j = 0; j < kPixPerLane; ++j) {
      const float xl = p.xlo[j], xh = p.xhi[j];
      if (!(inside(plane_max(e0, xl, xh, p.ylo, p.yhi), e0.w) &&
            inside(plane_max(e1, xl, xh, p.ylo, p.yhi), e1.w) &&
            inside(plane_max(e2, xl, xh, p.ylo, p.yhi), e2.w)))
        continue;
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const float x = p.xr[j][s];
        const float v0 = __fadd_rn(__fadd_rn(__fmul_rn(e0.x, x), y0[s]), e0.z);
        const float v1 = __fadd_rn(__fadd_rn(__fmul_rn(e1.x, x), y1[s]), e1.z);
        const float v2 = __fadd_rn(__fadd_rn(__fmul_rn(e2.x, x), y2[s]), e2.z);
        const float z = __fadd_rn(__fadd_rn(__fmul_rn(zp.x, x), yz[s]), zp.z);
        const bool ok = inside(v0, e0.w) && inside(v1, e1.w) &&
                        inside(v2, e2.w) && z >= 0.0f && z <= 1.0f;
        if (ok && (z < p.zb[j][s] || (z == p.zb[j][s] && tid > p.wb[j][s]))) {
          p.zb[j][s] = z;
          p.wb[j][s] = tid;
        }
      }
    }
  }
}

// The pixel's fragment: the first covered sample (in sample order), its
// winner and offset, and the covered-sample count.
struct Fragment {
  int cnt, tid;
  float offx, offy;
};

template <int NS>
__device__ __forceinline__ Fragment first_covered(const int (&wb)[NS],
                                                  const Samples& S) {
  Fragment f{0, -1, 0.0f, 0.0f};
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    if (wb[s] >= 0) {
      if (f.cnt == 0) {
        f.tid = wb[s];
        f.offx = S.ox[s];
        f.offy = S.oy[s];
      }
      ++f.cnt;
    }
  }
  return f;
}

// The fused fragment stage of pixel (px, py) from its per-sample winners
// (vis: the frame's visibility table): the first covered sample's
// winner's attributes, Blinn-Phong or emissive, the shadow test, the
// coverage resolve. Returns rgba; *cf_out the covered fraction.
template <int NS>
__device__ __forceinline__ float4 shade_fused(const int (&wb)[NS],
                                              const Samples& S,
                                              const Shading& SH,
                                              const float* __restrict__ vis,
                                              int px, int py,
                                              float* cf_out) {
  const float* __restrict__ U = SH.uni;
  const Fragment f = first_covered<NS>(wb, S);
  if (f.cnt == 0) {
    *cf_out = 0.0f;
    return make_float4(U[kFuClear], U[kFuClear + 1], U[kFuClear + 2],
                       U[kFuClear + 3]);
  }

  // The winner's attribute/w at the sample, then / the interpolated 1/w.
  const Weights w =
      sample_weights(vis + (size_t)f.tid * kVis, px, py, f.offx, f.offy);
  const float* __restrict__ A = SH.attr + (size_t)f.tid * kAttr;
  const float invw = attr_at(A, kRowInvW, w);
  const float inv = 1.0f / (invw > 0.0f ? invw : 1.0f);
  const float wx = attr_at(A, kRowWorld, w) * inv;
  const float wy = attr_at(A, kRowWorld + 1, w) * inv;
  const float wz = attr_at(A, kRowWorld + 2, w) * inv;
  const float nx = attr_at(A, kRowNormal, w) * inv;
  const float ny = attr_at(A, kRowNormal + 1, w) * inv;
  const float nz = attr_at(A, kRowNormal + 2, w) * inv;
  const float cr = attr_at(A, kRowColor, w) * inv;
  const float cg = attr_at(A, kRowColor + 1, w) * inv;
  const float cb = attr_at(A, kRowColor + 2, w) * inv;
  const float kf = floorf(attr_at(A, kRowMatKind, w) * inv + 0.5f);
  const bool emissive = kf == kEmissive;
  const bool receives = kf == kBlinnPhongShadow;

  // Blinn-Phong (shade._blinn_phong_soa expression order).
  float vx = U[kFuCam] - wx, vy = U[kFuCam + 1] - wy, vz = U[kFuCam + 2] - wz;
  const float nv = 1.0f / sqrtf(vx * vx + vy * vy + vz * vz);
  vx = vx * nv; vy = vy * nv; vz = vz * nv;
  float lx = U[kFuLPos] - wx, ly = U[kFuLPos + 1] - wy, lz = U[kFuLPos + 2] - wz;
  const float nl = 1.0f / sqrtf(lx * lx + ly * ly + lz * lz);
  lx = lx * nl; ly = ly * nl; lz = lz * nl;
  float hx = lx + vx, hy = ly + vy, hz = lz + vz;
  const float nh = 1.0f / sqrtf(hx * hx + hy * hy + hz * hz);
  hx = hx * nh; hy = hy * nh; hz = hz * nh;
  const float diff = max0(nx * lx + ny * ly + nz * lz);
  const float spec = powf(max0(nx * hx + ny * hy + nz * hz), U[kFuShin]);
  const float s = U[kFuAmb] + diff + spec;
  float r = s * U[kFuLCol] * cr;
  float g = s * U[kFuLCol + 1] * cg;
  float b = s * U[kFuLCol + 2] * cb;
  if (emissive) { r = cr; g = cg; b = cb; }
  float a = 1.0f;

  // Shadow test (shade._shadow_factor_soa), receivers only.
  float msk = 1.0f;
  if (SH.smap != nullptr && receives) {
    const float* M = U + kFuM;
    const float lxp = M[0] * wx + M[1] * wy + M[2] * wz + M[3];
    const float lyp = M[4] * wx + M[5] * wy + M[6] * wz + M[7];
    const float lzp = M[8] * wx + M[9] * wy + M[10] * wz + M[11];
    const float lwp = M[12] * wx + M[13] * wy + M[14] * wz + M[15];
    const float ilw = 1.0f / lwp;
    const float uu = lxp * ilw * 0.5f + 0.5f;
    const float vv = (1.0f - lyp * ilw) * 0.5f;
    const float sd = lzp * ilw * 0.5f + 0.5f;
    if (uu >= 0.0f && uu <= 1.0f && vv >= 0.0f && vv <= 1.0f) {
      const float d =
          bilinear_repeat_unit(SH.smap, SH.tex_h, SH.tex_w, uu, vv);
      if ((sd - U[kFuBias]) > d) msk = U[kFuFactor];
    }
  }
  r = r * msk; g = g * msk; b = b * msk; a = a * msk;

  const float cf = (float)f.cnt * (1.0f / (float)NS);
  const float keep = 1.0f - cf;
  *cf_out = cf;
  return make_float4(r * cf + U[kFuClear] * keep, g * cf + U[kFuClear + 1] * keep,
                     b * cf + U[kFuClear + 2] * keep,
                     a * cf + U[kFuClear + 3] * keep);
}

// The tile walk of K1-K6: chunks [c_begin, c_end) of tile T's candidates
// (all of them, or one item's slice of a split tile). The tile's pixels
// are row segments of kSegW columns, one per warp and pass; a tile of any
// shape takes ceil(tile_h * ceil(tile_w / kSegW) / kTileWarps) passes (one
// for 8x128, eight for 64x128). The block walks part `part` of `n_parts`
// contiguous ranges of those passes (by default all of them). Candidates
// are staged at its first pass when they fit in one chunk, else chunk by
// chunk in every pass; every thread of the block calls stage_chunk, also
// in warps with no segment left. Then, on each of the lane's pixels inside
// the tile and the image, frag(zb, wb, px, py) with the pixel's per-sample
// depth and winner over those chunks, from (clear_depth, -1).
template <int NS, class Frag>
__device__ __forceinline__ void walk_tile(const Bins& B, const Samples& S,
                                          float clear_depth, int width,
                                          int height, const TileRef& T,
                                          int c_begin, int c_end,
                                          TileStage& st, Frag&& frag,
                                          int part = 0, int n_parts = 1) {
  const int segs_per_row = (B.tile_w + kSegW - 1) / kSegW;
  const int n_segs = B.tile_h * segs_per_row;
  const int n_passes = (n_segs + kTileWarps - 1) / kTileWarps;
  const int per_part = (n_passes + n_parts - 1) / n_parts * kTileWarps;
  const int g_begin = part * per_part;
  const int g_end = n_parts == 1 ? n_segs : min(n_segs, g_begin + per_part);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int n_staged = 0;
  for (int g0 = g_begin; g0 < g_end; g0 += kTileWarps) {
    const int g = g0 + warp;
    const int row = g / segs_per_row;
    const int seg0 = (g - row * segs_per_row) * kSegW;
    const int col = seg0 + lane;
    SegmentState<NS> p;
    float oxl = S.ox[0], oxh = S.ox[0], oyl = S.oy[0], oyh = S.oy[0];
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      oxl = fminf(oxl, S.ox[s]); oxh = fmaxf(oxh, S.ox[s]);
      oyl = fminf(oyl, S.oy[s]); oyh = fmaxf(oyh, S.oy[s]);
      p.yr[s] = __fadd_rn((float)row, S.oy[s]);
#pragma unroll
      for (int j = 0; j < kPixPerLane; ++j) {
        p.xr[j][s] = __fadd_rn((float)(col + 32 * j), S.ox[s]);
        p.zb[j][s] = clear_depth;
        p.wb[j][s] = -1;
      }
    }
    p.ylo = __fadd_rn((float)row, oyl);
    p.yhi = __fadd_rn((float)row, oyh);
#pragma unroll
    for (int j = 0; j < kPixPerLane; ++j) {
      p.xlo[j] = __fadd_rn((float)(seg0 + 32 * j), oxl);
      p.xhi[j] = __fadd_rn((float)(seg0 + 32 * j + 31), oxh);
    }
    for (int c = c_begin; c < c_end; ++c) {
      if (c_end - c_begin > 1 || g0 == g_begin)
        n_staged = stage_chunk(B, T, c, st);
      test_staged<NS>(st.tri, n_staged, p);
    }
    const int py = T.y0 + row;
#pragma unroll
    for (int j = 0; j < kPixPerLane; ++j) {
      const int cx = col + 32 * j;
      const int px = T.x0 + cx;
      if (g < g_end && cx < B.tile_w && px < width && py < height) {
        frag(p.zb[j], p.wb[j], px, py);
      }
    }
  }
}

// ---- The split walk of K2/K6 and K3/K5: long tile lists over blocks. ----
//
// A tile of more than tc chunks (its list plus the live big list,
// tile_chunks) is not walked by one block: it becomes ceil(chunks / lc)
// items, each of which walks its slice of lc chunks (L = lc * kChunk
// candidates) over every sample of the tile. A launch that may split runs
// two kernels: the split kernel (WORKERS), whose blocks find the split
// tiles on the device, queue their items and take them, and then the tile
// kernel, one block per tile and frame as before, in which a split tile's
// block exits at once. The tile kernel is the split kernel's programmatic
// dependent (sm_90): it starts while the split kernel runs, so short
// tiles and long tiles' items run side by side, and no list length
// reaches the host. Its code is the one-block walk alone: the workers'
// code in the same kernel raised its registers (120 -> 128 at 4 samples)
// and its time (PERF.md).
//
// Visibility is order-free, so a sample's winner over the whole tile is
// the lexicographic minimum of (z, -tid) over the items' own winners, each
// taken from (clear_depth, -1): every item merges its winners into one
// 64-bit key a sample with atomicMax (split_key), and the tile's last item
// to finish (a per-tile count) reads the keys back, resets them and the
// count to zero for the next launch, and runs the fragment stage on the
// merged winners. The planes stay anchored on the binning tile, so every
// item evaluates a candidate exactly as the one-block walk does.

// The launch's split state: head's counters, keys and done are zero
// between launches (the wrapper allocates them zeroed once; the split
// kernel's last block resets the counters, a tile's last item its keys
// and count). The items are written anew by every split launch.
struct Split {
  int tc;                      // a tile of more chunks is split
  int lc;                      // chunks per item
  int max_items, max_ranks;    // the wrapper's bounds
  int* head;                   // counters (kHead*), then the int4 items
  unsigned long long* keys;    // [ranks, NS, tile_h * tile_w]
  int* done;                   // [ranks] items of the tile finished
};

// head's counters.
constexpr int kHeadShare = 0;       // the next share of tiles to scan
constexpr int kHeadScanned = 1;     // shares scanned
constexpr int kHeadItems = 2;       // items queued
constexpr int kHeadRanks = 3;       // split tiles queued
constexpr int kHeadNext = 4;        // the next item to take
constexpr int kHeadExited = 5;      // split kernel blocks finished
constexpr int kHeadLastItems = 7;   // the last split launch's item count
constexpr int kHeadInts = 8;        // the items start here (32 B aligned)

__device__ __forceinline__ int4* split_items(const Split& X) {
  return reinterpret_cast<int4*>(X.head + kHeadInts);
}

// Let the launch that depends on this one start, and wait for the launch
// this one depends on to finish with its memory visible (programmatic
// dependent launch; a no-op in a launch that depends on none).
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}
__device__ __forceinline__ void wait_for_dependency() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// A winner (z, tid) as a key whose unsigned maximum is the lexicographic
// minimum of (z, -tid): take admits only 0 <= z <= 1, whose bits order as
// its values once -0.0 is folded onto +0.0 (take holds them equal); the
// tid (< 2^24) breaks ties, the larger winning, and the low bit keeps z's
// sign, so the merged depth is the winner's own z bits. 0 is no winner:
// every real key is above it.
__device__ __forceinline__ unsigned long long split_key(float z, int tid) {
  const unsigned bits = __float_as_uint(z);
  return ((unsigned long long)(0xffffffffu - (bits & 0x7fffffffu)) << 32) |
         ((unsigned)tid << 1) | (bits >> 31);
}

__device__ __forceinline__ void split_unkey(unsigned long long key,
                                            float clear_depth, float& z,
                                            int& tid) {
  if (key == 0ull) {
    z = clear_depth;
    tid = -1;
    return;
  }
  const unsigned hi = (unsigned)(key >> 32), lo = (unsigned)key;
  z = __uint_as_float((0xffffffffu - hi) | (lo << 31));
  tid = (int)(lo >> 1);
}

// The items of tile g = f * NT + t of the stacked bins: its chunks, as
// tile_chunks counts them, in items of lc if there are more than tc; 0
// where the tile is not split.
__device__ __forceinline__ int tile_slices(const Bins& B0, int g, int tc,
                                           int lc) {
  const int f = g / B0.n_tiles;
  const int t = g - f * B0.n_tiles;
  const int* off = B0.tile_off + (size_t)f * (B0.n_tiles + 1);
  const int chunks = (off[t + 1] - off[t] + B0.big_n[f] + kChunk - 1) / kChunk;
  return chunks > tc ? (chunks + lc - 1) / lc : 0;
}

// The split kernel's first step, in every block: take shares of kTileThreads
// tiles (all frames) until none is left, queue each split tile's items
// (tile f * NT + t, slice, rank, slices) and count the share; then wait
// until every share is scanned. A block only waits on shares that running
// blocks took, so no block waits on one that has not started. Past the
// wrapper's bounds it traps.
__device__ __forceinline__ void split_schedule(const Bins& B0, int frames,
                                               const Split& X) {
  __shared__ int s_share;
  const int total = B0.n_tiles * frames;
  const int shares = (total + kTileThreads - 1) / kTileThreads;
  int4* items = split_items(X);
  for (;;) {
    if (threadIdx.x == 0) s_share = atomicAdd(X.head + kHeadShare, 1);
    __syncthreads();
    const int sh = s_share;
    __syncthreads();
    if (sh >= shares) break;
    const int g = sh * kTileThreads + threadIdx.x;
    const int n = g < total ? tile_slices(B0, g, X.tc, X.lc) : 0;
    if (n > 0) {
      const int pos = atomicAdd(X.head + kHeadItems, n);
      const int rank = atomicAdd(X.head + kHeadRanks, 1);
      if (pos + n > X.max_items || rank >= X.max_ranks) __trap();
      for (int k = 0; k < n; ++k) items[pos + k] = make_int4(g, k, rank, n);
    }
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) atomicAdd(X.head + kHeadScanned, 1);
  }
  if (threadIdx.x == 0) {
    while (atomicAdd(X.head + kHeadScanned, 0) < shares) __nanosleep(100);
    __threadfence();
  }
  __syncthreads();
}

// f(px, py, p) on each pixel of tile T inside the image (p = row * tile_w
// + column), with walk_tile's lanes.
template <class F>
__device__ __forceinline__ void for_tile_pixels(const Bins& B,
                                                const TileRef& T, int width,
                                                int height, F&& f) {
  const int segs_per_row = (B.tile_w + kSegW - 1) / kSegW;
  const int n_segs = B.tile_h * segs_per_row;
  const int lane = threadIdx.x & 31;
  for (int g = threadIdx.x >> 5; g < n_segs; g += kTileWarps) {
    const int row = g / segs_per_row;
    const int col = (g - row * segs_per_row) * kSegW + lane;
    const int py = T.y0 + row;
#pragma unroll
    for (int j = 0; j < kPixPerLane; ++j) {
      const int cx = col + 32 * j;
      const int px = T.x0 + cx;
      if (cx < B.tile_w && px < width && py < height) {
        f(px, py, row * B.tile_w + cx);
      }
    }
  }
}

// A split kernel block: the schedule, then items until none is left; walks
// its slice, merges the winners into the tile's keys, and, as the tile's
// last item, runs frame f's fragment stage make_frag(f)(zb, wb, px, py) on
// the merged winners. The last block to finish resets the counters.
template <int NS, class MakeFrag>
__device__ __forceinline__ void split_worker(const Bins& B0, const Samples& S,
                                             float clear_depth, int width,
                                             int height, int frames,
                                             const Split& X, TileStage& st,
                                             MakeFrag&& make_frag) {
  __shared__ int s_item, s_last;
  launch_dependents();                       // the tile kernel may start
  split_schedule(B0, frames, X);
  const int n_items = __ldcg(X.head + kHeadItems);
  const int4* items = split_items(X);
  const int P = B0.tile_w * B0.tile_h;
  for (;;) {
    if (threadIdx.x == 0) s_item = atomicAdd(X.head + kHeadNext, 1);
    __syncthreads();
    const int i = s_item;
    __syncthreads();
    if (i >= n_items) break;
    const int4 it = __ldcg(items + i);
    const int f = it.x / B0.n_tiles;
    const Bins B = frame_bins(B0, f);
    const TileRef T = tile_ref(B, it.x - f * B0.n_tiles);
    const int c0 = it.y * X.lc;
    unsigned long long* __restrict__ K = X.keys + (size_t)it.z * NS * P;
    walk_tile<NS>(B, S, clear_depth, width, height, T, c0,
                  min(c0 + X.lc, tile_chunks(T)), st,
                  [&](const float (&zb)[NS], const int (&wb)[NS], int px,
                      int py) {
                    const int p = (py - T.y0) * B.tile_w + (px - T.x0);
#pragma unroll
                    for (int s = 0; s < NS; ++s) {
                      if (wb[s] >= 0) atomicMax(K + s * P + p,
                                                split_key(zb[s], wb[s]));
                    }
                  });
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
      s_last = atomicAdd(X.done + it.z, 1) == it.w - 1;
      if (s_last) X.done[it.z] = 0;
    }
    __syncthreads();
    if (s_last) {
      __threadfence();
      auto frag = make_frag(f);
      for_tile_pixels(B, T, width, height, [&](int px, int py, int p) {
        float zb[NS];
        int wb[NS];
#pragma unroll
        for (int s = 0; s < NS; ++s) {
          split_unkey(atomicExch(K + s * P + p, 0ull), clear_depth, zb[s],
                      wb[s]);
        }
        frag(zb, wb, px, py);
      });
    }
  }
  if (threadIdx.x == 0 &&
      atomicAdd(X.head + kHeadExited, 1) == (int)gridDim.x - 1) {
    X.head[kHeadLastItems] = n_items;
    for (int k = kHeadShare; k <= kHeadExited; ++k) X.head[k] = 0;
  }
}

// A tile kernel block (t, 0, f): walks tile t of frame f unless the tile
// is split (X.tc chunks; INT_MAX in a launch that splits none). In a split
// launch the grid's last block waits, once done, for the split kernel: the
// tile kernel then ends after it, so work after this launch finds every
// tile's pixels written.
template <int NS, class Frag>
__device__ __forceinline__ void tile_block(const Bins& B0, const Samples& S,
                                           float clear_depth, int width,
                                           int height, const Split& X,
                                           TileStage& st, Frag&& frag) {
  const Bins B = frame_bins(B0, blockIdx.z);
  const TileRef T = tile_ref(B, blockIdx.x);
  const int n_chunks = tile_chunks(T);
  if (n_chunks <= X.tc) {
    walk_tile<NS>(B, S, clear_depth, width, height, T, 0, n_chunks, st,
                  frag);
  }
  if (X.head != nullptr && threadIdx.x == 0 &&
      blockIdx.x == gridDim.x - 1 && blockIdx.z == gridDim.z - 1) {
    wait_for_dependency();
  }
}

// K2/K6's fragment stage at pixel (px, py) of the frame whose tables SH
// and B hold, stored at frame_o + py * width + px.
template <int NS>
__device__ __forceinline__ void store_fused(const int (&wb)[NS],
                                            const Samples& S,
                                            const Shading& SH, const Bins& B,
                                            size_t frame_o, int width,
                                            int px, int py,
                                            float4* __restrict__ rgba,
                                            float* __restrict__ covf) {
  float cf;
  const float4 c = shade_fused<NS>(wb, S, SH, B.vis, px, py, &cf);
  const size_t o = frame_o + (size_t)py * width + px;
  rgba[o] = c;
  covf[o] = cf;
}

// K2/K6: the fused fragment stage on the tile walk, one block per binning
// tile and frame; with WORKERS, the split kernel of the same launch.
template <int NS, bool WORKERS>
__global__ void __launch_bounds__(kTileThreads, kTileMinBlocks)
render_fused_kernel(Bins B0, Samples S, float clear_depth, Shading SH0,
                    int width, int height, int frames,
                    float4* __restrict__ rgba, float* __restrict__ covf,
                    Split X) {
  __shared__ TileStage st;
  if constexpr (WORKERS) {
    split_worker<NS>(B0, S, clear_depth, width, height, frames, X, st,
                     [&](int fr) {
      const Shading SH = frame_shading(SH0, B0.n_tris, fr);
      const Bins B = frame_bins(B0, fr);
      const size_t frame_o = (size_t)fr * width * height;
      return [=, &S](const float (&)[NS], const int (&wb)[NS], int px,
                     int py) {
        store_fused<NS>(wb, S, SH, B, frame_o, width, px, py, rgba, covf);
      };
    });
  } else {
    const int fr = blockIdx.z;
    const Shading SH = frame_shading(SH0, B0.n_tris, fr);
    const Bins B = frame_bins(B0, fr);
    const size_t frame_o = (size_t)fr * width * height;
    tile_block<NS>(B0, S, clear_depth, width, height, X, st,
                   [&](const float (&)[NS], const int (&wb)[NS], int px,
                       int py) {
                     store_fused<NS>(wb, S, SH, B, frame_o, width, px, py,
                                     rgba, covf);
                   });
  }
}

// K3/K5's fragment stage at pixel (px, py) of frame fr, whose bins are B,
// attribute rows start at A0 and gout planes at G: the 16 gout rows and,
// where depth is not null, the per-sample depth and winner.
template <int NS>
__device__ __forceinline__ void store_gbuffer(
    const float (&zb)[NS], const int (&wb)[NS], const Samples& S,
    const Bins& B, const float* __restrict__ A0, float* __restrict__ G,
    int fr, size_t plane, int width, int px, int py,
    float* __restrict__ depth, int* __restrict__ winner) {
  const size_t o = (size_t)py * width + px;
  if (depth != nullptr) {
    const size_t os = (size_t)fr * NS * plane + o;
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      depth[s * plane + os] = zb[s];
      winner[s * plane + os] = wb[s];
    }
  }
  const Fragment f = first_covered<NS>(wb, S);
  float v[kGoutRows - 1];
#pragma unroll
  for (int g = 0; g < kGoutRows - 1; ++g) v[g] = 0.0f;
  if (f.cnt > 0) {
    // The winner's 192-byte attribute row in 12 float4 loads (the wrapper
    // checks the 16-byte alignment).
    const float4* __restrict__ A4 =
        reinterpret_cast<const float4*>(A0 + (size_t)f.tid * kAttr);
    float a[kAttr];
#pragma unroll
    for (int q = 0; q < kAttr / 4; ++q) {
      const float4 t = A4[q];
      a[4 * q] = t.x;
      a[4 * q + 1] = t.y;
      a[4 * q + 2] = t.z;
      a[4 * q + 3] = t.w;
    }
    const Weights w = sample_weights(B.vis + (size_t)f.tid * kVis, px, py,
                                     f.offx, f.offy);
#pragma unroll
    for (int g = 0; g < kGoutRows - 1; ++g) v[g] = attr_at(a, g, w);
  }
#pragma unroll
  for (int g = 0; g < kGoutRows - 1; ++g) G[g * plane + o] = v[g];
  G[(kGoutRows - 1) * plane + o] = (float)f.cnt;
}

// K3/K5: the per-pixel G-buffer (raster_pallas.rasterize_tiles with
// attr_px=True, and rasterize_tiles_batch) on the tile walk, one block per
// binning tile and frame; with WORKERS, the split kernel of the same
// launch. gout rows 0-14 are the first covered sample's winner's raw
// value/w planes (binning.py ROW_*) at that sample's absolute position,
// row 15 the covered-sample count; an uncovered pixel is all zeros, stored
// by the same instructions. The per-sample depth and winner planes only
// when depth is not null.
template <int NS, bool WORKERS>
__global__ void __launch_bounds__(kTileThreads, kTileMinBlocks)
raster_gbuffer_kernel(Bins B0, Samples S, float clear_depth,
                      const float* __restrict__ attr, int width, int height,
                      int frames, float* __restrict__ gout,
                      float* __restrict__ depth, int* __restrict__ winner,
                      Split X) {
  __shared__ TileStage st;
  const size_t plane = (size_t)width * height;
  if constexpr (WORKERS) {
    split_worker<NS>(B0, S, clear_depth, width, height, frames, X, st,
                     [&](int fr) {
      const Bins B = frame_bins(B0, fr);
      const float* A0 = attr + (size_t)fr * B0.n_tris * kAttr;
      float* G = gout + (size_t)fr * kGoutRows * plane;
      return [=, &S](const float (&zb)[NS], const int (&wb)[NS], int px,
                     int py) {
        store_gbuffer<NS>(zb, wb, S, B, A0, G, fr, plane, width, px, py,
                          depth, winner);
      };
    });
  } else {
    const int fr = blockIdx.z;
    const Bins B = frame_bins(B0, fr);
    const float* __restrict__ A0 = attr + (size_t)fr * B0.n_tris * kAttr;
    float* __restrict__ G = gout + (size_t)fr * kGoutRows * plane;
    tile_block<NS>(B0, S, clear_depth, width, height, X, st,
                   [&](const float (&zb)[NS], const int (&wb)[NS], int px,
                       int py) {
                     store_gbuffer<NS>(zb, wb, S, B, A0, G, fr, plane, width,
                                       px, py, depth, winner);
                   });
  }
}

// K1/K4 with one sample hold a small SegmentState, so their instance asks
// for more blocks an SM than the others' 128-register cap allows.
constexpr int kDepthMinBlocks1 = 4;

// K1/K4: the depth-only raster (raster_pallas.rasterize_tiles with
// with_attrs=False, and rasterize_depth_batch) on the tile walk, one block
// per binning tile (blockIdx.x), part of its passes (blockIdx.y of
// gridDim.y) and frame (blockIdx.z). depth f32[F,S,H,W]; winner i32[F,S,H,W]
// only when not null.
template <int NS>
__global__ void __launch_bounds__(kTileThreads,
                                  NS == 1 ? kDepthMinBlocks1 : kTileMinBlocks)
raster_depth_kernel(Bins B0, Samples S, float clear_depth, int width,
                    int height, float* __restrict__ depth,
                    int* __restrict__ winner) {
  __shared__ TileStage st;
  const int fr = blockIdx.z;
  const size_t plane = (size_t)width * height;
  const size_t frame_o = (size_t)fr * NS * plane;
  const Bins B = frame_bins(B0, fr);
  const TileRef T = tile_ref(B, blockIdx.x);
  walk_tile<NS>(B, S, clear_depth, width, height, T, 0, tile_chunks(T), st,
                [&](const float (&zb)[NS], const int (&wb)[NS], int px,
                    int py) {
                  const size_t o = frame_o + (size_t)py * width + px;
#pragma unroll
                  for (int s = 0; s < NS; ++s) depth[s * plane + o] = zb[s];
                  if (winner != nullptr) {
#pragma unroll
                    for (int s = 0; s < NS; ++s) winner[s * plane + o] = wb[s];
                  }
                },
                blockIdx.y, gridDim.y);
}

Samples make_samples(int n, float ox0, float oy0, float ox1, float oy1,
                     float ox2, float oy2, float ox3, float oy3) {
  Samples S;
  S.n = n;
  S.ox[0] = ox0; S.oy[0] = oy0;
  S.ox[1] = ox1; S.oy[1] = oy1;
  S.ox[2] = ox2; S.oy[2] = oy2;
  S.ox[3] = ox3; S.oy[3] = oy3;
  return S;
}

dim3 grid_for(int width, int height, int frames) {
  return dim3((width + kBlockX - 1) / kBlockX, (height + kBlockY - 1) / kBlockY,
              frames);
}

Bins make_bins(const float* vis, const int* tile_off, const int* tile_tris,
               const int* big_ids, const int* big_aabb, const int* big_n,
               int tile_w, int tile_h, int ntx, int n_tris, int n_tile_tris,
               int big_cap, int height) {
  const int nty = (height + tile_h - 1) / tile_h;
  return Bins{vis,    tile_off, tile_tris, big_ids,  big_aabb,    big_n,
              tile_w, tile_h,   ntx,       ntx * nty, n_tris, n_tile_tris,
              big_cap};
}

// launch(std::integral_constant<int, NS>()) with NS = n (1..kMaxSamples):
// the tile kernels take the sample count as a template parameter.
template <class Launch>
int with_sample_count(int n, Launch&& launch) {
  switch (n) {
    case 1: return launch(std::integral_constant<int, 1>());
    case 2: return launch(std::integral_constant<int, 2>());
    case 3: return launch(std::integral_constant<int, 3>());
    case 4: return launch(std::integral_constant<int, 4>());
    default: return (int)cudaErrorInvalidValue;
  }
}

// A K2/K3/K5/K6 launch: with split_workers > 0, the split kernel (that
// many blocks), then the tile kernel as its dependent (programmatic
// dependent launch: it starts as soon as every split block runs); with
// none (no tile of these bins can exceed split_above chunks), the tile
// kernel alone. The wrapper's bounds: max_items items, max_ranks split
// tiles; split_head int[8 + 4 * max_items] (the counters, then the int4
// items), split_keys u64[max_ranks, NS, tile_h * tile_w] and split_done
// int[max_ranks], all zero.
struct SplitArgs {
  int above, chunks, max_items, max_ranks, workers;
  void *head, *keys, *done;
};

template <class Workers, class Tiles, class... Args>
int launch_tiles(Workers workers_kernel, Tiles tile_kernel, const Bins& B,
                 int frames, const SplitArgs& A, cudaStream_t stream,
                 Args... args) {
  Split X{INT_MAX, 1, 0, 0, nullptr, nullptr, nullptr};
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kTileThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  if (A.workers > 0) {
    if (A.above < 1 || A.chunks < 1 || A.max_items < 1 || A.max_ranks < 1 ||
        A.head == nullptr || A.keys == nullptr || A.done == nullptr)
      return (int)cudaErrorInvalidValue;
    X = Split{A.above,  A.chunks, A.max_items, A.max_ranks,
              static_cast<int*>(A.head),
              static_cast<unsigned long long*>(A.keys),
              static_cast<int*>(A.done)};
    cfg.gridDim = dim3(A.workers);
    const cudaError_t err = cudaLaunchKernelEx(&cfg, workers_kernel, args...,
                                               X);
    if (err != cudaSuccess) return (int)err;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
  }
  cfg.gridDim = dim3(B.n_tiles, 1, frames);
  return (int)cudaLaunchKernelEx(&cfg, tile_kernel, args..., X);
}

}  // namespace

// Every entry point takes F stacked frames (F == 1: one frame) and launches
// one grid of F frames. n_tris, n_tile_tris, big_cap: T, L and cap, the
// per-frame lengths of the stacked tables.
#define MR_BINS_PARAMS                                                     \
  const float *vis, const int *tile_off, const int *tile_tris,             \
      const int *big_ids, const int *big_aabb, const int *big_n,           \
      int tile_w, int tile_h, int ntx, int frames, int n_tris,             \
      int n_tile_tris, int big_cap, int n_samples, float ox0, float oy0,   \
      float ox1, float oy1, float ox2, float oy2, float ox3, float oy3,    \
      float clear_depth
#define MR_BINS_SETUP                                                      \
  const Bins B = make_bins(vis, tile_off, tile_tris, big_ids, big_aabb,    \
                           big_n, tile_w, tile_h, ntx, n_tris, n_tile_tris,\
                           big_cap, height);                               \
  const Samples S =                                                        \
      make_samples(n_samples, ox0, oy0, ox1, oy1, ox2, oy2, ox3, oy3)

// parts: each tile's passes split over that many blocks (gridDim.y);
// winner: nullptr for depth alone.
extern "C" int mr_raster_depth(MR_BINS_PARAMS, int width, int height,
                               int parts, float* depth, int* winner,
                               void* stream) {
  if (parts < 1 || parts > 65535) return (int)cudaErrorInvalidValue;
  MR_BINS_SETUP;
  return with_sample_count(n_samples, [&](auto ns) {
    raster_depth_kernel<decltype(ns)::value>
        <<<dim3(B.n_tiles, parts, frames), kTileThreads, 0,
           (cudaStream_t)stream>>>(B, S, clear_depth, width, height, depth,
                                   winner);
    return (int)cudaGetLastError();
  });
}

// The split plan of a K2/K3/K5/K6 launch (launch_tiles).
#define MR_SPLIT_PARAMS                                                    \
  int split_above, int split_chunks, int split_max_items,                  \
      int split_max_ranks, int split_workers, void *split_head,            \
      void *split_keys, void *split_done
#define MR_SPLIT_ARGS                                                      \
  SplitArgs{split_above,     split_chunks, split_max_items,                \
            split_max_ranks, split_workers, split_head,                    \
            split_keys,      split_done}

// depth/winner: nullptr unless the per-sample planes are wanted.
extern "C" int mr_raster_gbuffer(MR_BINS_PARAMS, const float* attr, int width,
                                 int height, float* gout, float* depth,
                                 int* winner, MR_SPLIT_PARAMS, void* stream) {
  MR_BINS_SETUP;
  return with_sample_count(n_samples, [&](auto ns) {
    constexpr int NS = decltype(ns)::value;
    return launch_tiles(raster_gbuffer_kernel<NS, true>,
                        raster_gbuffer_kernel<NS, false>, B, frames,
                        MR_SPLIT_ARGS, (cudaStream_t)stream, B, S,
                        clear_depth, attr, width, height, frames, gout,
                        depth, winner);
  });
}

// One frame (frames == 1): gout f32[S,16,H,W], depth f32[S,H,W], winner
// i32[S,H,W].
extern "C" int mr_raster_gbuffer_samples(MR_BINS_PARAMS, const float* attr,
                                         int width, int height, float* gout,
                                         float* depth, int* winner,
                                         void* stream) {
  if (frames != 1) return (int)cudaErrorInvalidValue;
  MR_BINS_SETUP;
  raster_gbuffer_samples_kernel<<<grid_for(width, height, 1),
                                  dim3(kBlockX, kBlockY), 0,
                                  (cudaStream_t)stream>>>(
      B, S, clear_depth, attr, width, height, gout, depth, winner);
  return (int)cudaGetLastError();
}

extern "C" int mr_render_fused(MR_BINS_PARAMS, const float* attr,
                               const float* uniforms, const float* shadow_map,
                               int tex_h, int tex_w, int width, int height,
                               float* rgba, float* covf, MR_SPLIT_PARAMS,
                               void* stream) {
  MR_BINS_SETUP;
  const Shading SH{attr, uniforms, shadow_map, tex_h, tex_w};
  return with_sample_count(n_samples, [&](auto ns) {
    constexpr int NS = decltype(ns)::value;
    return launch_tiles(render_fused_kernel<NS, true>,
                        render_fused_kernel<NS, false>, B, frames,
                        MR_SPLIT_ARGS, (cudaStream_t)stream, B, S,
                        clear_depth, SH, width, height, frames,
                        reinterpret_cast<float4*>(rgba), covf);
  });
}
