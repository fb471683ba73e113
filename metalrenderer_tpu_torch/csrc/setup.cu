// The main pass's geometry front end for Hopper (sm_90a), bound with a plain
// C interface and loaded with ctypes (metalrenderer_tpu_torch/raster/
// _build.py, raster/setup_cuda.py).
//
// What it replaces. No Pallas kernel: in the JAX package the prep is one
// XLA program, and this is its fusion of the camera projection
// (transforms.transform_points), the near clip with attributes
// (geometry.clip_near), the guard-band clip (geometry.guard_clip_xy),
// triangle setup (geometry.setup_triangles) and the per-triangle tables
// the raster kernels read (binning.build_tri_fields, build_attr_fields;
// metalrenderer_tpu/passes/pipeline.py prepare_main_pass). The port ran
// those as eager ops, each writing its intermediate to device memory:
// stacks and concatenations of [2T, 3, 12] arrays, then the 17- and
// 48-float rows assembled from strided views. Here every slot is computed
// in registers from its input triangle's three vertices and written once.
//
// What bounds it: bytes. A slot reads its triangle's world, uv and normal
// (96 B a triangle, shared by its two slots) and its material, and writes
// a vis row (17 floats), an attr row (48), its AABB (4) and a valid byte:
// 261 B a slot, ~0.55 GB for the 1M-triangle sphere's 2M slots, ~0.2 ms at
// 3.35 TB/s. Its operations (~400 a slot) take a tenth of that.
//
// Design for full-width stores. One thread a slot, a block a contiguous
// range of kBlock slots. A 68-byte or 192-byte row stored by its own
// thread would scatter each warp's stores over 32 rows, so every thread
// writes its rows into shared memory (vis rows packed, 17 floats apart;
// attr rows 49 floats apart: both strides odd, so a warp's row writes hit
// 32 banks), and after a barrier the block stores its whole range of each
// table as consecutive words, 128 bytes a warp and instruction. The AABB
// row is one float4 and the valid flag one byte, coalesced as they are.
//
// Three launches, one kernel family:
//   setup_tables_kernel   every near-clip slot 2t, 2t+1 of triangle t: its
//                         rows and, with the guard band on, its oversize
//                         flag (a byte key, 0 = oversize) and count;
//   setup_fans_kernel     the side list: the first `cap` slots of the
//                         stable sort of the keys (which torch sorts, as
//                         guard_clip_xy does), each near-clipped again,
//                         clipped against the four guard planes in clip
//                         space where oversize (Sutherland-Hodgman, the
//                         crossing in double-float: geometry._sh_clip_plane)
//                         and fanned into 5 pieces [5 cap, 3, 12]
//                         (geometry.guard_clip_xy);
//   setup_fixup_kernel    the killed originals (the first cap oversize
//                         slots: zeroed, so setup rejects them) and the
//                         fan pieces after slot 2T, and every oversize
//                         slot's stats.
// Stats: culled_triangles counts invalid slots (one integer atomic a
// block); max_screen_coord is the largest |screen| coordinate of a valid
// slot, a block max then atomicMax on the non-negative float's bits
// (deterministic); the oversize count gives the xyclip stats. Oversize
// slots count only in the fixup, which alone knows whether they died.
//
// Rounding: every expression keeps the eager chain's operation order and
// separate f32 roundings (nvcc -fmad=false; IEEE division for 1/w, t and
// 1/area), so the tables are bit-equal to the plain chain's
// (setup_cuda.main_pass_tables_plain), dead and killed rows included.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;        // slots a block, one a thread
constexpr int kVis = 17;           // binning.VIS_FIELDS
constexpr int kAttr = 48;          // binning.ATTR_FIELDS
constexpr int kAttrStride = 49;    // shared-memory attr row stride (odd)
constexpr int kK = 12;             // a vertex: clip xyzw | world | uv | normal
constexpr int kPoly = 8;           // geometry.POLY_VERTS: a guard-clipped
constexpr int kFan = kPoly - 3;    // polygon's vertices, padded; FAN_PIECES

}  // namespace

// Mirrored by raster/setup_cuda.py _Args (ctypes.Structure): pointers, then
// ints, then floats.
struct SetupArgs {
  const float* world;      // f32[3T, 3] baked positions (a triangle soup)
  const float* uvs;        // f32[3T, 2]
  const float* normals;    // f32[3T, 3]
  const int* mat_kind;     // i32[T]
  const float* mat_color;  // f32[T, 3]
  const int* tex_id;       // i32[T]
  const int* nmid;         // i32[T] normal-map id
  const float* vp;         // f32[4, 4] the camera's P @ V, row-major
  float* vis;              // f32[S, 17]
  float* attr;             // f32[S, 48]
  float* aabb;             // f32[S, 4]
  uint8_t* valid;          // bool[S]
  uint8_t* keys;           // u8[2T]: 0 oversize, 1 not (guard band on)
  int* counters;           // i32[3]: invalid slots, max |screen| bits, oversize
  const int64_t* ids;      // i64[cap]: the keys' stable sort, first cap
  float* fan;              // f32[5 cap, 3, 12]: the side list's fan pieces
  int n_tris;              // T
  int cap;                 // side-list capacity (0: guard band off)
  int cull;                // cull back faces
  float half_w, half_h;    // 0.5 * width, 0.5 * height
  float near_eps;
  float gx, gy;            // guard planes: |x| <= gx w, |y| <= gy w
};

namespace {

enum { kInvalid = 0, kMaxBits = 1, kOversize = 2 };

// Vertex `v` of the soup: clip = P @ V @ (world, 1) summed left to right
// over separately rounded products (transforms.matmul), then the
// attributes (pipeline's cat of world, uvs, normals).
__device__ __forceinline__ void load_vertex(const SetupArgs& a, int64_t v,
                                            float out[kK]) {
  const float wx = a.world[3 * v], wy = a.world[3 * v + 1],
              wz = a.world[3 * v + 2];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float* m = a.vp + 4 * j;
    out[j] = ((wx * m[0] + wy * m[1]) + wz * m[2]) + m[3];
  }
  out[4] = wx;
  out[5] = wy;
  out[6] = wz;
  out[7] = a.uvs[2 * v];
  out[8] = a.uvs[2 * v + 1];
  out[9] = a.normals[3 * v];
  out[10] = a.normals[3 * v + 1];
  out[11] = a.normals[3 * v + 2];
}

// clip_near's t of an edge crossing z = 0.
__device__ __forceinline__ float cross_t(float da, float db) {
  const float denom = da - db;
  return da / (denom == 0.f ? 1.f : denom);
}

// Slot `slot` of the near clip (geometry.clip_near): half 0 of triangle
// slot / 2 is its first output triangle, half 1 its second (zero unless
// two vertices lie in front). The rotation, the intersections and the
// where-chain are clip_near's, component by component.
__device__ __forceinline__ void near_clip(const SetupArgs& a, int64_t slot,
                                          float tri[3][kK]) {
  const int64_t t = slot >> 1;
  const bool second = slot & 1;
  float v[3][kK];
#pragma unroll
  for (int k = 0; k < 3; ++k) load_vertex(a, 3 * t + k, v[k]);
  const bool in0 = v[0][2] >= 0.f, in1 = v[1][2] >= 0.f, in2 = v[2][2] >= 0.f;
  const int count = int(in0) + int(in1) + int(in2);
  const int first_in = in0 ? 0 : (in1 ? 1 : (in2 ? 2 : 0));
  const int first_out = !in0 ? 0 : (!in1 ? 1 : (!in2 ? 2 : 0));
  const int r = count == 1 ? first_in
                           : (count == 2 ? (first_out + 1) % 3 : 0);
  // The rotated vertices: w[k] = v[(k + r) % 3].
  float w[3][kK];
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int c = 0; c < kK; ++c)
      w[k][c] = r == 0 ? v[k][c]
                       : (r == 1 ? v[(k + 1) % 3][c] : v[(k + 2) % 3][c]);
  const float d0 = w[0][2], d1 = w[1][2], d2 = w[2][2];
  const float t01 = cross_t(d0, d1), t12 = cross_t(d1, d2),
              t20 = cross_t(d2, d0);
#pragma unroll
  for (int c = 0; c < kK; ++c) {
    const float i01 = w[0][c] + t01 * (w[1][c] - w[0][c]);
    const float i12 = w[1][c] + t12 * (w[2][c] - w[1][c]);
    const float i20 = w[2][c] + t20 * (w[0][c] - w[2][c]);
    if (!second) {
      tri[0][c] = count == 0 ? 0.f : w[0][c];
      tri[1][c] = count >= 2 ? w[1][c] : (count == 1 ? i01 : 0.f);
      tri[2][c] = count == 3 ? w[2][c]
                             : (count == 2 ? i12 : (count == 1 ? i20 : 0.f));
    } else {
      tri[0][c] = count == 2 ? w[0][c] : 0.f;
      tri[1][c] = count == 2 ? i12 : 0.f;
      tri[2][c] = count == 2 ? i20 : 0.f;
    }
  }
}

// guard_clip_xy's test: every w > 0 and some vertex beyond a guard plane.
__device__ __forceinline__ bool oversize(const SetupArgs& a,
                                         const float tri[3][kK]) {
  bool w_pos = true, beyond = false;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float w = tri[k][3];
    w_pos = w_pos && w > 0.f;
    beyond = beyond || fabsf(tri[k][0]) > a.gx * w ||
             fabsf(tri[k][1]) > a.gy * w;
  }
  return w_pos && beyond;
}

// torch.amin / amax over three values: a NaN wins.
__device__ __forceinline__ float min_nan(float x, float y) {
  return (isnan(x) || x < y) ? x : y;
}
__device__ __forceinline__ float max_nan(float x, float y) {
  return (isnan(x) || x > y) ? x : y;
}

// Triangle setup of one slot (geometry.setup_triangles, scalar_planes for
// z, build_tri_fields, build_attr_fields), material from triangle
// `parent`: writes the vis row (17 floats) and the attr row (48) where
// they point, the AABB and valid flag at `slot`; returns valid, and the
// slot's largest |screen| coordinate in `max_abs`.
__device__ __forceinline__ bool setup_slot(const SetupArgs& a,
                                           const float tri[3][kK],
                                           int64_t parent, int64_t slot,
                                           float* vis_row, float* attr_row,
                                           float& max_abs) {
  float sx[3], sy[3], z[3], iw[3];
  bool w_ok = true;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float w = tri[k][3];
    const bool ok = w > a.near_eps;
    w_ok = w_ok && ok;
    iw[k] = 1.f / (ok ? w : 1.f);
    const float nx = tri[k][0] * iw[k], ny = tri[k][1] * iw[k];
    z[k] = tri[k][2] * iw[k];
    sx[k] = (nx + 1.f) * a.half_w;
    sy[k] = (1.f - ny) * a.half_h;
  }
  const float area2 = (sx[1] - sx[0]) * (sy[2] - sy[0]) -
                      (sy[1] - sy[0]) * (sx[2] - sx[0]);
  const bool front = area2 < 0.f;
  const bool facing_ok = a.cull ? front : area2 != 0.f;
  const float orient = a.cull ? -1.f : (front ? -1.f : 1.f);
  float e[3][3];
  bool tl[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int j = (i + 1) % 3;
    const float dxo = (sx[j] - sx[i]) * orient;
    const float dyo = (sy[j] - sy[i]) * orient;
    e[i][0] = -dyo;
    e[i][1] = dxo;
    e[i][2] = dyo * sx[i] - dxo * sy[i];
    tl[i] = (dyo == 0.f && dxo > 0.f) || dyo < 0.f;
  }
  const float area_pos = orient * area2;
  const bool valid = w_ok && facing_ok && area_pos > 0.f;
  const float inv_area = area_pos > 0.f ? 1.f / area_pos : 0.f;

#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int c = 0; c < 3; ++c) vis_row[3 * i + c] = e[i][c];
  // z plane: lambda_i is edge (i + 1) % 3 times 1/area.
#pragma unroll
  for (int c = 0; c < 3; ++c)
    vis_row[9 + c] = (z[0] * (e[1][c] * inv_area) +
                      z[1] * (e[2][c] * inv_area)) +
                     z[2] * (e[0][c] * inv_area);
#pragma unroll
  for (int i = 0; i < 3; ++i) vis_row[12 + i] = tl[i] ? 1.f : 0.f;
  vis_row[15] = valid ? 1.f : 0.f;
  vis_row[16] = float(slot);

  const float consts[6] = {float(a.mat_kind[parent]), float(a.tex_id[parent]),
                           a.mat_color[3 * parent], a.mat_color[3 * parent + 1],
                           a.mat_color[3 * parent + 2], float(a.nmid[parent])};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float* row = attr_row + 16 * k;
#pragma unroll
    for (int c = 0; c < 8; ++c) row[c] = tri[k][4 + c] * iw[k];
    row[8] = iw[k];
#pragma unroll
    for (int c = 0; c < 6; ++c) row[9 + c] = consts[c] * iw[k];
    row[15] = 0.f;
  }

  const float4 box = make_float4(min_nan(min_nan(sx[0], sx[1]), sx[2]),
                                 min_nan(min_nan(sy[0], sy[1]), sy[2]),
                                 max_nan(max_nan(sx[0], sx[1]), sx[2]),
                                 max_nan(max_nan(sy[0], sy[1]), sy[2]));
  reinterpret_cast<float4*>(a.aabb)[slot] = box;
  a.valid[slot] = valid;
  float m = 0.f;
#pragma unroll
  for (int k = 0; k < 3; ++k)
    m = fmaxf(m, fmaxf(fabsf(sx[k]), fabsf(sy[k])));
  max_abs = valid ? m : 0.f;
  return valid;
}

// Knuth TwoSum and Dekker TwoProd (geometry._two_sum, _two_prod).
__device__ __forceinline__ float two_sum(float a, float b, float& err) {
  const float s = a + b;
  const float bb = s - a;
  err = (a - (s - bb)) + (b - bb);
  return s;
}
__device__ __forceinline__ void split(float x, float& hi, float& lo) {
  const float c = x * 4097.f;
  hi = c - (c - x);
  lo = x - hi;
}
__device__ __forceinline__ float two_prod(float a, float b, float& err) {
  const float p = a * b;
  float ahi, alo, bhi, blo;
  split(a, ahi, alo);
  split(b, bhi, blo);
  err = (((ahi * bhi - p) + ahi * blo) + alo * bhi) + alo * blo;
  return p;
}

// One Sutherland-Hodgman pass (geometry._sh_clip_plane) over the polygon
// v[0..n) against a guard plane, inside where its signed distance
// g w - v[axis] (g_first) or v[axis] + g w is >= 0: each kept vertex, then
// its edge's crossing point, in order, the crossing interpolated in
// double-float (TwoSum, TwoProd) and rounded once. Slots from the new n on
// are zero, as the chain's scatter leaves them.
__device__ void sh_clip_plane(float v[kPoly][kK], int& n, float g, int axis,
                              bool g_first) {
  float dist[kPoly];
#pragma unroll
  for (int i = 0; i < kPoly; ++i)
    dist[i] = g_first ? g * v[i][3] - v[i][axis] : v[i][axis] + g * v[i][3];
  float out[kPoly][kK];
  int m = 0;
  for (int i = 0; i < n; ++i) {
    const int nx = i + 1 >= n ? 0 : i + 1;
    const bool inside = dist[i] >= 0.f;
    const bool cross = inside != (dist[nx] >= 0.f);
    if (inside && m < kPoly) {
#pragma unroll
      for (int c = 0; c < kK; ++c) out[m][c] = v[i][c];
    }
    m += inside;
    if (cross && m < kPoly) {
      const float denom = dist[i] - dist[nx];
      const float t = dist[i] / (denom == 0.f ? 1.f : denom);
#pragma unroll
      for (int c = 0; c < kK; ++c) {
        float dv_e, p1_e, s_e;
        const float dv = two_sum(v[nx][c], -v[i][c], dv_e);
        const float p1 = two_prod(t, dv, p1_e);
        const float s = two_sum(v[i][c], p1, s_e);
        out[m][c] = s + ((s_e + p1_e) + t * dv_e);
      }
    }
    m += cross;
  }
  n = m < kPoly ? m : kPoly;
  for (int i = 0; i < kPoly; ++i)
#pragma unroll
    for (int c = 0; c < kK; ++c) v[i][c] = i < n ? out[i][c] : 0.f;
}

// The side list's fan pieces (geometry.guard_clip_xy) of entry j: slot
// ids[j] near-clipped, clipped against the four guard planes where it is
// oversize (else nothing) and fanned as (v0, v_k+1, v_k+2), k < 5, zero
// where the polygon has fewer than k + 3 vertices.
__device__ void side_fans(const SetupArgs& a, int j) {
  const int64_t slot = a.ids[j];
  float v[kPoly][kK];
  near_clip(a, slot, v);
  for (int i = 3; i < kPoly; ++i)
#pragma unroll
    for (int c = 0; c < kK; ++c) v[i][c] = 0.f;
  int n = a.keys[slot] == 0 ? 3 : 0;
  sh_clip_plane(v, n, a.gx, 0, true);     // gx w - x
  sh_clip_plane(v, n, a.gx, 0, false);    // x + gx w
  sh_clip_plane(v, n, a.gy, 1, true);     // gy w - y
  sh_clip_plane(v, n, a.gy, 1, false);    // y + gy w
  float* out = a.fan + int64_t(j) * kFan * 3 * kK;
  for (int k = 0; k < kFan; ++k) {
    const bool ok = n >= k + 3;
    const int corner[3] = {0, k + 1, k + 2};
#pragma unroll
    for (int q = 0; q < 3; ++q)
#pragma unroll
      for (int c = 0; c < kK; ++c)
        out[(k * 3 + q) * kK + c] = ok ? v[corner[q]][c] : 0.f;
  }
}

// The block's invalid-slot count and largest |screen| bits into the
// counters: one atomic each a block. Every thread of the block calls it.
__device__ void add_stats(int* counters, bool invalid, float max_abs) {
  __shared__ unsigned warp_max[kBlock / 32];
  const int n_invalid = __syncthreads_count(invalid);
  const unsigned bits =
      __reduce_max_sync(0xffffffffu, __float_as_uint(max_abs));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = bits;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned m = 0;
#pragma unroll
    for (int w = 0; w < kBlock / 32; ++w)
      m = warp_max[w] > m ? warp_max[w] : m;
    if (n_invalid) atomicAdd(counters + kInvalid, n_invalid);
    if (m) atomicMax(reinterpret_cast<unsigned*>(counters + kMaxBits), m);
  }
}

__global__ void __launch_bounds__(kBlock)
    setup_tables_kernel(const SetupArgs a) {
  __shared__ float s_vis[kBlock * kVis];
  __shared__ float s_attr[kBlock * kAttrStride];
  const int64_t slots = 2 * int64_t(a.n_tris);
  const int64_t s0 = int64_t(blockIdx.x) * kBlock;
  const int n = slots - s0 < kBlock ? int(slots - s0) : kBlock;
  const int64_t s = s0 + threadIdx.x;
  bool over = false, invalid = false;
  float max_abs = 0.f;
  if (int(threadIdx.x) < n) {
    float tri[3][kK];
    near_clip(a, s, tri);
    if (a.cap > 0) {
      over = oversize(a, tri);
      a.keys[s] = over ? 0 : 1;
    }
    // An oversize slot's rows are written as if it survives; the fixup
    // zeroes it if it dies, and counts its stats either way.
    float m;
    const bool valid =
        setup_slot(a, tri, s >> 1, s, s_vis + threadIdx.x * kVis,
                   s_attr + threadIdx.x * kAttrStride, m);
    if (!over) {
      invalid = !valid;
      max_abs = m;
    }
  }
  if (a.cap > 0) {
    const int n_over = __syncthreads_count(over);
    if (threadIdx.x == 0 && n_over) atomicAdd(a.counters + kOversize, n_over);
  }
  add_stats(a.counters, invalid, max_abs);   // its barriers order s_vis/s_attr
  float* vis = a.vis + s0 * kVis;
  for (int i = threadIdx.x; i < n * kVis; i += kBlock) vis[i] = s_vis[i];
  float* attr = a.attr + s0 * kAttr;
  for (int i = threadIdx.x; i < n * kAttr; i += kBlock) {
    const int row = i / kAttr;
    attr[i] = s_attr[row * kAttrStride + (i - row * kAttr)];
  }
}

__global__ void setup_fans_kernel(const SetupArgs a) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j < a.cap) side_fans(a, j);
}

__global__ void __launch_bounds__(kBlock)
    setup_fixup_kernel(const SetupArgs a) {
  const int64_t slots = 2 * int64_t(a.n_tris);
  const int64_t s = int64_t(blockIdx.x) * kBlock + threadIdx.x;
  bool invalid = false;
  float max_abs = 0.f;
  float tri[3][kK];
  int64_t parent = -1;
  if (s < slots) {
    if (a.keys[s] == 0) {
      // Killed: the first min(oversize, cap) oversize slots, which lead
      // the keys' stable sort in slot order.
      const int n_live = min(a.counters[kOversize], a.cap);
      const int64_t last = n_live > 0 ? a.ids[n_live - 1] : -1;
      if (s <= last) {
#pragma unroll
        for (int k = 0; k < 3; ++k)
#pragma unroll
          for (int c = 0; c < kK; ++c) tri[k][c] = 0.f;
      } else {
        near_clip(a, s, tri);
      }
      parent = s >> 1;
    }
  } else if (s < slots + int64_t(kFan) * a.cap) {
    const int64_t j = s - slots;
    const float* in = a.fan + j * 3 * kK;
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int c = 0; c < kK; ++c) tri[k][c] = in[k * kK + c];
    parent = a.ids[j / kFan] >> 1;
  }
  if (parent >= 0) {
    // A surviving oversize slot rewrites the rows the first pass wrote.
    const bool valid = setup_slot(a, tri, parent, s, a.vis + s * kVis,
                                  a.attr + s * kAttr, max_abs);
    invalid = !valid;
  }
  add_stats(a.counters, invalid, max_abs);
}

int launch_error() { return (int)cudaGetLastError(); }

}  // namespace

extern "C" int mr_setup_tables(const SetupArgs* a, void* stream) {
  const int64_t slots = 2 * int64_t(a->n_tris);
  if (slots == 0) return 0;
  const int64_t blocks = (slots + kBlock - 1) / kBlock;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  setup_tables_kernel<<<unsigned(blocks), kBlock, 0, (cudaStream_t)stream>>>(
      *a);
  return launch_error();
}

extern "C" int mr_setup_fans(const SetupArgs* a, void* stream) {
  if (a->cap <= 0) return 0;
  setup_fans_kernel<<<(a->cap + 31) / 32, 32, 0, (cudaStream_t)stream>>>(*a);
  return launch_error();
}

extern "C" int mr_setup_fixup(const SetupArgs* a, void* stream) {
  if (a->cap <= 0) return 0;
  const int64_t total = 2 * int64_t(a->n_tris) + int64_t(kFan) * a->cap;
  const int64_t blocks = (total + kBlock - 1) / kBlock;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  setup_fixup_kernel<<<unsigned(blocks), kBlock, 0, (cudaStream_t)stream>>>(
      *a);
  return launch_error();
}
