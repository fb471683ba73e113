// Texture-sampling kernels for Hopper (sm_90a), bound with a plain C
// interface and loaded with ctypes (metalrenderer_tpu_torch/raster/_build.py).
//
// K7 sample_bilinear_kernel replaces the windowed single-channel sampler
//    (metalrenderer_tpu/raster/sample_pallas.py: sample_bilinear_tiled ->
//    _sample_padded): bilinear, REPEAT or CLAMP, masked-out pixels read
//    oob_value. On the split path it is the shadow-map test.
// K8 is the same kernel over a frame batch, replacing
//    sample_pallas.sample_bilinear_tiled_batch -> _sample_padded_frames:
//    one texture per frame, tex f32[F, TH, TW] sampled at f32[F, H, W]
//    grids in one launch. The frame is blockIdx.z; its planes and its map
//    start at size_t offsets f*H*W and f*TH*TW, and the frame never enters
//    the float coordinates, so K8 is bit-equal to K7 run frame by frame. A
//    K7 launch is the batch of one ([S, H, W] sample planes against one map
//    are one frame of S*H*W pixels).
// K9 sample_pyramid_kernel replaces the mip-pyramid sampler
//    (metalrenderer_tpu/raster/mip_pallas.py: sample_pyramid_tiled ->
//    _sample_padded): trilinear over a mip chain, 3 channels, LOD clipped
//    to the chain, masked-out pixels 0. On the split path it samples the
//    normal maps and the color textures.
//
// What the TPU kernels are built around does not carry over. They DMA a
// window of the texture per 8x128 tile into VMEM, with a segment sweep (K7)
// or per-tile visit lists and a LOD escalation (K9) for footprints the
// window misses. Here the whole texture stays in the 50 MB L2 (a 1024^2
// shadow map is 4 MB, a 256^2 RGBA mip chain 1.4 MB), so a thread reads
// its four taps (per level) straight from global memory: exact everywhere,
// as sampling.sample_bilinear / sample_trilinear.
//
// K7/K8: per sampled pixel 13 bytes of streams (a mask byte, u, v; one
// float out) and four 4-byte taps from L2. A thread per pixel made each
// pixel three dependent memory round trips (the mask byte, then u and v,
// then the taps) with nothing else in flight, and paid four runtime
// modulos (REPEAT) and a division (the frame) for 13 bytes: latency-bound,
// at twice its byte bound. Now a thread takes two quads of 4 consecutive
// pixels, 32 quads apart, so that each load of a warp covers 32
// consecutive quads: both quads' masks as one 4-byte word each, then
// their u and v as float4s (only for a quad with a sampled pixel: the
// bytes stay those the bound counts), then all 32 taps, each pixel's four
// issued right after its coordinates and all before the first lerp, then
// float4 stores. Three round trips now serve 8 pixels; 64 registers, 4
// blocks of 256 an SM. Measured against 4 pixels a thread at full
// occupancy, 8 consecutive pixels a thread (half-sector loads), 128 and
// 512 threads a block, evict-first streams (__ldcs/__stcs: slower) and a
// persistent grid that keeps the streams in flight as bulk copies
// (cp.async.bulk into a 4-stage ring of shared memory, an mbarrier each:
// it copies u and v of every pixel, 31 MB against 24: 1.4-2.2x slower);
// see PERF.md. REPEAT takes no modulo where both taps of an axis lie in
// the texture (u, v in [0, 1] on the shadow lookup, but at the borders)
// and one % otherwise, the second tap from the first; the indices equal
// torch.remainder's for every input. What bounds it now: bytes and a
// launch's fixed cost (1.5x its byte bound; with no pixel sampled it
// still takes most of its time).
//
// Alignment: a frame's whole quads start at its first pixel whose mask
// byte is 4-byte aligned (without a mask: whose u is 16-byte aligned);
// the pixels before it (the head) and after its last whole quad (the
// tail) take scalar accesses, as do all of a frame's pixels when u, v and
// out are not 16-byte aligned there (views of other phases). Each frame
// finds its own head, so a K8 quad never straddles two frames whatever
// H*W is.
//
// K9 keeps its one-pixel-a-thread form and its helpers (wrap_index, taps):
// per pixel it moves 25 bytes and does ~100 FP32 operations over two
// levels, and runs at 1.2x its byte bound.
//
// Rounding: the coordinate transform and the lerps are the reference's
// expressions, x = u*w - 0.5, top = t00*(1-fx) + t10*fx, ..., each multiply
// and add rounded on its own (-fmad=false), as in the torch twins.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;
constexpr int kMaxLevels = 16;

// --- K9's helpers ------------------------------------------------------------

__device__ __forceinline__ int wrap_index(int i, int n, int repeat) {
  if (repeat) {
    const int r = i % n;
    return r < 0 ? r + n : r;
  }
  return min(max(i, 0), n - 1);
}

struct Taps {
  int a, b;      // texel offsets of the two rows
  int xa, xb;    // texel columns
  float fx, fy;
};

// sampling.sample_bilinear's footprint: half-texel centres, indices
// wrapped (REPEAT) or clamped (CLAMP).
__device__ __forceinline__ Taps taps(float u, float v, int h, int w,
                                     int repeat) {
  const float x = u * (float)w - 0.5f;
  const float y = v * (float)h - 0.5f;
  const float x0 = floorf(x);
  const float y0 = floorf(y);
  Taps t;
  t.fx = x - x0;
  t.fy = y - y0;
  const int xi = (int)x0;
  const int yi = (int)y0;
  t.xa = wrap_index(xi, w, repeat);
  t.xb = wrap_index(xi + 1, w, repeat);
  t.a = wrap_index(yi, h, repeat) * w;
  t.b = wrap_index(yi + 1, h, repeat) * w;
  return t;
}

__device__ __forceinline__ float lerp2(float t00, float t10, float t01,
                                       float t11, float fx, float fy) {
  const float top = t00 * (1.0f - fx) + t10 * fx;
  const float bot = t01 * (1.0f - fx) + t11 * fx;
  return top * (1.0f - fy) + bot * fy;
}

// --- K7/K8 -------------------------------------------------------------------

constexpr int kQuads = 2;        // quads (4 pixels) a thread: 8 pixels
constexpr int kMinBlocks = 4;    // blocks an SM the registers allow (64 each)
constexpr int kBlockQuads = kBlock * kQuads;

// The pair (i, i + 1) of tap indices on an axis of n texels: REPEAT as
// torch.remainder (floor modulo; one % only where i lies outside [0, n),
// the second tap from the first) or CLAMP.
__device__ __forceinline__ int2 axis_pair(int i, int n, int repeat) {
  if (!repeat)
    return make_int2(min(max(i, 0), n - 1), min(max(i + 1, 0), n - 1));
  int a = i;
  if ((unsigned)i >= (unsigned)n) {
    a = i % n;
    a = a < 0 ? a + n : a;
  }
  return make_int2(a, a + 1 == n ? 0 : a + 1);
}

// Four consecutive pixels of a frame, from pixel i (vec: by vectors, i
// 16-byte aligned in u, v and out, 4-byte aligned in the mask; else one
// pixel at a time, those in [0, hw)).
struct Quad {
  int i;
  bool vec;
  uint32_t m;              // byte k != 0: pixel i + k is sampled
  float u[4], v[4];        // 0.5 where not loaded
};

__device__ __forceinline__ bool sampled(uint32_t m, int k) {
  return ((m >> (8 * k)) & 0xff) != 0;
}

// The quad's mask: one 4-byte word, or its bytes one by one (mask
// nullptr: every pixel of the frame sampled).
__device__ __forceinline__ uint32_t quad_mask(const Quad& q,
                                              const uint8_t* mask, int hw) {
  if (q.vec)
    return mask == nullptr
        ? 0x01010101u
        : *reinterpret_cast<const uint32_t*>(mask + q.i);
  uint32_t w = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (q.i + k >= 0 && q.i + k < hw && (mask == nullptr || mask[q.i + k]))
      w |= 1u << (8 * k);
  return w;
}

// The quad's u and v: a float4 each where a pixel is sampled, or a float
// each sampled pixel.
__device__ __forceinline__ void quad_uv(Quad& q, const float* u,
                                        const float* v) {
  if (q.vec) {
    float4 a = make_float4(0.5f, 0.5f, 0.5f, 0.5f), c = a;
    if (q.m != 0) {
      a = *reinterpret_cast<const float4*>(u + q.i);
      c = *reinterpret_cast<const float4*>(v + q.i);
    }
    q.u[0] = a.x; q.u[1] = a.y; q.u[2] = a.z; q.u[3] = a.w;
    q.v[0] = c.x; q.v[1] = c.y; q.v[2] = c.z; q.v[3] = c.w;
    return;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const bool s = sampled(q.m, k);
    q.u[k] = s ? u[q.i + k] : 0.5f;
    q.v[k] = s ? v[q.i + k] : 0.5f;
  }
}

// A thread's quads: their masks, then their u and v, then every tap (a
// pixel's four right after its coordinates, all before the first lerp),
// then the lerps (sampling.sample_bilinear, oob_value where not sampled)
// and the stores.
__device__ __forceinline__ void run_quads(Quad (&q)[kQuads],
                                          const float* __restrict__ tf,
                                          int th, int tw, const float* u,
                                          const float* v,
                                          const uint8_t* mask,
                                          float oob_value, int repeat, int hw,
                                          float* out) {
#pragma unroll
  for (int j = 0; j < kQuads; ++j)
    q[j].m = q[j].i < hw ? quad_mask(q[j], mask, hw) : 0u;
#pragma unroll
  for (int j = 0; j < kQuads; ++j) quad_uv(q[j], u, v);
  float fx[kQuads][4], fy[kQuads][4], t[kQuads][4][4];
#pragma unroll
  for (int j = 0; j < kQuads; ++j)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      // A pixel not sampled takes the texture's centre: no modulo for it.
      const bool s = sampled(q[j].m, k);
      const float x = (s ? q[j].u[k] : 0.5f) * (float)tw - 0.5f;
      const float y = (s ? q[j].v[k] : 0.5f) * (float)th - 0.5f;
      const float x0 = floorf(x);
      const float y0 = floorf(y);
      fx[j][k] = x - x0;
      fy[j][k] = y - y0;
      const int2 xs = axis_pair((int)x0, tw, repeat);
      const int2 ys = axis_pair((int)y0, th, repeat);
      const float* r0 = tf + ys.x * tw;
      const float* r1 = tf + ys.y * tw;
      t[j][k][0] = s ? __ldg(r0 + xs.x) : 0.0f;
      t[j][k][1] = s ? __ldg(r0 + xs.y) : 0.0f;
      t[j][k][2] = s ? __ldg(r1 + xs.x) : 0.0f;
      t[j][k][3] = s ? __ldg(r1 + xs.y) : 0.0f;
    }
#pragma unroll
  for (int j = 0; j < kQuads; ++j) {
    float r[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      r[k] = sampled(q[j].m, k) ? lerp2(t[j][k][0], t[j][k][1], t[j][k][2],
                                        t[j][k][3], fx[j][k], fy[j][k])
                                : oob_value;
    if (q[j].i >= hw) continue;
    if (q[j].vec) {
      *reinterpret_cast<float4*>(out + q[j].i) =
          make_float4(r[0], r[1], r[2], r[3]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (q[j].i + k >= 0 && q[j].i + k < hw) out[q[j].i + k] = r[k];
    }
  }
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return ((uintptr_t)p & 15) == 0;
}

// Grid (quads / kBlockQuads, 1, frames). A frame's whole quads start at
// its first pixel whose mask byte is 4-byte aligned (without a mask: whose
// u is 16-byte aligned), if u, v and out are 16-byte aligned there too;
// the head before it is one scalar quad. Otherwise the frame is scalar
// from pixel 0. A thread's quads are a warp's width apart, so that each
// load of a warp covers 32 consecutive quads.
__global__ void __launch_bounds__(kBlock, kMinBlocks)
sample_bilinear_kernel(const float* __restrict__ tex, int th, int tw,
                       const float* __restrict__ u,
                       const float* __restrict__ v,
                       const uint8_t* __restrict__ mask, float oob_value,
                       int repeat, int hw, float* __restrict__ out) {
  const size_t off = (size_t)blockIdx.z * hw;
  u += off;
  v += off;
  out += off;
  if (mask != nullptr) mask += off;
  const int head = mask != nullptr ? (int)((4 - (uintptr_t)mask % 4) % 4)
                                   : (int)((16 - (uintptr_t)u % 16) % 16 / 4);
  const bool vec = aligned16(u + head) && aligned16(v + head) &&
                   aligned16(out + head);
  const int first = vec ? head - 4 : 0;
  const int quad = (int)blockIdx.x * kBlockQuads +
                   (threadIdx.x >> 5) * 32 * kQuads + (threadIdx.x & 31);
  Quad q[kQuads];
#pragma unroll
  for (int j = 0; j < kQuads; ++j) {
    q[j].i = first + 4 * (quad + 32 * j);
    q[j].vec = vec && q[j].i >= 0 && q[j].i + 4 <= hw;
  }
  if (q[0].i >= hw) return;
  run_quads(q, tex + (size_t)blockIdx.z * th * tw, th, tw, u, v, mask,
            oob_value, repeat, hw, out);
}

// --- K9 ------------------------------------------------------------------------

struct Levels {
  int n;
  int off[kMaxLevels];   // first texel of each level in the packed chain
  int h[kMaxLevels];
  int w[kMaxLevels];
};

__device__ __forceinline__ float3 bilinear4(const float4* __restrict__ lvl,
                                            int h, int w, float u, float v,
                                            int repeat) {
  const Taps t = taps(u, v, h, w, repeat);
  const float4 t00 = __ldg(lvl + t.a + t.xa);
  const float4 t10 = __ldg(lvl + t.a + t.xb);
  const float4 t01 = __ldg(lvl + t.b + t.xa);
  const float4 t11 = __ldg(lvl + t.b + t.xb);
  return make_float3(lerp2(t00.x, t10.x, t01.x, t11.x, t.fx, t.fy),
                     lerp2(t00.y, t10.y, t01.y, t11.y, t.fx, t.fy),
                     lerp2(t00.z, t10.z, t01.z, t11.z, t.fx, t.fy));
}

// sampling.sample_trilinear: levels floor(lod) and min(floor(lod)+1, L-1),
// blended lo*(1-frac) + hi*frac.
__global__ void __launch_bounds__(kBlock)
sample_pyramid_kernel(const float4* __restrict__ pyr, Levels L,
                      const float* __restrict__ u, const float* __restrict__ v,
                      const float* __restrict__ lod,
                      const uint8_t* __restrict__ mask, int repeat, int n,
                      float* __restrict__ out) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= n) return;
  if (mask != nullptr && mask[i] == 0) {
    out[i] = 0.0f;
    out[n + i] = 0.0f;
    out[2 * n + i] = 0.0f;
    return;
  }
  const float top_level = (float)(L.n - 1);
  float l = lod[i];
  l = l < 0.0f ? 0.0f : l;            // NaN-propagating clip, as torch.clamp
  l = l > top_level ? top_level : l;
  const float lo = floorf(l);
  const float frac = l - lo;
  const int li = min(max((int)lo, 0), L.n - 1);
  const int hi = min(li + 1, L.n - 1);
  const float uu = u[i], vv = v[i];
  const float3 a = bilinear4(pyr + L.off[li], L.h[li], L.w[li], uu, vv, repeat);
  const float3 b = bilinear4(pyr + L.off[hi], L.h[hi], L.w[hi], uu, vv, repeat);
  const float keep = 1.0f - frac;
  out[i] = a.x * keep + b.x * frac;
  out[n + i] = a.y * keep + b.y * frac;
  out[2 * n + i] = a.z * keep + b.z * frac;
}

int blocks_for(int n) { return (n + kBlock - 1) / kBlock; }

}  // namespace

// frames maps of th x tw (stacked), each sampled at its frame's hw pixels
// of u, v (and mask; nullptr: every pixel), written to out.
extern "C" int mr_sample_bilinear(const float* tex, int th, int tw,
                                  const float* u, const float* v,
                                  const uint8_t* mask, float oob_value,
                                  int repeat, int frames, int hw, float* out,
                                  void* stream) {
  if (frames < 0 || frames > 65535 || hw < 0 || th < 1 || tw < 1)
    return (int)cudaErrorInvalidValue;
  if (frames == 0 || hw == 0) return 0;
  const dim3 grid((hw / 4 + 2 + kBlockQuads - 1) / kBlockQuads, 1, frames);
  sample_bilinear_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      tex, th, tw, u, v, mask, oob_value, repeat, hw, out);
  return (int)cudaGetLastError();
}

// level_off/level_h/level_w: n_levels host ints each (n_levels <= 16).
extern "C" int mr_sample_pyramid(const float* pyramid, int n_levels,
                                 const int* level_off, const int* level_h,
                                 const int* level_w, const float* u,
                                 const float* v, const float* lod,
                                 const uint8_t* mask, int repeat, int n,
                                 float* out, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  Levels L;
  L.n = n_levels;
  for (int k = 0; k < kMaxLevels; ++k) {
    L.off[k] = k < n_levels ? level_off[k] : 0;
    L.h[k] = k < n_levels ? level_h[k] : 1;
    L.w[k] = k < n_levels ? level_w[k] : 1;
  }
  sample_pyramid_kernel<<<blocks_for(n), kBlock, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(pyramid), L, u, v, lod, mask, repeat, n,
      out);
  return (int)cudaGetLastError();
}
