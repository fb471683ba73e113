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
//    grids in one launch. Thread i reads frame f = i / (H*W), an integer,
//    and its taps at tex + f*TH*TW (size_t); the frame never enters the
//    float coordinates, so K8 is bit-equal to K7 run frame by frame. A K7
//    launch is the batch of one (hw == n).
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
// shadow map is 4 MB, a 256^2 RGBA mip chain 1.4 MB), so each thread reads
// its four taps (per level) straight from global memory: exact everywhere,
// as sampling.sample_bilinear / sample_trilinear.
//
// What bounds them on the H100: bytes. Per pixel K7 reads u, v and a mask
// byte and writes one float (13 B), K9 reads u, v, lod and a mask byte and
// writes three floats (25 B); the arithmetic is ~20 FP32 operations per
// tap set. One thread per pixel, consecutive threads on consecutive pixels,
// so every plane is read and written coalesced; a K9 tap is one 16-byte
// float4 load (levels are stored RGBA). No shared memory, no atomics.
//
// Rounding: the coordinate transform and the lerps are the reference's
// expressions, x = u*w - 0.5, top = t00*(1-fx) + t10*fx, ..., each multiply
// and add rounded on its own (-fmad=false), as in the torch twins.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;
constexpr int kMaxLevels = 16;

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

__global__ void __launch_bounds__(kBlock)
sample_bilinear_kernel(const float* __restrict__ tex, int th, int tw,
                       const float* __restrict__ u,
                       const float* __restrict__ v,
                       const uint8_t* __restrict__ mask, float oob_value,
                       int repeat, int n, int hw, float* __restrict__ out) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= n) return;
  if (mask != nullptr && mask[i] == 0) {
    out[i] = oob_value;
    return;
  }
  const float* __restrict__ tf = tex + (size_t)(i / hw) * th * tw;
  const Taps t = taps(u[i], v[i], th, tw, repeat);
  out[i] = lerp2(__ldg(tf + t.a + t.xa), __ldg(tf + t.a + t.xb),
                 __ldg(tf + t.b + t.xa), __ldg(tf + t.b + t.xb), t.fx, t.fy);
}

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

// n pixels in frames of hw (n / hw textures of th x tw, stacked).
extern "C" int mr_sample_bilinear(const float* tex, int th, int tw,
                                  const float* u, const float* v,
                                  const uint8_t* mask, float oob_value,
                                  int repeat, int n, int hw, float* out,
                                  void* stream) {
  if (n == 0) return 0;
  if (hw < 1 || n % hw != 0) return (int)cudaErrorInvalidValue;
  sample_bilinear_kernel<<<blocks_for(n), kBlock, 0, (cudaStream_t)stream>>>(
      tex, th, tw, u, v, mask, oob_value, repeat, n, hw, out);
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
