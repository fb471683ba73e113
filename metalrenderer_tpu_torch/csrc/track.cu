// The audio track's sequential carries for Hopper (sm_90a), bound with a
// plain C interface and loaded with ctypes (metalrenderer_tpu_torch/raster/
// _build.py, audio/track_cuda.py).
//
// What it replaces. No Pallas kernel: in the JAX package the carries are a
// lax.scan inside the track's XLA program (metalrenderer_tpu/audio/
// analyzer.py analyze_stream, audio/mapping.py map_audio_to_visual). The
// port ran them as numpy loops on the host (audio/analyzer._carries,
// audio/mapping._envelope, which stay as these kernels' plain twins and
// run on the CPU), so every track call on the card stopped twice for the
// host: the per-chunk scalars down, the carried values back up. On the
// card these kernels keep the track on the device, so a track call makes
// no host read until its one readback, and a CUDA graph captures it whole
// (audio/track.py).
//
//   track_carries_kernel   the 120-slot rolling RMS window
//                          (RollingAverage::push, AudioAnalyzer.hpp:37-49:
//                          append until full, then overwrite round-robin;
//                          the average is read before the push) and the
//                          three band EMAs, over the n chunks in order;
//   track_envelope_kernel  the peak-hold brightness envelope
//                          env_t = max(raw_t, env_{t-1} * decay), in order
//                          (mtl_engine.mm:745-752).
//
// What bounds it: the dependence from one chunk to the next. Each chunk is
// a handful of float operations on the previous chunk's values, so one
// thread walks the chunks; a live call has n = 1, a stream's chunk 8 or
// 16, a whole offline track a few thousand. The ring (120 floats) is staged
// in shared memory by the block and written back once.
//
// Rounding: every expression is the numpy loop's float32 operation in the
// same order, each rounded on its own (__fmul_rn, __fadd_rn, __fsub_rn,
// __fdiv_rn, and nvcc -fmad=false), so the results are bit-equal to the
// twins'. alpha, 1 - alpha and the decay come from the host as the twins'
// np.float32 constants.
//
// The analyzer state's layout (audio/analyzer.py AnalyzerState.pack):
// [0, 120) the ring, 120 the running sum, 121..123 the smoothed bass, mid
// and treble, 124 the next write slot, 125 the count (both as floats,
// exact).

#include <cuda_runtime.h>

namespace {

constexpr int kWindow = 120;       // analyzer.ROLLING_WINDOW
constexpr int kSum = kWindow;
constexpr int kBands = kWindow + 1;
constexpr int kIdx = kWindow + 4;
constexpr int kCount = kWindow + 5;
constexpr int kStateLen = kWindow + 6;   // analyzer.STATE_LEN
constexpr int kThreads = 128;

// scalars [n, 4]: rms, raw bass, mid, treble of each chunk.
// carried [n, 4]: the rolling average before the chunk's push, the
// smoothed bass, mid, treble after it.
__global__ void track_carries_kernel(const float* __restrict__ state_in,
                                     float* __restrict__ state_out,
                                     const float* __restrict__ scalars,
                                     float* __restrict__ carried, int n,
                                     float alpha, float keep) {
  __shared__ float ring[kWindow];
  for (int i = threadIdx.x; i < kWindow; i += blockDim.x)
    ring[i] = state_in[i];
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = state_in[kSum];
    float sm[3] = {state_in[kBands], state_in[kBands + 1],
                   state_in[kBands + 2]};
    int idx = int(state_in[kIdx]);
    int count = int(state_in[kCount]);
    for (int i = 0; i < n; ++i) {
      const float* s = scalars + 4 * i;
      float* c = carried + 4 * i;
      c[0] = count > 0 ? __fdiv_rn(total, float(count)) : 0.0f;
      const float value = s[0];
      const bool full = count >= kWindow;
      const int slot = full ? idx : count;
      const float old = ring[slot];
      ring[slot] = value;
      total = __fsub_rn(__fadd_rn(total, value), full ? old : 0.0f);
      count = count + 1 < kWindow ? count + 1 : kWindow;
      if (full) idx = (idx + 1) % kWindow;
      for (int k = 0; k < 3; ++k) {
        sm[k] = __fadd_rn(__fmul_rn(alpha, s[1 + k]), __fmul_rn(keep, sm[k]));
        c[1 + k] = sm[k];
      }
    }
    state_out[kSum] = total;
    for (int k = 0; k < 3; ++k) state_out[kBands + k] = sm[k];
    state_out[kIdx] = float(idx);
    state_out[kCount] = float(count);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kWindow; i += blockDim.x)
    state_out[i] = ring[i];
}

// env [n + 1]: env[0] = *start, env[t + 1] the envelope after chunk t (the
// last is the next call's start).
__global__ void track_envelope_kernel(const float* __restrict__ start,
                                      const float* __restrict__ raw,
                                      float* __restrict__ env, int n,
                                      float decay) {
  float e = *start;
  env[0] = e;
  for (int i = 0; i < n; ++i) {
    const float held = __fmul_rn(e, decay);
    const float r = raw[i];
    e = held > r ? held : r;       // Python's max(raw, held): raw on ties
    env[i + 1] = e;
  }
}

int launch_error() { return (int)cudaGetLastError(); }

}  // namespace

static_assert(kStateLen == 126, "audio/analyzer.py STATE_LEN");

extern "C" int mr_track_carries(const float* state_in, float* state_out,
                                const float* scalars, float* carried, int n,
                                float alpha, float keep, void* stream) {
  track_carries_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(
      state_in, state_out, scalars, carried, n, alpha, keep);
  return launch_error();
}

extern "C" int mr_track_envelope(const float* start, const float* raw,
                                 float* env, int n, float decay,
                                 void* stream) {
  track_envelope_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(start, raw, env,
                                                           n, decay);
  return launch_error();
}
