// W-pass of the fused CT resample + min-max normalize, for Hopper (sm_90a).
//
// Replaces: multimodal_survival_prediction_tpu/ops/resample.py:_wpass_kernel
// (launched by _resample_normalize_pallas, pl.pallas_call at :152). Given the
// raw CT reshaped to (D*H, W) in its native dtype, it
//   * converts each element to f32 in registers and applies the optional HU
//     clip (a flag plus lo/hi),
//   * reduces the global min and max of the (clipped) volume,
//   * contracts the W axis with the trilinear interpolation matrix:
//     out[r, o] = sum_w vol[r, w] * rxT[w, o]  ->  (D*H, Wo) f32.
// The H and D contractions and the normalize epilogue stay in torch (the
// wrapper in ops/resample.py), as they stay in XLA in the JAX package.
//
// Bound on the H100 (SXM, 3.35 TB/s): memory. The pass must read the volume
// once (D*H*W*itemsize bytes) and write (D*H, Wo) f32: for a (128,512,512)
// int16 CT that is 67.1 MB + 8.4 MB, about 23 us. A dense f32 contraction
// against rxT on CUDA cores would add 2*65536*512*32 = 2.1 GFLOP (about
// 32 us at 67 TFLOP/s), more than the memory bound; TF32 tensor cores are
// ruled out because the reference contracts at precision=HIGHEST.
//
// Design: each row of rx has at most two non-zero entries (linear
// interpolation, ops/resample.py:41-46), so the contraction is a two-tap
// gather, 3 flops per output, which keeps the kernel on the memory bound.
// The wrapper passes the taps (column indices) and their weights taken
// exactly from the same matrix; dropping the exact-zero terms does not change
// an f32 sum. Each output is round(round(a*w0) + round(b*w1)) (no FMA), the
// value a dense dot gives without fused multiply-add.
//   * One warp per row: the lanes read the row with coalesced loads in its
//     native width (an int16 CT crosses memory once at 2 bytes/voxel),
//     convert + clip in registers, fold min/max, and stage the f32 row in
//     shared memory, from where the lanes gather the Wo outputs.
//   * Blocks run in parallel in no order, unlike the TPU's sequential grid
//     that carries min/max in SMEM: each block writes a partial min/max and
//     a second one-block kernel folds the partials. Min and max are exact in
//     any order, so the result is bit-equal to the plain version.
//   * Ragged tails need no padding (the JAX wrapper pads with edge rows,
//     :147-150): the grid-stride row loop simply stops at D*H.
//   * Loads are scalar (2 bytes a lane for int16); vectorised 16-byte loads
//     and a deeper pipeline are left for a later change.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // rows in flight per block, one per warp
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
__device__ __forceinline__ float to_f32(T v) {
  return static_cast<float>(v);
}

__device__ __forceinline__ void warp_minmax(float& a, float& b) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a = fminf(a, __shfl_xor_sync(kFull, a, off));
    b = fmaxf(b, __shfl_xor_sync(kFull, b, off));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
wpass_kernel(const T* __restrict__ vol, long long n_rows, int w,
             const int* __restrict__ tap0, const int* __restrict__ tap1,
             const float* __restrict__ wt0, const float* __restrict__ wt1,
             int wo, int clip, float lo, float hi, float* __restrict__ out,
             float* __restrict__ part_min, float* __restrict__ part_max) {
  extern __shared__ float smem[];
  float* rows = smem;  // kWarps rows of w floats
  int* s_tap0 = reinterpret_cast<int*>(rows + static_cast<size_t>(kWarps) * w);
  int* s_tap1 = s_tap0 + wo;
  float* s_wt0 = reinterpret_cast<float*>(s_tap1 + wo);
  float* s_wt1 = s_wt0 + wo;
  for (int o = threadIdx.x; o < wo; o += kThreads) {
    s_tap0[o] = tap0[o];
    s_tap1[o] = tap1[o];
    s_wt0[o] = wt0[o];
    s_wt1[o] = wt1[o];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* row = rows + static_cast<size_t>(warp) * w;
  float tmin = INFINITY, tmax = -INFINITY;
  const long long stride = static_cast<long long>(gridDim.x) * kWarps;
  for (long long r = static_cast<long long>(blockIdx.x) * kWarps + warp;
       r < n_rows; r += stride) {
    const T* src = vol + r * w;
#pragma unroll 4
    for (int c = lane; c < w; c += 32) {
      float v = to_f32(__ldg(src + c));
      if (clip) v = fminf(fmaxf(v, lo), hi);
      tmin = fminf(tmin, v);
      tmax = fmaxf(tmax, v);
      row[c] = v;
    }
    __syncwarp();
    float* dst = out + r * wo;
    for (int o = lane; o < wo; o += 32) {
      dst[o] = __fadd_rn(__fmul_rn(row[s_tap0[o]], s_wt0[o]),
                         __fmul_rn(row[s_tap1[o]], s_wt1[o]));
    }
    __syncwarp();  // the next row overwrites this warp's buffer
  }

  __shared__ float red_min[kWarps], red_max[kWarps];
  warp_minmax(tmin, tmax);
  if (lane == 0) {
    red_min[warp] = tmin;
    red_max[warp] = tmax;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float a = red_min[0], b = red_max[0];
    for (int i = 1; i < kWarps; ++i) {
      a = fminf(a, red_min[i]);
      b = fmaxf(b, red_max[i]);
    }
    part_min[blockIdx.x] = a;
    part_max[blockIdx.x] = b;
  }
}

// One block folds the per-block partials into the global min and max.
__global__ void __launch_bounds__(kThreads)
minmax_final_kernel(const float* __restrict__ part_min,
                    const float* __restrict__ part_max, int n,
                    float* __restrict__ mn, float* __restrict__ mx) {
  float a = INFINITY, b = -INFINITY;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    a = fminf(a, part_min[i]);
    b = fmaxf(b, part_max[i]);
  }
  warp_minmax(a, b);
  __shared__ float red_min[kWarps], red_max[kWarps];
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    red_min[warp] = a;
    red_max[warp] = b;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 1; i < kWarps; ++i) {
      a = fminf(a, red_min[i]);
      b = fmaxf(b, red_max[i]);
    }
    // thread 0's own a/b already hold warp 0's result
    mn[0] = a;
    mx[0] = b;
  }
}

template <typename T>
cudaError_t launch(const void* vol, long long n_rows, int w, const int* tap0,
                   const int* tap1, const float* wt0, const float* wt1,
                   int wo, int clip, float lo, float hi, float* out,
                   float* part_min, float* part_max, int grid, float* mn,
                   float* mx, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(kWarps) * w * sizeof(float) +
                      static_cast<size_t>(wo) * 4 * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        wpass_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  wpass_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(vol), n_rows, w, tap0, tap1, wt0, wt1, wo, clip,
      lo, hi, out, part_min, part_max);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  minmax_final_kernel<<<1, kThreads, 0, stream>>>(part_min, part_max, grid,
                                                  mn, mx);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 int8, 1 uint8, 2 int16, 3 int32, 4 float32. All pointers are
// device pointers; `vol` is C-contiguous (n_rows, w); `out` is (n_rows, wo);
// part_min/part_max hold `grid` floats; mn/mx one float each. Launches on
// `stream` without synchronising and returns cudaGetLastError().
int msp_resample_wpass(const void* vol, int dtype, long long n_rows, int w,
                       const void* tap0, const void* tap1, const void* wt0,
                       const void* wt1, int wo, int clip, float lo, float hi,
                       void* out, void* part_min, void* part_max, int grid,
                       void* mn, void* mx, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto t0 = static_cast<const int*>(tap0);
  auto t1 = static_cast<const int*>(tap1);
  auto w0 = static_cast<const float*>(wt0);
  auto w1 = static_cast<const float*>(wt1);
  auto o = static_cast<float*>(out);
  auto pmin = static_cast<float*>(part_min);
  auto pmax = static_cast<float*>(part_max);
  auto fmn = static_cast<float*>(mn);
  auto fmx = static_cast<float*>(mx);
  switch (dtype) {
    case 0:
      return launch<int8_t>(vol, n_rows, w, t0, t1, w0, w1, wo, clip, lo, hi,
                            o, pmin, pmax, grid, fmn, fmx, s);
    case 1:
      return launch<uint8_t>(vol, n_rows, w, t0, t1, w0, w1, wo, clip, lo, hi,
                             o, pmin, pmax, grid, fmn, fmx, s);
    case 2:
      return launch<int16_t>(vol, n_rows, w, t0, t1, w0, w1, wo, clip, lo, hi,
                             o, pmin, pmax, grid, fmn, fmx, s);
    case 3:
      return launch<int32_t>(vol, n_rows, w, t0, t1, w0, w1, wo, clip, lo, hi,
                             o, pmin, pmax, grid, fmn, fmx, s);
    case 4:
      return launch<float>(vol, n_rows, w, t0, t1, w0, w1, wo, clip, lo, hi,
                           o, pmin, pmax, grid, fmn, fmx, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* msp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
