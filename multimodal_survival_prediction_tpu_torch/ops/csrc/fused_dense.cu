// Fused train-mode BatchNorm -> ReLU -> 1x1x1 conv, for Hopper (sm_90a), fp32.
//
// Replaces the four Pallas kernels of
// multimodal_survival_prediction_tpu/ops/fused_dense.py:
//   _moments_kernel    (pallas_call at :97)   per-channel sum x, sum x^2
//   _apply_kernel      (pallas_call at :124)  out = relu(x*mul+add) @ W
//   _bwd_reduce_kernel (pallas_call at :180)  dW = a^T g, dbeta = sum dz,
//                                             dgamma = sum dz*xhat
//   _bwd_dx_kernel     (pallas_call at :228)  dx = mul*(dz - c1 - xhat*c2)
// where x is the DenseNet trunk as (N rows, C channels), C contiguous,
// z = x*mul + add, a = relu(z), g the (N, F) output cotangent,
// da = g W^T, dz = [z > 0] da, xhat = (x - mean)*rstd. The wrapper
// (ops/fused_dense.py) computes mul/add/mean/rstd from the moments in torch.
//
// Bound on the H100 (SXM, 67 TFLOP/s fp32 outside the tensor cores,
// 3.35 TB/s): the three products (apply: 2NCF, bwd_reduce: 4NCF, bwd_dx:
// 2NCF flops) are bound by operations at the DenseNet's shapes (F = 128..512
// outputs per row read); the moments pass is bound by bytes.
//
// Design (a first, simple version; tensor cores and TMA are later work):
//   * Products are fp32 FMA on CUDA cores from shared-memory tiles: a 64x64
//     block tile, 16-deep K steps, 256 threads holding 4x4 outputs each.
//     No tensor cores (the reference contracts in true fp32) and no library
//     product.
//   * The BN + ReLU prologue is applied while the x tile is staged into
//     shared memory, so the normalized trunk never reaches device memory.
//     z is computed as round(round(x*mul) + add), the value torch's eager
//     `x * mul + add` gives, so the ReLU mask equals the plain version's on
//     the same inputs.
//   * Blocks run in parallel in no order, unlike the TPU's sequential grid
//     that accumulates into one output block. Every cross-block sum (the
//     moments, dW over row chunks, dbeta/dgamma over row tiles) is written as
//     per-block partials and folded by a second kernel in a fixed order: no
//     atomics, so the results are the same bits run to run.
//   * Ragged tiles: every load is masked (rows >= N, channels >= C, outputs
//     >= F read as 0 and are not stored), so any N >= 1 and any C, F work;
//     the JAX wrapper instead tiles only by exact divisors of N.
//   * W is read through two strides, so the wrapper passes the conv kernel
//     (F, C) as the (C, F) operand without a transposed copy.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 64;  // block tile rows (the M of the product)
constexpr int kBN = 64;  // block tile columns (the N of the product)
constexpr int kBK = 16;  // depth of one shared-memory step
constexpr int kTM = 4;   // outputs per thread along M: rows ty + 16*i
constexpr int kTN = 4;   // outputs per thread along N: cols tx + 16*j
constexpr int kPad = 4;  // shared-memory row padding (bank spread)
constexpr int kLoads = kBM * kBK / kThreads;  // tile elements per thread (4)
static_assert(kBM == kBN, "tile loaders assume square block tiles");
static_assert(kBM * kBK == kLoads * kThreads, "tile must split evenly");
static_assert((kThreads / 16) * kTM == kBM && 16 * kTN == kBN,
              "thread grid must cover the block tile");

constexpr int kMomCh = 32;     // moments: channels per block (one warp wide)
constexpr int kMomLanes = 8;   // moments: row lanes per block

struct Tiles {
  float a[kBK][kBM + kPad];  // A(m, k) stored as a[k][m]
  float b[kBK][kBN + kPad];  // B(k, n) stored as b[k][n]
};

// z = x*mul + add with two roundings, as torch's eager `x * mul + add`.
__device__ __forceinline__ float bn_z(float x, float mul, float add) {
  return __fadd_rn(__fmul_rn(x, mul), add);
}

__device__ __forceinline__ void zero_acc(float acc[kTM][kTN]) {
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;
}

// acc[i][j] += sum_k a[k][ty + 16 i] * b[k][tx + 16 j]
__device__ __forceinline__ void mma_tile(const Tiles& t, float acc[kTM][kTN],
                                         int ty, int tx) {
#pragma unroll
  for (int k = 0; k < kBK; ++k) {
    float ra[kTM], rb[kTN];
#pragma unroll
    for (int i = 0; i < kTM; ++i) ra[i] = t.a[k][ty + 16 * i];
#pragma unroll
    for (int j = 0; j < kTN; ++j) rb[j] = t.b[k][tx + 16 * j];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(ra[i], rb[j], acc[i][j]);
  }
}

// dst[k][n] = W[(k0+k)*sk + (n0+n)*sn] for k < K, n < N, else 0. Threads walk
// the unit-stride axis, so the loads coalesce whichever way W is laid out.
__device__ __forceinline__ void load_w_tile(float (*dst)[kBN + kPad],
                                            const float* __restrict__ w,
                                            long long sk, long long sn,
                                            int k0, int n0, int K, int N) {
  const bool n_fast = (sn == 1);
#pragma unroll
  for (int l = 0; l < kLoads; ++l) {
    const int e = threadIdx.x + kThreads * l;
    const int k = n_fast ? e / kBN : e % kBK;
    const int n = n_fast ? e % kBN : e / kBK;
    const int gk = k0 + k, gn = n0 + n;
    dst[k][n] = (gk < K && gn < N) ? __ldg(w + gk * sk + gn * sn) : 0.f;
  }
}

// ---------------------------------------------------------------- moments

// Block (kMomCh channels x kMomLanes row lanes) sums one chunk of rows.
// part is (chunks, 2C): sums at [chunk][c], sums of squares at [chunk][C+c].
__global__ void __launch_bounds__(kMomCh * kMomLanes)
moments_partial_kernel(const float* __restrict__ x, long long n, int c,
                       long long rows_per_chunk, float* __restrict__ part) {
  const int ch = blockIdx.y * kMomCh + threadIdx.x;
  const long long r0 = static_cast<long long>(blockIdx.x) * rows_per_chunk;
  const long long r1 = min(n, r0 + rows_per_chunk);
  float s = 0.f, q = 0.f;
  if (ch < c) {
    for (long long r = r0 + threadIdx.y; r < r1; r += kMomLanes) {
      const float v = __ldg(x + r * c + ch);
      s += v;
      q = fmaf(v, v, q);
    }
  }
  __shared__ float red_s[kMomLanes][kMomCh], red_q[kMomLanes][kMomCh];
  red_s[threadIdx.y][threadIdx.x] = s;
  red_q[threadIdx.y][threadIdx.x] = q;
  __syncthreads();
  if (threadIdx.y == 0 && ch < c) {
    for (int i = 1; i < kMomLanes; ++i) {  // fixed order
      s += red_s[i][threadIdx.x];
      q += red_q[i][threadIdx.x];
    }
    float* dst = part + static_cast<long long>(blockIdx.x) * 2 * c;
    dst[ch] = s;
    dst[c + ch] = q;
  }
}

// out[j] = sum_{k < chunks} part[k*m + j], k ascending: the fixed-order fold
// of every per-block partial in this file.
__global__ void __launch_bounds__(kThreads)
fold_kernel(const float* __restrict__ part, int chunks, long long m,
            float* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long j = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       j < m; j += stride) {
    float s = 0.f;
    for (int k = 0; k < chunks; ++k) s += part[k * m + j];
    out[j] = s;
  }
}

// ------------------------------------------------------------------ apply

// out (N, F) = relu(x*mul + add) @ W; grid (ceil(N/64), ceil(F/64)).
__global__ void __launch_bounds__(kThreads)
apply_kernel(const float* __restrict__ x, const float* __restrict__ mul,
             const float* __restrict__ add, const float* __restrict__ w,
             long long w_sc, long long w_sf, long long n, int c, int f,
             float* __restrict__ out) {
  __shared__ Tiles t;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long long m0 = static_cast<long long>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * kBN;
  float acc[kTM][kTN];
  zero_acc(acc);
  for (int k0 = 0; k0 < c; k0 += kBK) {
#pragma unroll
    for (int l = 0; l < kLoads; ++l) {  // A(m, k) = relu(z[m0+m, k0+k])
      const int e = threadIdx.x + kThreads * l;
      const int k = e % kBK, m = e / kBK;
      const long long row = m0 + m;
      const int ch = k0 + k;
      float v = 0.f;
      if (row < n && ch < c)
        v = fmaxf(bn_z(__ldg(x + row * c + ch), __ldg(mul + ch),
                       __ldg(add + ch)), 0.f);
      t.a[k][m] = v;
    }
    load_w_tile(t.b, w, w_sc, w_sf, k0, n0, c, f);
    __syncthreads();
    mma_tile(t, acc, ty, tx);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const long long row = m0 + ty + 16 * i;
    if (row >= n) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < f) out[row * f + col] = acc[i][j];
    }
  }
}

// ------------------------------------------------------------- bwd_reduce

// Partial dW over one chunk of rows: part[chunk] (C, F) = a[rows]^T g[rows];
// grid (ceil(C/64), ceil(F/64), chunks).
__global__ void __launch_bounds__(kThreads)
dw_partial_kernel(const float* __restrict__ x, const float* __restrict__ g,
                  const float* __restrict__ mul, const float* __restrict__ add,
                  long long n, int c, int f, long long rows_per_chunk,
                  float* __restrict__ part) {
  __shared__ Tiles t;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int c0 = blockIdx.x * kBM;
  const int f0 = blockIdx.y * kBN;
  const long long r0 = static_cast<long long>(blockIdx.z) * rows_per_chunk;
  const long long r1 = min(n, r0 + rows_per_chunk);
  float acc[kTM][kTN];
  zero_acc(acc);
  for (long long rk = r0; rk < r1; rk += kBK) {
#pragma unroll
    for (int l = 0; l < kLoads; ++l) {
      const int e = threadIdx.x + kThreads * l;
      const int m = e % kBM, k = e / kBM;  // coalesced along channels / F
      const long long row = rk + k;
      const bool live = row < r1;
      const int ch = c0 + m;
      float v = 0.f;
      if (live && ch < c)
        v = fmaxf(bn_z(__ldg(x + row * c + ch), __ldg(mul + ch),
                       __ldg(add + ch)), 0.f);
      t.a[k][m] = v;  // A(m = channel, k = row) = a[row, channel]
      const int col = f0 + m;
      t.b[k][m] = (live && col < f) ? __ldg(g + row * f + col) : 0.f;
    }
    __syncthreads();
    mma_tile(t, acc, ty, tx);
    __syncthreads();
  }
  float* dst = part + static_cast<long long>(blockIdx.z) * c * f;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int ch = c0 + ty + 16 * i;
    if (ch >= c) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int col = f0 + tx + 16 * j;
      if (col < f) dst[static_cast<long long>(ch) * f + col] = acc[i][j];
    }
  }
}

// --------------------------------------------------------- da = g W^T + BN

// da (N, C) = g (N, F) @ W^T over F, then per element:
//   z = x*mul + add, dz = z > 0 ? da : 0, xhat = (x - mean)*rstd
//   kDx = false: per-block partial sums over the block's 64 rows,
//                part[row tile][c] = sum dz, part[row tile][C + c] = sum dz*xhat
//   kDx = true:  dx = mul*(dz - c1 - xhat*c2)
// grid (ceil(N/64), ceil(C/64)).
template <bool kDx>
__global__ void __launch_bounds__(kThreads)
da_kernel(const float* __restrict__ g, const float* __restrict__ w,
          long long w_sc, long long w_sf, const float* __restrict__ x,
          const float* __restrict__ mul, const float* __restrict__ add,
          const float* __restrict__ mean, const float* __restrict__ rstd,
          const float* __restrict__ c1, const float* __restrict__ c2,
          long long n, int c, int f, float* __restrict__ dx,
          float* __restrict__ part) {
  __shared__ Tiles t;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long long m0 = static_cast<long long>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * kBN;
  float acc[kTM][kTN];
  zero_acc(acc);
  for (int k0 = 0; k0 < f; k0 += kBK) {
#pragma unroll
    for (int l = 0; l < kLoads; ++l) {  // A(m, k) = g[m0+m, k0+k]
      const int e = threadIdx.x + kThreads * l;
      const int k = e % kBK, m = e / kBK;
      const long long row = m0 + m;
      const int col = k0 + k;
      t.a[k][m] = (row < n && col < f) ? __ldg(g + row * f + col) : 0.f;
    }
    // B(k = f, n = channel) = W[channel, f]
    load_w_tile(t.b, w, w_sf, w_sc, k0, n0, f, c);
    __syncthreads();
    mma_tile(t, acc, ty, tx);
    __syncthreads();
  }

  float s_db[kTN], s_dg[kTN];
#pragma unroll
  for (int j = 0; j < kTN; ++j) s_db[j] = s_dg[j] = 0.f;
#pragma unroll
  for (int j = 0; j < kTN; ++j) {
    const int ch = n0 + tx + 16 * j;
    if (ch >= c) continue;
    const float mu = __ldg(mul + ch), ad = __ldg(add + ch);
    const float me = __ldg(mean + ch), rs = __ldg(rstd + ch);
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const long long row = m0 + ty + 16 * i;
      if (row >= n) continue;
      const float xv = __ldg(x + row * c + ch);
      const float dz = bn_z(xv, mu, ad) > 0.f ? acc[i][j] : 0.f;
      const float xhat = (xv - me) * rs;
      if constexpr (kDx) {
        dx[row * c + ch] = mu * (dz - __ldg(c1 + ch) - xhat * __ldg(c2 + ch));
      } else {
        s_db[j] += dz;
        s_dg[j] += dz * xhat;
      }
    }
  }

  if constexpr (!kDx) {
    // Fold the 16 row-threads of each column in a fixed order.
    __shared__ float red_db[kThreads / 16][kBN], red_dg[kThreads / 16][kBN];
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      red_db[ty][tx + 16 * j] = s_db[j];
      red_dg[ty][tx + 16 * j] = s_dg[j];
    }
    __syncthreads();
    if (threadIdx.x < kBN) {
      const int col = threadIdx.x;
      const int ch = n0 + col;
      if (ch < c) {
        float db = 0.f, dg = 0.f;
        for (int r = 0; r < kThreads / 16; ++r) {
          db += red_db[r][col];
          dg += red_dg[r][col];
        }
        float* dst = part + static_cast<long long>(blockIdx.x) * 2 * c;
        dst[ch] = db;
        dst[c + ch] = dg;
      }
    }
  }
}

int fold_grid(long long m) {
  const long long blocks = (m + kThreads - 1) / kThreads;
  return static_cast<int>(blocks < 1024 ? blocks : 1024);
}

int ceil_div(long long a, long long b) {
  return static_cast<int>((a + b - 1) / b);
}

}  // namespace

extern "C" {

// All pointers are device pointers to float32; x is (n, c) and g (n, f),
// both C-contiguous; W is read as W[c*w_sc + f*w_sf]; vectors are (c,).
// Each function launches on `stream` without synchronising and returns
// cudaGetLastError() (0 on success). Scratch (`part`) is allocated by the
// caller with the sizes noted.

// out (2c): sums then sums of squares. part: chunks * 2c floats, with
// chunks = ceil(n / rows_per_chunk).
int msp_fused_moments(const float* x, long long n, int c,
                      long long rows_per_chunk, float* part, float* out,
                      void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const int chunks = ceil_div(n, rows_per_chunk);
  dim3 grid(chunks, ceil_div(c, kMomCh));
  moments_partial_kernel<<<grid, dim3(kMomCh, kMomLanes), 0, s>>>(
      x, n, c, rows_per_chunk, part);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  fold_kernel<<<fold_grid(2LL * c), kThreads, 0, s>>>(part, chunks, 2LL * c,
                                                     out);
  return cudaGetLastError();
}

// out (n, f) = relu(x*mul + add) @ W.
int msp_fused_apply(const float* x, const float* mul, const float* add,
                    const float* w, long long w_sc, long long w_sf,
                    long long n, int c, int f, float* out, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  dim3 grid(ceil_div(n, kBM), ceil_div(f, kBN));
  apply_kernel<<<grid, kThreads, 0, s>>>(x, mul, add, w, w_sc, w_sf, n, c, f,
                                         out);
  return cudaGetLastError();
}

// dw (c, f), dbg (2c): dbeta then dgamma. part_dw: chunks * c * f floats
// with chunks = ceil(n / rows_per_chunk); part_bg: ceil(n / 64) * 2c floats.
int msp_fused_bwd_reduce(const float* x, const float* g, const float* w,
                         long long w_sc, long long w_sf, const float* mul,
                         const float* add, const float* mean,
                         const float* rstd, long long n, int c, int f,
                         long long rows_per_chunk, float* part_dw,
                         float* part_bg, float* dw, float* dbg,
                         void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const int chunks = ceil_div(n, rows_per_chunk);
  dim3 grid_dw(ceil_div(c, kBM), ceil_div(f, kBN), chunks);
  dw_partial_kernel<<<grid_dw, kThreads, 0, s>>>(x, g, mul, add, n, c, f,
                                                 rows_per_chunk, part_dw);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int row_tiles = ceil_div(n, kBM);
  dim3 grid_da(row_tiles, ceil_div(c, kBN));
  da_kernel<false><<<grid_da, kThreads, 0, s>>>(
      g, w, w_sc, w_sf, x, mul, add, mean, rstd, nullptr, nullptr, n, c, f,
      nullptr, part_bg);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long m_dw = static_cast<long long>(c) * f;
  fold_kernel<<<fold_grid(m_dw), kThreads, 0, s>>>(part_dw, chunks, m_dw, dw);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  fold_kernel<<<fold_grid(2LL * c), kThreads, 0, s>>>(part_bg, row_tiles,
                                                     2LL * c, dbg);
  return cudaGetLastError();
}

// dx (n, c) = mul*(dz - c1 - xhat*c2).
int msp_fused_bwd_dx(const float* x, const float* g, const float* w,
                     long long w_sc, long long w_sf, const float* mul,
                     const float* add, const float* mean, const float* rstd,
                     const float* c1, const float* c2, long long n, int c,
                     int f, float* dx, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  dim3 grid(ceil_div(n, kBM), ceil_div(c, kBN));
  da_kernel<true><<<grid, kThreads, 0, s>>>(g, w, w_sc, w_sf, x, mul, add,
                                            mean, rstd, c1, c2, n, c, f, dx,
                                            nullptr);
  return cudaGetLastError();
}

const char* msp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
