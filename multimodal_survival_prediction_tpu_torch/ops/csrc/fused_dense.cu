// Fused train-mode BatchNorm -> ReLU -> 1x1x1 conv, for Hopper (sm_90a), in
// fp32 and in bf16 (the bf16 section below has its own design notes).
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
// (ops/fused_dense.py) computes mul/add/mean/rstd from the moments in torch
// and picks every launch plan (tile width, K chunks) from (N, C, F) and the
// card's SM count.
//
// Bound on the H100 (SXM; 3.35 TB/s, 495 TFLOP/s TF32 dense on the tensor
// cores, 67 TFLOP/s fp32 outside them): with the products on the tensor
// cores as three TF32 products each (below), apply (3 x 2NCF), bwd_reduce
// (3 x 4NCF) and bwd_dx (3 x 2NCF) are bound by the bytes of x, g and the
// output at F = 128 and by operations only at the transitions' F = 256, 512;
// the moments pass is bound by bytes. The DenseNet's small stages (N = 2048,
// 256, 32 rows) are bound by neither: they are a few microseconds of latency,
// so what matters there is how many blocks share the walk over C.
// In bf16 (989 TFLOP/s dense on the tensor cores) the bytes of x, g, the
// output and dx halve and one product replaces three: every bf16 kernel is
// bound by its bytes at the 16,384-row stages.
//
// Design:
//   * One GEMM core (TileCopy, split_b, gemm_mainloop) serves the three
//     products: apply (M = rows, K = C, N = F), the dW partial (M = C,
//     K = rows, N = F) and da = g W^T (M = rows, K = F, N = C; bwd_reduce's
//     second half and bwd_dx). A block is one warpgroup (128 threads); its
//     tile is 64 x 128 (one column tile for F = 128, so x is staged and
//     normalized once) or 64 x 64 where the grid would otherwise leave SMs
//     idle; 16-deep K steps; two blocks a SM.
//   * Pipelined loads: a ring of kStages (3) shared-memory stages, above
//     48 KB as dynamic shared memory. Every operand tile arrives by cp.async
//     (16 bytes a thread; 4-byte copies where a row is not 16-byte aligned;
//     the ragged edge is zero-filled by the copy's source size, never read),
//     two steps ahead of the arithmetic.
//   * The product: fp32-accurate on the tensor cores as a 3xTF32 split, by
//     wgmma (wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32, inline
//     PTX) with A from registers and B from shared memory. Each fp32 operand
//     is split once, big = v rounded to nearest TF32 (by integer add and mask,
//     which was faster here than cvt.rna.tf32.f32), small = v - big: A by the
//     warp that owns its 16 rows, as it reads its fragments from the raw
//     tile; B by a pass of the whole block over the raw tile (split_b), which
//     also lays it out as wgmma reads it (K-major core matrices, no swizzle:
//     TF32 wgmma takes no other major, and g and W^T arrive with the other
//     axis contiguous). big_a*big_b + big_a*small_b + small_a*big_b of each
//     8-deep slab is chained from zero by three wgmma and added to the fp32
//     accumulators by the CUDA cores: the tensor core truncates its sums, and
//     one long chain an output left errors three to five times the CUDA-core
//     product's. A first version of this core on mma.sync.m16n8k8 (8 warps as
//     2 x 4, every warp converting the fragments it read) spent most of its
//     instruction slots converting: A was converted by four warps, B by two,
//     and mma.sync itself kept the warp schedulers busy, so tensor time and
//     conversion time added up. wgmma with A from registers keeps the
//     prologue where it was (fp32 registers) and runs beside the schedulers.
//   * The BN + ReLU prologue runs in those registers: relu(round(round(x*mul)
//     + add)) in true fp32, the value torch's eager `x * mul + add` gives, so
//     the ReLU mask equals the plain version's. mul/add for the block's
//     channel range are staged into shared memory once, behind the first
//     copies. The normalized trunk never reaches device memory.
//   * Split-K for small grids, fixed-order fold: apply splits C across
//     blockIdx.z into chunks of whole K steps (at most kMaxK channels, the
//     staged mul/add), writes per-chunk partial outputs and folds them in
//     ascending order; dW splits the rows the same way. da contracts over F
//     only (8 steps at F = 128), and both of its users split F where the
//     grid is small: bwd_reduce's dbeta/dgamma partials then count row tiles
//     x F chunks; bwd_dx's epilogue is affine in da (the mask [z > 0]
//     depends on x alone), so its F chunks are the blocks of one
//     thread-block cluster, folded through distributed shared memory before
//     the mask and the BN backward run once (bwd_dx_cluster_kernel). Blocks
//     run in parallel in no order, so every cross-block sum (moments, dW
//     over row chunks, dbeta/dgamma over row tiles, apply's channel chunks,
//     bwd_dx's F chunks) is per-block partials folded in a fixed order, by a
//     second kernel or inside the cluster: no atomics, the same bits run to
//     run.
//   * bwd_reduce is two launches: one runs both products side by side, part
//     of its grid computing dW partials and the rest da tiles (64 x 64) with
//     the dbeta/dgamma epilogue, both into one scratch buffer; one folds that
//     into (dW, dbeta, dgamma). A small stage fills the card with the two
//     products together and pays one launch's latency; at 16,384 rows, where
//     each would fill the card alone, one launch was as fast as two or
//     faster. The products are not fused block by block: a block that owned
//     a row chunk for both would need all C x F dW accumulators (up to
//     1024 x 128 fp32, twice an SM's register file).
//   * Ragged tiles: rows >= N, channels >= C, outputs >= F are zero-filled on
//     the way in and masked on the way out, so any N >= 1 and any C, F work;
//     the JAX wrapper instead tiles only by exact divisors of N.
//   * W is read through two strides, so the wrapper passes the conv kernel
//     (F, C) as the (C, F) operand without a transposed copy; each product is
//     instantiated for either axis of W being the contiguous one.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 128;  // one warpgroup a GEMM block
constexpr int kBM = 64;        // block tile rows: the M of one wgmma
constexpr int kBK = 16;        // depth of one shared-memory step
constexpr int kStages = 3;     // shared-memory ring depth
constexpr int kKPad = 4;       // K-contiguous tile: rows of kBK + kKPad floats
constexpr int kOPad = 8;       // outer-contiguous tile: rows of T + kOPad
constexpr int kMaxK = 1024;    // most channels one apply block contracts over
constexpr int kFoldThreads = 256;
constexpr int kMaxCluster = 8;  // bwd_dx's F chunks: the portable cluster size
static_assert(kBK == 16 && kMaxK % kBK == 0, "a step is two 8-deep slabs");

constexpr int kMomCh = 32;     // moments: channels per block (one warp wide)
constexpr int kMomLanes = 8;   // moments: row lanes per block

// z = x*mul + add with two roundings, as torch's eager `x * mul + add`.
__device__ __forceinline__ float bn_z(float x, float mul, float add) {
  return __fadd_rn(__fmul_rn(x, mul), add);
}

// ------------------------------------------------------------ the GEMM core

// A shared-memory tile holds T outer positions (rows of A, columns of B) by
// kBK positions of K. kKC: K is the contiguous axis (rows of kBK + kKPad
// floats), else the outer axis is (rows of T + kOPad floats). Either padding
// makes the fragment reads of A (outer = lane / 4, k = lane % 4) hit 32
// different banks.
template <int T>
constexpr int kTileFloats = T * (kBK + kKPad);  // >= kBK*(T + kOPad), T >= 32
template <int NT>
constexpr int kStageFloats = kTileFloats<kBM> + kTileFloats<32 * NT>;
// B's big and small halves of one step, in the layout wgmma reads
template <int NT>
constexpr int kSplitFloats = 2 * 32 * NT * kBK;
template <int NT>  // staged per-channel vectors, the ring, the split B tile
constexpr int kSmemBytes =
    (2 * kMaxK + kStages * kStageFloats<NT> + kSplitFloats<NT>) * 4;
// da's epilogue reads its 64 x 32 NT tile of x from shared memory, rows of
// 32 NT + kOPad floats (float2 reads by row = lane / 4 then hit every bank)
template <int NT>
constexpr int kXTileFloats = kBM * (32 * NT + kOPad);
template <int NT>
constexpr int kDaSmemBytes = kSmemBytes<NT> + kXTileFloats<NT> * 4;
static_assert(6 * 128 <= 2 * kMaxK, "da stages six vectors of a tile's width");
// two blocks a SM (227 KB, 1 KB of it reserved a block)
static_assert(2 * (kDaSmemBytes<4> + 1024) <= 227 * 1024, "two blocks a SM");

template <int T, bool kKC>
__device__ __forceinline__ int tile_idx(int o, int k) {
  return kKC ? o * (kBK + kKPad) + k : k * (T + kOPad) + o;
}

// Calls fn(o, k, width) for the pieces of a tile this thread owns: 16-byte
// pieces (width 4 along the contiguous axis) when vec, single floats else.
template <int T, bool kKC, class Fn>
__device__ __forceinline__ void for_own_pieces(bool vec, Fn fn) {
  if (vec) {
    constexpr int kPieces = T * kBK / 4;
    static_assert(kPieces % kThreads == 0, "tile must split evenly");
#pragma unroll
    for (int i = 0; i < kPieces / kThreads; ++i) {
      const int u = threadIdx.x + i * kThreads;
      if (kKC) fn(u / (kBK / 4), (u % (kBK / 4)) * 4, 4);
      else fn((u % (T / 4)) * 4, u / (T / 4), 4);
    }
  } else {
    constexpr int kPieces = T * kBK;
#pragma unroll
    for (int i = 0; i < kPieces / kThreads; ++i) {
      const int e = threadIdx.x + i * kThreads;
      if (kKC) fn(e / kBK, e % kBK, 1);
      else fn(e % T, e / T, 1);
    }
  }
}

__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         int width, int live) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int bytes = 4 * live;  // the rest of the piece is zero-filled
  if (width == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(bytes)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(bytes)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// One operand's tile copies, step after step along K. Element (o, k) of the
// next step's tile is base[o*so + k*sk] for o < o_left and k < k_left, else 0
// (zero-filled by the copy's source size, not read). vec: the tile's
// contiguous axis has stride 1 and every 4-float piece is 16-byte aligned.
// The state is one pointer and two counts, so a step's addressing is a few
// integer operations a piece.
template <int T, bool kKC>
struct TileCopy {
  const float* base;
  const float* safe;  // a valid address for pieces that read nothing
  long long so, sk;
  int o_left, k_left;
  bool vec;

  // The tile's outer positions start at o0 of o_lim, its K at k0 of k_lim.
  __device__ __forceinline__ TileCopy(const float* src, long long o0,
                                      long long o_lim, long long so_,
                                      long long k0, long long k_lim,
                                      long long sk_, bool vec_)
      : base(src + o0 * so_ + k0 * sk_), safe(src), so(so_), sk(sk_),
        o_left(static_cast<int>(min(max(o_lim - o0, 0LL), 1LL * T))),
        k_left(static_cast<int>(min(max(k_lim - k0, 0LL), 1LL << 30))),
        vec(vec_) {}

  // Starts the copies of the next step into `tile`.
  __device__ __forceinline__ void start(float* tile) {
    for_own_pieces<T, kKC>(vec, [&](int o, int k, int width) {
      const int along = kKC ? k_left - k : o_left - o;
      const bool across = kKC ? o < o_left : k < k_left;
      const int live = across ? min(max(along, 0), width) : 0;
      const long long at = width == 1 ? o * so + k * sk
                           : kKC      ? o * so + k
                                      : o + k * sk;
      cp_async(tile + tile_idx<T, kKC>(o, k), live ? base + at : safe, width,
               live);
    });
    base += kBK * sk;
    k_left -= kBK;
  }
};

// v = big + small exactly: big is v rounded to TF32's 10 mantissa bits (to
// nearest, ties away, as cvt.rna.tf32.f32 rounds, by an integer add and a
// mask), small the fp32 remainder, of which the tensor core reads the
// leading 10 bits: what is dropped is below 2^-22 |v|.
__device__ __forceinline__ void split_tf32(float v, uint32_t& big,
                                           uint32_t& small) {
  big = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(v - __uint_as_float(big));
}

// Where this thread sits in its warpgroup and in wgmma's fragments: warp w
// holds rows 16 w .. 16 w + 15 of the 64-row tile, and acc[j][2h + e] is the
// output at row 16 w + g + 8 h, column 8 j + 2 t + e of the tile.
struct Lane {
  int w, g, t;
  __device__ Lane() {
    const int lane = threadIdx.x % 32;
    w = threadIdx.x / 32;
    g = lane / 4;
    t = lane % 4;
  }
};

template <int NT>
constexpr int kNJ = 4 * NT;  // 8-column groups of a tile: acc[kNJ<NT>][4]

// The split B tile, as wgmma reads it: no swizzle, K-major core matrices of
// 8 columns x 4 depths (128 bytes, 16 a column). Element (n, k) of big and
// of small is float ((n / 8)*(kBK / 4) + k / 4)*32 + (n % 8)*4 + k % 4.
constexpr int kLbo = 128;              // bytes between core matrices along K
constexpr int kSbo = (kBK / 4) * 128;  // bytes between 8-column groups

// wgmma's 64-bit descriptor of a B slab (64 columns x 8 deep) at `slab`.
__device__ __forceinline__ uint64_t b_desc(const float* slab) {
  const uint64_t at =
      static_cast<uint64_t>(__cvta_generic_to_shared(slab)) & 0x3ffff;
  return (at >> 4) | (static_cast<uint64_t>(kLbo >> 4) << 16) |
         (static_cast<uint64_t>(kSbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most kPending of this thread's committed groups run.
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}
// Shared-memory writes of this thread become visible to wgmma's reads.
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d = a b (scale_d = 0) or d += a b: one 64 x 64 x 8 TF32 product of the
// warpgroup, A from registers, B from shared memory; asynchronous until
// wgmma_wait().
__device__ __forceinline__ void wgmma_tf32(float (&d)[8][4],
                                           const uint32_t (&a)[4],
                                           uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// Keeps the compiler from moving reads or writes of d across the
// asynchronous products' fence and wait.
template <int kN>
__device__ __forceinline__ void pin(float (&d)[kN][4]) {
#pragma unroll
  for (int j = 0; j < kN; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+f"(d[j][r])::"memory");
}

// Splits the raw B tile of a stage (32 NT columns x kBK deep) into its big
// and small TF32 halves in the layout wgmma reads (see kLbo). A thread
// converts four depths of one column a turn, neighbouring threads
// neighbouring columns: no bank conflicts either way.
template <int NT, bool kBKC>
__device__ __forceinline__ void split_b(const float* raw, float* big,
                                        float* small) {
  constexpr int kBN = 32 * NT;
#pragma unroll
  for (int i = 0; i < kBN * (kBK / 4) / kThreads; ++i) {
    const int u = threadIdx.x + i * kThreads;
    const int n = u % kBN, k4 = u / kBN;
    float v[4];
    if (kBKC) {
      const float4 q = *reinterpret_cast<const float4*>(
          raw + tile_idx<kBN, true>(n, 4 * k4));
      v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        v[q] = raw[tile_idx<kBN, false>(n, 4 * k4 + q)];
    }
    uint32_t b[4], s[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) split_tf32(v[q], b[q], s[q]);
    const int at = ((n / 8) * (kBK / 4) + k4) * 32 + (n % 8) * 4;
    *reinterpret_cast<uint4*>(big + at) = make_uint4(b[0], b[1], b[2], b[3]);
    *reinterpret_cast<uint4*>(small + at) = make_uint4(s[0], s[1], s[2], s[3]);
  }
}

// The pipelined K loop. load(stage) starts the cp.async copies of the next
// step into a stage (it is called once a step, in order); copies run kStages
// - 1 steps ahead of the arithmetic. A step: B's raw tile is split into the
// tile wgmma reads (split_b) while each warp reads its own 16 rows of A from
// the raw tile, runs a_op on them in fp32 and splits them in registers (no
// element of A or B is converted twice); then, for each of the two 8-deep
// slabs and each 64 columns, big*big, big*small and small*big are chained
// from zero by three asynchronous wgmma and added to the accumulators by the
// CUDA cores. The tensor core truncates its fp32 sums (rounds toward zero),
// so one long chain an output drifts low by about half an ulp a link; the
// CUDA cores round to nearest, and the error no longer grows with K. Two
// blocks a SM keep the tensor cores busy while one of them splits or adds.
// a_op(v, s, r, k) is the prologue of A's element at row r, depth k of step
// s. prep() runs once, behind the first copies and before a barrier: it
// stages what a_op reads. On return every copy has landed and the ring is
// free for the epilogue.
template <int NT, bool kAKC, bool kBKC, class Load, class Prep, class AOp>
__device__ __forceinline__ void gemm_mainloop(float* ring, int steps,
                                              float (&acc)[kNJ<NT>][4],
                                              const Lane& ln, Load load,
                                              Prep prep, AOp a_op) {
  constexpr int kBN = 32 * NT;
  float* big = ring + kStages * kStageFloats<NT>;
  float* small = big + kBN * kBK;
#pragma unroll
  for (int j = 0; j < kNJ<NT>; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load(ring + s * kStageFloats<NT>);
    cp_async_commit();  // one group a step, empty past the end
  }
  prep();
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<kStages - 2>();  // this thread's copies of step s landed
    const float* stage = ring + (s % kStages) * kStageFloats<NT>;
    // step s (and, at s = 0, what prep staged) visible to all; step s - 1
    // done by all: its stage and the split tile are free
    __syncthreads();
    const int ahead = s + kStages - 1;
    if (ahead < steps) load(ring + (ahead % kStages) * kStageFloats<NT>);
    cp_async_commit();
    split_b<NT, kBKC>(stage + kTileFloats<kBM>, big, small);
    fence_async_proxy();
    uint32_t a_big[2][4], a_small[2][4];
#pragma unroll
    for (int slab = 0; slab < 2; ++slab)
#pragma unroll
      for (int q = 0; q < 4; ++q) {  // (r, k), (r+8, k), (r, k+4), (r+8, k+4)
        const int row = 16 * ln.w + ln.g + 8 * (q & 1);
        const int k = 8 * slab + ln.t + 4 * (q >> 1);
        split_tf32(a_op(stage[tile_idx<kBM, kAKC>(row, k)], s, row, k),
                   a_big[slab][q], a_small[slab][q]);
      }
    __syncthreads();  // the split tile visible to all
    // The step's products in units of 64 columns x one slab (the wide
    // tile's left and right halves, slab after slab), two sums taking
    // turns: while the tensor cores run one unit's chain, the CUDA cores
    // add the sums of the unit before.
    constexpr int kUnits = NT;  // 2 slabs x NT / 2 halves
    float sum[2][8][4];
    const auto chain = [&](int u) {
      const int slab = u / (NT / 2), half = u % (NT / 2);
      const int at = slab * 64 + half * 8 * (kBK / 4) * 32;
      const uint64_t d_big = b_desc(big + at), d_small = b_desc(small + at);
      pin(sum[u % 2]);
      wgmma_fence();
      wgmma_tf32(sum[u % 2], a_big[slab], d_big, 0);
      wgmma_tf32(sum[u % 2], a_big[slab], d_small, 1);
      wgmma_tf32(sum[u % 2], a_small[slab], d_big, 1);
      wgmma_commit();
    };
    const auto add = [&](int u) {
      const int half = u % (NT / 2);
      pin(sum[u % 2]);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[half * 8 + j][q] += sum[u % 2][j][q];
    };
    chain(0);
    chain(1);
#pragma unroll
    for (int u = 2; u < kUnits; ++u) {
      wgmma_wait<1>();
      add(u - 2);
      chain(u);
    }
    wgmma_wait<1>();
    add(kUnits - 2);
    wgmma_wait<0>();
    add(kUnits - 1);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// dst[(row0 + r)*ld + col0 + c] = acc(r, c) for row0 + r < rows, col0 + c <
// cols; vec2: ld is even and dst 8-byte aligned (col0 + c is even).
template <int NT>
__device__ __forceinline__ void store_acc(float* __restrict__ dst,
                                          long long ld, long long row0,
                                          long long rows, int col0, int cols,
                                          const float (&acc)[kNJ<NT>][4],
                                          const Lane& ln, bool vec2) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long row = row0 + 16 * ln.w + ln.g + 8 * h;
    if (row >= rows) continue;
#pragma unroll
    for (int j = 0; j < kNJ<NT>; ++j) {
      const int col = col0 + 8 * j + 2 * ln.t;
      float* p = dst + row * ld + col;
      if (vec2 && col + 1 < cols) {
        *reinterpret_cast<float2*>(p) =
            make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
      } else {
        if (col < cols) p[0] = acc[j][2 * h];
        if (col + 1 < cols) p[1] = acc[j][2 * h + 1];
      }
    }
  }
}

// Stages v[ch0 + i] (0 past ch_lim) for i < count into shared memory.
__device__ __forceinline__ void stage_vector(float* dst,
                                             const float* __restrict__ v,
                                             int ch0, int ch_lim, int count) {
  for (int i = threadIdx.x; i < count; i += kThreads)
    dst[i] = ch0 + i < ch_lim ? __ldg(v + ch0 + i) : 0.f;
}

// Starts the cp.async copies (in the caller's next group) of rows [r_lo,
// r_hi) of a block's 64 x kBN tile of x (N, C) at row m0, channel n0 into
// x_tile, rows of kBN + kOPad floats; rows past N and channels past C are
// zero-filled.
template <int kBN>
__device__ __forceinline__ void stage_x_tile(float* x_tile,
                                             const float* __restrict__ x,
                                             long long m0, int n0, long long n,
                                             int c, int r_lo, int r_hi,
                                             bool x_vec) {
  const int width = x_vec ? 4 : 1;
  for (int e = r_lo * kBN + threadIdx.x * width; e < r_hi * kBN;
       e += kThreads * width) {
    const int r = e / kBN, col = e % kBN;
    const long long row = m0 + r;
    const int left = c - (n0 + col);
    const int live = row < n && left > 0 ? min(left, width) : 0;
    cp_async(x_tile + r * (kBN + kOPad) + col,
             live ? x + row * c + n0 + col : x, width, live);
  }
}

// ---------------------------------------------------------------- moments

// A bf16 held as its 16 bits, as fp32.
__device__ __forceinline__ float bf16_bits_to_f32(uint16_t b) {
  return __uint_as_float(static_cast<uint32_t>(b) << 16);
}

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

// The fold of every kernel's per-block partials, two segments in one launch
// (the second may be empty):
//   out[j]      = sum_{k < chunks1} part[k*m1 + j]                   j < m1
//   out[m1 + j] = sum_{k < chunks2} part[chunks1*m1 + k*m2 + j]      j < m2
// A thread folds kWidth neighbouring outputs (4 as float4 where m1, m2 and
// the pointers allow and there are outputs enough, else 1). Block =
// kFoldThreads / kLanes output groups x kLanes lanes; lane l sums chunks l,
// l + kLanes, ... ascending, then lane 0 adds the lanes in order: a fixed
// order for a given launch shape, which the caller picks from the sizes
// alone, so the same bits run to run.
template <int kWidth, int kLanes>
__global__ void __launch_bounds__(kFoldThreads)
fold_parts_kernel(const float* __restrict__ part, int chunks1, long long m1,
                  int chunks2, long long m2, float* __restrict__ out) {
  constexpr int kCols = kFoldThreads / kLanes;
  const int col = threadIdx.x % kCols, lane = threadIdx.x / kCols;
  const long long j =
      (static_cast<long long>(blockIdx.x) * kCols + col) * kWidth;
  const bool live = j < m1 + m2;
  float s[kWidth];
#pragma unroll
  for (int i = 0; i < kWidth; ++i) s[i] = 0.f;
  if (live) {
    const bool first = j < m1;
    const float* p = first ? part + j : part + chunks1 * m1 + (j - m1);
    const long long m = first ? m1 : m2;
    const int chunks = first ? chunks1 : chunks2;
#pragma unroll 8
    for (int k = lane; k < chunks; k += kLanes) {
      if constexpr (kWidth == 4) {
        const float4 v = *reinterpret_cast<const float4*>(p + k * m);
        s[0] += v.x, s[1] += v.y, s[2] += v.z, s[3] += v.w;
      } else {
        s[0] += p[k * m];
      }
    }
  }
  if constexpr (kLanes > 1) {
    __shared__ float red[kLanes][kCols * kWidth];
#pragma unroll
    for (int i = 0; i < kWidth; ++i) red[lane][col * kWidth + i] = s[i];
    __syncthreads();
    if (lane == 0)
      for (int l = 1; l < kLanes; ++l)
#pragma unroll
        for (int i = 0; i < kWidth; ++i) s[i] += red[l][col * kWidth + i];
  }
  if (live && lane == 0) {
    if constexpr (kWidth == 4)
      *reinterpret_cast<float4*>(out + j) = make_float4(s[0], s[1], s[2], s[3]);
    else
      out[j] = s[0];
  }
}

// ------------------------------------------------------------------ apply

// out[blockIdx.z] (N, F) = relu(x*mul + add)[:, chunk] @ W[chunk, :], the
// chunk being channels [blockIdx.z*k_per_chunk, +k_per_chunk) (a multiple of
// kBK, at most kMaxK); grid (ceil(N/64), ceil(F/(32 NT)), chunks).
// kWKC: W's channel axis is the contiguous one (the conv kernel's layout).
template <int NT, bool kWKC>
__global__ void __launch_bounds__(kThreads, 2)
apply_kernel(const float* __restrict__ x, const float* __restrict__ mul,
             const float* __restrict__ add, const float* __restrict__ w,
             long long w_sc, long long w_sf, long long n, int c, int f,
             int k_per_chunk, bool x_vec, bool w_vec, bool out_vec,
             float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* smul = reinterpret_cast<float*>(smem4);
  float* sadd = smul + kMaxK;
  float* ring = sadd + kMaxK;
  const Lane ln;
  const long long m0 = static_cast<long long>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * 32 * NT;
  const int k_beg = blockIdx.z * k_per_chunk;
  const int k_end = min(c, k_beg + k_per_chunk);

  // A(m = row, k = channel) = x, B(k = channel, n = output) = W
  TileCopy<kBM, true> a_copy(x, m0, n, c, k_beg, k_end, 1, x_vec);
  TileCopy<32 * NT, kWKC> b_copy(w, n0, f, w_sf, k_beg, k_end, w_sc, w_vec);
  float acc[kNJ<NT>][4];
  gemm_mainloop<NT, true, kWKC>(
      ring, (k_end - k_beg + kBK - 1) / kBK, acc, ln,
      [&](float* stage) {
        a_copy.start(stage);
        b_copy.start(stage + kTileFloats<kBM>);
      },
      [&] {
        stage_vector(smul, mul, k_beg, k_end, k_per_chunk);
        stage_vector(sadd, add, k_beg, k_end, k_per_chunk);
      },
      [&](float v, int s, int, int k) {
        return fmaxf(bn_z(v, smul[s * kBK + k], sadd[s * kBK + k]), 0.f);
      });
  store_acc<NT>(out + static_cast<long long>(blockIdx.z) * n * f, f, m0, n,
                n0, f, acc, ln, out_vec);
}

// ------------------------------------------------------------- bwd_reduce

// A block's place in its product's grid (nx: the grid's x extent). The two
// products of bwd_reduce share one launch, so neither reads blockIdx itself.
struct Block {
  int x, y, z, nx;
};

struct DwArgs {
  const float *x, *g, *mul, *add;
  long long n;
  int c, f;
  long long rows_per_chunk;
  bool x_vec, g_vec, out_vec;
  float* part;
};

// Partial dW over one chunk of rows: part[b.z] (C, F) = a[rows]^T g[rows],
// rows [b.z*rows_per_chunk, +rows_per_chunk) (a multiple of kBK); grid
// (ceil(C/64), ceil(F/(32 NT)), chunks).
template <int NT>
__device__ __forceinline__ void dw_block(const DwArgs& p, const Block& b) {
  const float *x = p.x, *g = p.g, *mul = p.mul, *add = p.add;
  const long long n = p.n;
  const int c = p.c, f = p.f;
  extern __shared__ float4 smem4[];
  float* smul = reinterpret_cast<float*>(smem4);
  float* sadd = smul + kMaxK;
  float* ring = sadd + kMaxK;
  const Lane ln;
  const int c0 = b.x * kBM;
  const int f0 = b.y * 32 * NT;
  const long long r0 = static_cast<long long>(b.z) * p.rows_per_chunk;
  const long long r1 = min(n, r0 + p.rows_per_chunk);

  // A(m = channel, k = row) = x[row, channel], B(k = row, n = output) = g
  TileCopy<kBM, false> a_copy(x, c0, c, 1, r0, r1, c, p.x_vec);
  TileCopy<32 * NT, false> b_copy(g, f0, f, 1, r0, r1, f, p.g_vec);
  float acc[kNJ<NT>][4];
  gemm_mainloop<NT, false, false>(
      ring, static_cast<int>((r1 - r0 + kBK - 1) / kBK), acc, ln,
      [&](float* stage) {
        a_copy.start(stage);
        b_copy.start(stage + kTileFloats<kBM>);
      },
      [&] {
        stage_vector(smul, mul, c0, c, kBM);
        stage_vector(sadd, add, c0, c, kBM);
      },
      [&](float v, int, int ch, int) {
        // rows past r1 become relu(add) here, against g rows that are 0
        return fmaxf(bn_z(v, smul[ch], sadd[ch]), 0.f);
      });
  store_acc<NT>(p.part + static_cast<long long>(b.z) * c * f, f, c0, c, f0, f,
                acc, ln, p.out_vec);
}

// --------------------------------------------------------- da = g W^T + BN

// da (N, C) = g (N, F) @ W^T over F, then per element:
//   z = x*mul + add, dz = z > 0 ? da : 0, xhat = (x - mean)*rstd
//   kDx = false: per-block partial sums over the block's 64 rows,
//                part[p][c] = sum dz, part[p][C + c] = sum dz*xhat. The sums
//                are linear in da, so a small grid may split F too: block z
//                contracts outputs [z*k_per_chunk, +k_per_chunk) (a multiple
//                of kBK) and writes p = z*(row tiles) + row tile.
//   kDx = true:  dx = mul*(dz - c1 - xhat*c2); one chunk (b.z = 0), the
//                unsplit launch (bwd_dx_cluster_kernel splits F).
// grid (ceil(N/64), ceil(C/(32 NT)), chunks). kWKC: W's F axis (the K of
// this product) is the contiguous one.
struct DaArgs {
  const float *g, *w;
  long long w_sc, w_sf;
  const float *x, *mul, *add, *mean, *rstd, *c1, *c2;
  long long n;
  int c, f, k_per_chunk;
  // dx_vec: dx's rows take float2 stores (bwd_dx_kernel), dx_vec4: float4
  // (bwd_dx_cluster_kernel). bwd_dx_kernel<4> sits at the register limit:
  // with one flag fewer (dx, part 8 bytes lower) ptxas spilled 64-136 bytes
  // there and the kernel ran 11 % slower on an H100.
  bool g_vec, w_vec, x_vec, dx_vec, dx_vec4;
  float *dx, *part;
};

// A da block's shared memory: the per-channel vectors (6 of 32 NT), the
// mainloop's ring and the block's tile of x (rows of 32 NT + kOPad floats).
struct DaSmem {
  float *vecs, *ring, *x_tile;
};

template <int NT>
__device__ __forceinline__ DaSmem da_smem() {
  extern __shared__ float4 smem4[];
  float* vecs = reinterpret_cast<float*>(smem4);
  float* ring = vecs + 2 * kMaxK;
  return {vecs, ring, ring + kStages * kStageFloats<NT> + kSplitFloats<NT>};
}

// The da product of the 64 x 32NT tile at row m0, channel n0 over F chunk
// kz (outputs [kz*k_per_chunk, +k_per_chunk)) into acc. Behind the product
// it fetches what the epilogue reads: rows [r_lo, r_hi) of the tile of x
// (by cp.async, in the next step's group) and the tile's slices of the
// first kVecs of (mul, add, mean, rstd, c1, c2).
template <int kVecs, int NT, bool kWKC>
__device__ __forceinline__ void da_product(const DaArgs& p, const DaSmem& s,
                                           long long m0, int n0, int kz,
                                           int r_lo, int r_hi, const Lane& ln,
                                           float (&acc)[kNJ<NT>][4]) {
  constexpr int kBN = 32 * NT;
  // A(m = row, k = f) = g[row, f], B(k = f, n = channel) = W[channel, f]
  const int k_beg = kz * p.k_per_chunk;
  const int k_end = min(p.f, k_beg + p.k_per_chunk);
  TileCopy<kBM, true> a_copy(p.g, m0, p.n, p.f, k_beg, k_end, 1, p.g_vec);
  TileCopy<kBN, kWKC> b_copy(p.w, n0, p.c, p.w_sc, k_beg, k_end, p.w_sf,
                             p.w_vec);
  gemm_mainloop<NT, true, kWKC>(
      s.ring, (k_end - k_beg + kBK - 1) / kBK, acc, ln,
      [&](float* stage) {
        a_copy.start(stage);
        b_copy.start(stage + kTileFloats<kBM>);
      },
      [&] {
        stage_x_tile<kBN>(s.x_tile, p.x, m0, n0, p.n, p.c, r_lo, r_hi,
                          p.x_vec);
        const float* src[6] = {p.mul, p.add, p.mean, p.rstd, p.c1, p.c2};
#pragma unroll
        for (int v = 0; v < kVecs; ++v)
          stage_vector(s.vecs + v * kBN, src[v], n0, p.c, kBN);
      },
      [](float v, int, int, int) { return v; });
}

// bwd_dx's epilogue at one element: the mask [z > 0] and the BN backward.
__device__ __forceinline__ float dx_of(float x, float da, float mul,
                                       float add, float mean, float rstd,
                                       float c1, float c2) {
  const float dz = bn_z(x, mul, add) > 0.f ? da : 0.f;
  return mul * (dz - c1 - (x - mean) * rstd * c2);
}

// Stores kW neighbouring values of a row of dx from channel ch on: one
// vector store where `vec` and all kW channels are below C, else the live
// ones one by one.
template <int kW>
__device__ __forceinline__ void store_dx(float* dst, const float (&v)[kW],
                                         int ch, int c, bool vec) {
  static_assert(kW == 2 || kW == 4, "a float2 or a float4 store");
  if (vec && ch + kW - 1 < c) {
    if constexpr (kW == 4)
      *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
    else
      *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int e = 0; e < kW; ++e)
      if (ch + e < c) dst[e] = v[e];
  }
}

template <bool kDx, int NT, bool kWKC>
__device__ __forceinline__ void da_block(const DaArgs& p, const Block& b) {
  const int c = p.c;
  constexpr int kBN = 32 * NT, kXLd = kBN + kOPad;
  const DaSmem s = da_smem<NT>();
  const float* vecs = s.vecs;
  const Lane ln;
  const long long m0 = static_cast<long long>(b.x) * kBM;
  const int n0 = b.y * kBN;
  float acc[kNJ<NT>][4];
  da_product<kDx ? 6 : 4, NT, kWKC>(p, s, m0, n0, b.z, 0, kBM, ln, acc);

  float s_db[kNJ<NT>][2], s_dg[kNJ<NT>][2];
  const auto pair = [](const float* p) {
    return *reinterpret_cast<const float2*>(p);
  };
#pragma unroll
  for (int j = 0; j < kNJ<NT>; ++j) {
    // two neighbouring channels a thread; channels past C hold zeros
    // (vectors and x alike) and are not stored
    const int col = 8 * j + 2 * ln.t;
    const int ch = n0 + col;
    const float2 mu = pair(vecs + col), ad = pair(vecs + kBN + col);
    const float2 me = pair(vecs + 2 * kBN + col);
    const float2 rs = pair(vecs + 3 * kBN + col);
    float2 k1 = make_float2(0.f, 0.f), k2 = k1;
    if constexpr (kDx) {
      k1 = pair(vecs + 4 * kBN + col);
      k2 = pair(vecs + 5 * kBN + col);
    }
    s_db[j][0] = s_db[j][1] = s_dg[j][0] = s_dg[j][1] = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int r = 16 * ln.w + ln.g + 8 * h;
        const float2 xv = pair(s.x_tile + r * kXLd + col);
        if constexpr (kDx) {
          const long long row = m0 + r;
          if (row >= p.n) continue;
          const float d[2] = {
              dx_of(xv.x, acc[j][2 * h], mu.x, ad.x, me.x, rs.x, k1.x, k2.x),
              dx_of(xv.y, acc[j][2 * h + 1], mu.y, ad.y, me.y, rs.y, k1.y,
                    k2.y)};
          store_dx<2>(p.dx + row * c + ch, d, ch, c, p.dx_vec);
        } else {
          // rows past N add 0: their da is 0 (g is zero-filled)
          const float dz0 =
              bn_z(xv.x, mu.x, ad.x) > 0.f ? acc[j][2 * h] : 0.f;
          const float dz1 =
              bn_z(xv.y, mu.y, ad.y) > 0.f ? acc[j][2 * h + 1] : 0.f;
          const float xhat0 = (xv.x - me.x) * rs.x;
          const float xhat1 = (xv.y - me.y) * rs.y;
          s_db[j][0] += dz0;
          s_db[j][1] += dz1;
          s_dg[j][0] += dz0 * xhat0;
          s_dg[j][1] += dz1 * xhat1;
        }
      }
  }

  if constexpr (!kDx) {
    // Column sums over the block's 64 rows in a fixed order: the 8 row
    // lanes of a warp by butterfly, then the four warps.
    constexpr int kWarps = kThreads / 32;
    float* red = s.ring;  // [2 (db, dg)][kWarps][32 NT]
#pragma unroll
    for (int j = 0; j < kNJ<NT>; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float db = s_db[j][e], dg = s_dg[j][e];
#pragma unroll
        for (int mask = 4; mask < 32; mask <<= 1) {
          db += __shfl_xor_sync(0xffffffffu, db, mask);
          dg += __shfl_xor_sync(0xffffffffu, dg, mask);
        }
        if (ln.g == 0) {
          const int col = 8 * j + 2 * ln.t + e;
          red[ln.w * kBN + col] = db;
          red[(kWarps + ln.w) * kBN + col] = dg;
        }
      }
    __syncthreads();
    if (threadIdx.x < kBN) {
      const int col = threadIdx.x, ch = n0 + col;
      if (ch < c) {
        float db = 0.f, dg = 0.f;
        for (int r = 0; r < kWarps; ++r) {
          db += red[r * kBN + col];
          dg += red[(kWarps + r) * kBN + col];
        }
        float* dst =
            p.part + (static_cast<long long>(b.z) * b.nx + b.x) * 2 * c;
        dst[ch] = db;
        dst[c + ch] = dg;
      }
    }
  }
}

// bwd_dx: the da product with the BN backward as its epilogue; grid
// (ceil(N/64), ceil(C/(32 NT))).
template <int NT, bool kWKC>
__global__ void __launch_bounds__(kThreads, 2)
bwd_dx_kernel(const DaArgs p) {
  da_block<true, NT, kWKC>(
      p, Block{static_cast<int>(blockIdx.x), static_cast<int>(blockIdx.y), 0,
               static_cast<int>(gridDim.x)});
}

// bwd_dx with F split across a thread-block cluster, for grids that leave
// SMs idle: grid (ceil(N/64), ceil(C/64), chunks), cluster (1, 1, chunks),
// 2 <= chunks <= kMaxCluster. dx is affine in da = sum_k P_k, P_k = g[:, F
// chunk k] W[:, F chunk k]^T, because the mask [z > 0] depends on x alone.
// So block k of a cluster contracts F chunk k (k_per_chunk outputs, a
// multiple of kBK) on the shared mainloop and leaves P_k in its own shared
// memory; after a cluster barrier, rank r sums P_0 + P_1 + ... in that order
// for its share of the tile's live rows, reading its peers' shared memory,
// and applies the mask and the BN backward to that share alone. One launch,
// no scratch in device memory, no atomics: the same bits run to run, and the
// unsplit kernel's but for the order of the sum over F.
template <bool kWKC>
__global__ void __launch_bounds__(kThreads, 2)
bwd_dx_cluster_kernel(const DaArgs p) {
  constexpr int NT = 2, kBN = 32 * NT, kXLd = kBN + kOPad, kQuads = kBN / 4;
  const DaSmem s = da_smem<NT>();
  float* part = s.ring;  // P_k, kBM rows of kXLd floats, once the ring is free
  static_assert(kBM * kXLd <= kStages * kStageFloats<NT>, "P_k in the ring");
  const cg::cluster_group cluster = cg::this_cluster();
  const int chunks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const Lane ln;
  const long long n = p.n, m0 = static_cast<long long>(blockIdx.x) * kBM;
  const int c = p.c, n0 = blockIdx.y * kBN;
  // this rank's rows of the tile: an even share of the live ones
  const int live = static_cast<int>(min(1LL * kBM, n - m0));
  const int share = (live + chunks - 1) / chunks;
  const int r_lo = min(live, rank * share), r_hi = min(live, r_lo + share);
  float acc[kNJ<NT>][4];
  da_product<6, NT, kWKC>(p, s, m0, n0, rank, r_lo, r_hi, ln, acc);

#pragma unroll
  for (int j = 0; j < kNJ<NT>; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * ln.w + ln.g + 8 * h, col = 8 * j + 2 * ln.t;
      *reinterpret_cast<float2*>(part + r * kXLd + col) =
          make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
    }
  cluster.sync();  // every P_k written and visible to the whole cluster

  const float* peer[kMaxCluster];
#pragma unroll
  for (int k = 0; k < kMaxCluster; ++k)
    peer[k] = cluster.map_shared_rank(part, k < chunks ? k : 0);
  const auto quad = [](const float* q) {
    return *reinterpret_cast<const float4*>(q);
  };
  for (int u = threadIdx.x; u < (r_hi - r_lo) * kQuads; u += kThreads) {
    const int r = r_lo + u / kQuads, col = (u % kQuads) * 4;
    const int at = r * kXLd + col;
    float4 q[kMaxCluster];  // all loads in flight before the sum
#pragma unroll
    for (int k = 0; k < kMaxCluster; ++k)
      if (k < chunks) q[k] = quad(peer[k] + at);
    float4 da = q[0];
#pragma unroll
    for (int k = 1; k < kMaxCluster; ++k)
      if (k < chunks) da.x += q[k].x, da.y += q[k].y, da.z += q[k].z,
                      da.w += q[k].w;
    const float4 xv = quad(s.x_tile + at), mu = quad(s.vecs + col),
                 ad = quad(s.vecs + kBN + col),
                 me = quad(s.vecs + 2 * kBN + col),
                 rs = quad(s.vecs + 3 * kBN + col),
                 k1 = quad(s.vecs + 4 * kBN + col),
                 k2 = quad(s.vecs + 5 * kBN + col);
    const float out[4] = {
        dx_of(xv.x, da.x, mu.x, ad.x, me.x, rs.x, k1.x, k2.x),
        dx_of(xv.y, da.y, mu.y, ad.y, me.y, rs.y, k1.y, k2.y),
        dx_of(xv.z, da.z, mu.z, ad.z, me.z, rs.z, k1.z, k2.z),
        dx_of(xv.w, da.w, mu.w, ad.w, me.w, rs.w, k1.w, k2.w)};
    store_dx<4>(p.dx + (m0 + r) * c + n0 + col, out, n0 + col, c, p.dx_vec4);
  }
  cluster.sync();  // no block leaves while a peer may still read its P_k
}

// bwd_reduce's two products in one launch, sharing the card and one launch's
// latency. Blocks [0, dw.n) of the 1-D grid are the dW partials' grid
// (dw.x x dw.y x ...), the rest the da product's (64 x 64 tiles), both in
// x-fastest order.
struct Grid {
  int x, y, n;  // extents in x and y, blocks in all
};

template <int kDwNT, bool kWKC>
__global__ void __launch_bounds__(kThreads, 2)
bwd_reduce_kernel(const DwArgs dw, const DaArgs da, const Grid dw_grid,
                  const Grid da_grid) {
  int id = blockIdx.x;
  if (id < dw_grid.n) {
    dw_block<kDwNT>(dw, Block{id % dw_grid.x, id / dw_grid.x % dw_grid.y,
                              id / (dw_grid.x * dw_grid.y), dw_grid.x});
  } else {
    id -= dw_grid.n;
    da_block<false, 2, kWKC>(
        da, Block{id % da_grid.x, id / da_grid.x % da_grid.y,
                  id / (da_grid.x * da_grid.y), da_grid.x});
  }
}

// ------------------------------------------------------------------- bf16
//
// The bf16 variants of the four kernels (the JAX kernels run in the compute
// dtype: bf16 operands into the products, fp32 accumulation; out and dx in
// bf16; the moments, dW, dgamma and dbeta in fp32). A product of two bf16
// values is exact in fp32, so one bf16 product replaces the fp32 core's
// three TF32 ones. apply, bwd_reduce and bwd_dx run on one Hopper GEMM
// core: wgmma (wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16), B
// always and A mostly read from shared memory through descriptors, fed by a
// ring of cp.async stages. A block is one warpgroup and its tile 64 x 64
// (apply's also 128 x 128). The moments have a kernel of their own (its
// note is above moments_bf16_kernel).
//   * A step is kBKW (64) deep: 128 bytes of every K row, the width of the
//     128-byte swizzle. Each operand tile lands as it lies in memory, by
//     16-byte cp.async into the swizzled layout its descriptor names:
//     K-major ([outer][K], as x in apply, g, and W where its K axis is
//     contiguous) or MN-major ([K][outer], as x read as x^T, g as dW's B,
//     and the conv kernel's W in the backward), which wgmma reads through
//     its transpose bits (bf16 takes either major): no transposing pass. A
//     row that is not 16-byte aligned is loaded element by element and
//     stored by the thread (a generic write, which that thread fences into
//     the async proxy); the ragged edge is zero-filled by the copy's source
//     size, never read.
//   * The ring has kStagesW = 2 stages: the next step's copies run while
//     this step's products do. On an H100 a third stage cost bwd_dx a
//     block a SM (3 instead of 4) and bought bwd_reduce nothing, not even
//     for its long dW blocks alone (ops/bf16_bwd_sweep.py times the
//     depths; PERF.md has the numbers). Code size mattered more: with the
//     unaligned fallback inlined at every copy site, each extra stage (one
//     more inlined load) made every step slower; out of line
//     (copy_piece_slow) it made every stage of bwd_reduce faster.
//   * A from registers, with a prologue on the way in (apply's A and dW's):
//     a = bf16(relu(x*mul + add)) is made from the raw x tile as its
//     fragment is read (ldmatrix: .x4 from K-major x in apply, .x4.trans
//     from MN-major x in dW), in fp32 with the plain version's two
//     roundings (bn_z: an FMA would round once and flip ReLU masks at the
//     boundary), rounded to bf16 once, and wgmma reads A from those
//     registers: no generic write to fence (an in-place pass over the
//     stage would need fence.proxy.async, which also waits for the copies
//     in flight).
//   * apply: out = bf16(a @ W). mul and add arrive with each step's copies
//     (64 of each, into a ring of their own, zero past C), so a block
//     takes any number of channels; past C the copies zero-fill x and W
//     too, and a = relu(0*0 + 0) = 0 adds exact zeros. Where its blocks
//     take 7/8 of the SMs (the 16,384-row stages) the tile is 128 x 128: a
//     block of two warpgroups, each making its 64 rows' A fragments and
//     running two m64n64k16 products a slice that share them (x normalised
//     once an element), both reading one copy of W's tile: a 64 x 128 tile
//     re-read W from L2 for every 64 rows, and on an H100 W's copies alone
//     took longer than x's. Elsewhere the tile is 64 x 64,
//     and where the grid leaves SMs idle C is split into at most
//     kMaxCluster chunks of whole steps, the blocks of one thread-block
//     cluster, folded in rank order through bulk copies between their
//     shared memories (below apply_bf16_kernel's mainloop). One launch, no
//     fp32 scratch in device memory, no atomics. The products accumulate
//     in place (a chunk is at most a few steps: the tensor core's truncated
//     sums drift far below the bf16 output's ulp).
//   * bwd_dx copies its tile of x and the six per-channel vectors behind
//     the first operand copies, so the epilogue reads shared memory only;
//     dx is written over x in shared memory and leaves as 16-byte stores,
//     whole rows. Where the grid leaves SMs idle F is split over the
//     blocks of a thread-block cluster (bwd_dx_cluster_bf16_kernel, as the
//     fp32 bwd_dx_cluster_kernel), folded in rank order through distributed
//     shared memory. Four blocks a SM.
//   * bwd_reduce keeps its one launch of dW blocks and da blocks. dW's fp32
//     partials hold at most a quarter of x's bytes, so its row chunks are
//     few and long; where that leaves dW blocks the long pole (few tiles),
//     the chunks are 4 steps and the Q blocks of one thread-block cluster
//     sum their partials in rank order through distributed shared memory
//     before one partial is written. Each step's four products are chained
//     from zero and added to the fp32 accumulators by the CUDA cores: the
//     tensor core truncates its sums, and one chain over 1,024 rows would
//     drift (the fp32 core's finding).
//   * What bounds them: at the 16,384-row stages the 64 x 64 tiles read g,
//     x and W from L2 several times over (bwd_reduce moves ~72 MB between
//     L2 and the SMs for 11.7 MB of its own bytes), and each dW block's
//     steps wait on their copies in turn; the small stages are a few
//     microseconds of latency a launch.

__device__ __forceinline__ uint16_t f32_to_bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  return static_cast<uint32_t>(f32_to_bf16_bits(lo)) |
         (static_cast<uint32_t>(f32_to_bf16_bits(hi)) << 16);
}
__device__ __forceinline__ void unpack8(const uint4& v, uint16_t (&e)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int q = 0; q < 8; ++q)
    e[q] = static_cast<uint16_t>(w[q / 2] >> (16 * (q % 2)));
}
__device__ __forceinline__ uint4 pack8(const uint16_t (&e)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    w[j] = static_cast<uint32_t>(e[2 * j]) |
           (static_cast<uint32_t>(e[2 * j + 1]) << 16);
  return make_uint4(w[0], w[1], w[2], w[3]);
}

constexpr int kBKW = 64;       // depth of a step: 128 bytes of a bf16 K row
constexpr int kStagesW = 2;    // ring depth (see above)
constexpr int kAtomBytes = 1024;         // 8 rows of 128 bytes, swizzled
constexpr int kMnChunkBytes = kBKW * 128;  // an MN-major tile's 64-wide chunk
static_assert(kBKW == 64, "a step is one 128-byte swizzle row");

template <int T>
constexpr int kTileBytesW = T * kBKW * 2;
constexpr int kBNW = 64;        // a tile's width: the N of one wgmma
constexpr int kNJW = kBNW / 8;  // its 8-column groups: acc[kNJW][4]
// a stage: A's kWG x 64 rows x kBKW, then B's kNH 64-wide halves (kWG =
// kNH = 1, or 2 and 2 for apply's 128 x 128 tile)
template <int kNH, int kWG = 1>
constexpr int kStageBytesOf =
    kWG * kTileBytesW<kBM> + kNH * kTileBytesW<kBNW>;
constexpr int kStageBytesW = kStageBytesOf<1>;
constexpr int kRingBytesW = kStagesW * kStageBytesW;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// The ring's base: the first 1024-byte boundary of the shared window at or
// after p (the swizzle is a function of the address bits).
__device__ __forceinline__ unsigned char* align_atom(unsigned char* p) {
  return p + ((kAtomBytes - (smem_addr(p) & (kAtomBytes - 1))) &
              (kAtomBytes - 1));
}

// Byte offset of element (o, k) of a tile (T outer positions, kBKW deep)
// in the 128-byte swizzle: the 16-byte chunk index (address bits 4-6) is
// XORed with the row within its 8-row atom (bits 7-9). kKC (K-major): a row
// of 128 bytes an outer position. Else (MN-major): a row of 128 bytes a
// depth, 64 outer positions wide, the tile's 64-wide chunks kMnChunkBytes
// apart.
template <bool kKC>
__device__ __forceinline__ int swz(int o, int k) {
  if (kKC) return o * 128 + ((((k >> 3) ^ o) & 7) << 4) + (k & 7) * 2;
  return (o >> 6) * kMnChunkBytes + k * 128 +
         (((((o >> 3) & 7) ^ k) & 7) << 4) + (o & 7) * 2;
}

// wgmma's descriptor of a tile at shared address `at` (128-byte swizzle,
// layout type 1 in bits 62-63). K-major: SBO (bits 32-45) = 1024 bytes
// between 8-row atoms; LBO unused. MN-major: LBO (bits 16-29) = the bytes
// between 64-wide chunks of the outer axis, SBO = 1024 between 8-deep
// groups of K (the leading and stride offsets swap meaning with the major).
template <bool kKC>
__device__ __forceinline__ uint64_t w_desc(unsigned at) {
  const uint64_t lbo = kKC ? 1 : kMnChunkBytes >> 4;
  return ((at & 0x3ffff) >> 4) | (lbo << 16) |
         (static_cast<uint64_t>(kAtomBytes >> 4) << 32) | (1ull << 62);
}

// The descriptor's start for the 16-deep slice kk of a step.
template <bool kKC>
__device__ __forceinline__ unsigned slice_at(unsigned tile, int kk) {
  return tile + kk * (kKC ? 32 : 16 * 128);
}

__device__ __forceinline__ void st_shared16(unsigned at, const uint4& v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(at),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// 16 bytes from global to shared memory, of which the first `bytes` are
// read and the rest zero-filled.
__device__ __forceinline__ void cp_async16(unsigned at, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(at),
               "l"(src), "r"(bytes)
               : "memory");
}

// The unaligned path of a 16-byte piece, kept out of line (rare, and
// large when inlined): 8 elements `stride` apart, the first `live` read.
__device__ __noinline__ void copy_piece_slow(unsigned at, const uint16_t* p,
                                             long long stride, int live) {
  uint16_t e[8];
#pragma unroll
  for (int q = 0; q < 8; ++q)
    e[q] = q < live ? __ldg(p + q * stride) : static_cast<uint16_t>(0);
  st_shared16(at, pack8(e));
  fence_async_proxy();  // a generic write, read by wgmma
}

// One bf16 operand's tile copies, step after step along K: element (o, k)
// of the next step's tile is base[o*so + k*sk] for o < o_left and k <
// k_left, else 0. A thread copies 16-byte pieces of 8 elements along the
// contiguous axis (K where kKC, else the outer axis), neighbouring threads
// neighbouring pieces. vec: that axis has stride 1, the other a multiple of
// 8 and the array is 16-byte aligned; else the pieces are loaded element by
// element and stored by the thread. kThr: the block's threads.
template <int T, bool kKC, int kThr = kThreads>
struct TileCopyW {
  static constexpr int kPieces = T * kBKW / 8 / kThr;
  static_assert(kPieces * 8 * kThr == T * kBKW, "tile must split evenly");
  const uint16_t* base;
  const uint16_t* safe;  // a valid address for pieces that read nothing
  long long so, sk;
  int o_left, k_left;
  bool vec;

  __device__ __forceinline__ TileCopyW(const uint16_t* src, long long o0,
                                       long long o_lim, long long so_,
                                       long long k0, long long k_lim,
                                       long long sk_, bool vec_)
      : base(src + o0 * so_ + k0 * sk_), safe(src), so(so_), sk(sk_),
        o_left(static_cast<int>(min(max(o_lim - o0, 0LL), 1LL * T))),
        k_left(static_cast<int>(min(max(k_lim - k0, 0LL), 1LL << 30))),
        vec(vec_) {}

  // Starts the copies of the next step into the tile at shared address t.
  __device__ __forceinline__ void start(unsigned t) {
#pragma unroll
    for (int i = 0; i < kPieces; ++i) {
      const int u = threadIdx.x + i * kThr;
      const int o = kKC ? u / (kBKW / 8) : (u % (T / 8)) * 8;
      const int k = kKC ? (u % (kBKW / 8)) * 8 : u / (T / 8);
      const int along = kKC ? k_left - k : o_left - o;
      const bool across = kKC ? o < o_left : k < k_left;
      const int live = across ? min(max(along, 0), 8) : 0;
      const unsigned at = t + swz<kKC>(o, k);
      if (vec) {
        cp_async16(at, live ? base + (kKC ? o * so + k : o + k * sk) : safe,
                   2 * live);
      } else {
        copy_piece_slow(at, base + o * so + k * sk, kKC ? sk : so, live);
      }
    }
    base += kBKW * sk;
    k_left -= kBKW;
  }
};

// d = a b (scale_d = 0) or d += a b: one 64 x N x 16 bf16 product of the
// warpgroup, both operands from shared memory (kTA, kTB: A, B MN-major);
// asynchronous until wgmma_wait(). acc[j][2h + e] is Lane's layout.
template <int kTA, int kTB>
__device__ __forceinline__ void wgmma_bf16(float (&d)[8][4], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(scale_d), "n"(kTA), "n"(kTB));
}

// d = a b or d += a b as wgmma_bf16, A (64 x 16) from registers in the
// m16n8k16 fragment layout of each warp's 16 rows, B from shared memory
// (kTB: MN-major).
template <int kTB>
__device__ __forceinline__ void wgmma_bf16_rs(float (&d)[8][4],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(kTB));
}

// A's fragment for wgmma_bf16_rs from an MN-major tile in shared memory:
// the 16-deep slice kk of the warp's 16 rows, by one ldmatrix.x4.trans (lane
// L points at depth 16 kk + L % 8 + 8 (L / 16), rows 16 w + 8 ((L / 8) % 2)
// on), as four pairs of bf16 along K.
__device__ __forceinline__ void ldmatrix_a_mn(unsigned tile, int kk,
                                              uint32_t (&a)[4]) {
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int k = 16 * kk + lane % 8 + 8 * (lane / 16);
  const int m = 16 * w + 8 * ((lane / 8) % 2);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(tile + swz<false>(m, k)));
}

// A's fragment for wgmma_bf16_rs from a K-major tile in shared memory:
// the 16-deep slice kk of warp w's 16 rows (w counts the block's warps, so
// a block of two warpgroups reads a 128-row tile), by one ldmatrix.x4
// (lane L points at row 16 w + L % 8 + 8 ((L / 8) % 2), depth 16 kk + 8
// (L / 16)), as four pairs of bf16 along K: rows g and g + 8 at depths 2t,
// 2t + 1 (a[0], a[1]), then at 2t + 8, 2t + 9 (a[2], a[3]).
__device__ __forceinline__ void ldmatrix_a_k(unsigned tile, int kk,
                                             uint32_t (&a)[4]) {
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int m = 16 * w + lane % 8 + 8 * ((lane / 8) % 2);
  const int k = 16 * kk + 8 * (lane / 16);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(tile + swz<true>(m, k)));
}

// The K loop of the wgmma core. load(t) starts the copies of the next step
// into the stage at shared address t (once a step, in order). prep() runs
// once, behind the first copies and before the first barrier. kARegs: A is
// read into registers, a_frag(tile, s, kk, a) giving the fragment of step
// s's 16-deep slice kk (the prologue of apply's and dW's A runs there),
// and wgmma reads only B from shared memory; else both. kSlabs: each
// step's products are chained from zero and added to acc by the CUDA
// cores; else they accumulate in acc. kNH: B's tile is kNH 64-wide halves
// (acc's groups 8 h .. 8 h + 7 hold half h), each slice's products sharing
// A. kWG: the block is kWG warpgroups, warpgroup g the A rows 64 g .. 64 g
// + 63 (A from registers only), all sharing B. kStages: the ring's depth
// (copies run kStages - 1 steps ahead). cp.async data reaches wgmma
// through the wait and the barrier; only generic stores (TileCopyW's
// fallback) are fenced into the async proxy, by the thread that made them:
// a fence here would also wait for the copies in flight. On return every
// copy has landed, every product is done and the ring is free.
template <bool kAKC, bool kBKC, bool kSlabs, bool kARegs, int kNH = 1,
          int kStages = kStagesW, int kWG = 1, class Load, class Prep,
          class AFrag>
__device__ __forceinline__ void wgmma_mainloop(unsigned char* ring, int steps,
                                               float (&acc)[kNH * kNJW][4],
                                               Load load, Prep prep,
                                               AFrag a_frag) {
  static_assert(kWG == 1 || kARegs, "A from shared memory: one warpgroup");
  constexpr int kStage = kStageBytesOf<kNH, kWG>, kNJ = kNH * kNJW;
  const unsigned ring_at = smem_addr(ring);
#pragma unroll
  for (int j = 0; j < kNJ; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load(ring_at + s * kStage);
    cp_async_commit();  // one group a step, empty past the end
  }
  prep();
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<kStages - 2>();  // this thread's copies of step s landed
    // step s visible to all; step s - 1's products done (waited below):
    // its stage is free
    __syncthreads();
    const int ahead = s + kStages - 1;
    if (ahead < steps) load(ring_at + (ahead % kStages) * kStage);
    cp_async_commit();
    const unsigned a_at = ring_at + (s % kStages) * kStage;
    const unsigned b_at = a_at + kWG * kTileBytesW<kBM>;
    uint32_t a[kARegs ? kBKW / 16 : 1][4];
    if constexpr (kARegs) {
#pragma unroll
      for (int kk = 0; kk < kBKW / 16; ++kk) a_frag(a_at, s, kk, a[kk]);
    }
    // the step's 16-deep products into d, the first of each half with
    // scale_d = first (0: d = a b, chained from zero)
    const auto products = [&](float (&d)[kNJ][4], int first) {
      pin(d);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBKW / 16; ++kk)
#pragma unroll
        for (int h = 0; h < kNH; ++h) {
          const uint64_t db = w_desc<kBKC>(
              slice_at<kBKC>(b_at + h * kTileBytesW<kBNW>, kk));
          const int scale = kk > 0 ? 1 : first;
          float(&dh)[kNJW][4] =
              *reinterpret_cast<float(*)[kNJW][4]>(&d[h * kNJW]);
          if constexpr (kARegs)
            wgmma_bf16_rs<kBKC ? 0 : 1>(dh, a[kk], db, scale);
          else
            wgmma_bf16<kAKC ? 0 : 1, kBKC ? 0 : 1>(
                dh, w_desc<kAKC>(slice_at<kAKC>(a_at, kk)), db, scale);
        }
      wgmma_commit();
      wgmma_wait<0>();
      pin(d);
    };
    if constexpr (kSlabs) {
      float slab[kNJ][4];
      products(slab, 0);
#pragma unroll
      for (int j = 0; j < kNJ; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[j][q] += slab[j][q];
    } else {
      products(acc, 1);
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

// Starts the cp.async copies (in the caller's next group) of v[ch0 + i] (0
// past ch_lim) for i < count into dst; vec: v + ch0 is 16-byte aligned.
__device__ __forceinline__ void stage_vector_async(float* dst, const float* v,
                                                   int ch0, int ch_lim,
                                                   int count, bool vec) {
  const int width = vec ? 4 : 1;
  for (int i = threadIdx.x * width; i < count; i += kThreads * width) {
    const int left = ch_lim - (ch0 + i);
    const int live = left > 0 ? min(left, width) : 0;
    cp_async(dst + i, live ? v + ch0 + i : v, width, live);
  }
}

// Starts the copies of rows [r_lo, r_hi) of a block's 64 x kBN tile of bf16
// x (N, C) at row m0, channel n0 into x_tile (rows of kBN + 8 elements);
// rows past N and channels past C are zero-filled. vec: 16-byte cp.async
// (C a multiple of 8, x aligned); else element loads and a 16-byte store.
template <int kBN>
__device__ __forceinline__ void stage_x_tile_bf16(uint16_t* x_tile,
                                                  const uint16_t* x,
                                                  long long m0, int n0,
                                                  long long n, int c, int r_lo,
                                                  int r_hi, bool vec) {
  constexpr int kChunks = kBN / 8;
  for (int u = r_lo * kChunks + threadIdx.x; u < r_hi * kChunks;
       u += kThreads) {
    const int r = u / kChunks, col = (u % kChunks) * 8;
    const long long row = m0 + r;
    const int left = c - (n0 + col);
    const int live = row < n && left > 0 ? min(left, 8) : 0;
    const uint16_t* src = x + row * c + n0 + col;
    const unsigned at = smem_addr(x_tile + r * (kBN + 8) + col);
    if (vec) {
      cp_async16(at, live ? src : x, 2 * live);
    } else {
      copy_piece_slow(at, src, 1, live);
    }
  }
}

__device__ __forceinline__ float2 bf16x2_to_f32(uint32_t v) {
  return make_float2(bf16_bits_to_f32(static_cast<uint16_t>(v)),
                     bf16_bits_to_f32(static_cast<uint16_t>(v >> 16)));
}

struct DwArgs2 {
  const uint16_t *x, *g;
  const float *mul, *add;
  long long n;
  int c, f;
  long long rows_per_chunk;
  bool x_vec, g_vec, out_vec4;
  float* part;
};

// A dW block's shared memory: the ring, then mul and add of its channels.
constexpr int kDwSmemW = kAtomBytes + kRingBytesW + 2 * kBM * 4;

// bf16 partial dW of one 64 x 64 tile (channels c0.., outputs f0..) over
// the row chunks of one thread-block cluster: rank k contracts rows
// [(group*Q + k)*rows_per_chunk, +rows_per_chunk) (a multiple of kBKW; past
// N, nothing), a = bf16(relu(x*mul + add)) (A, m = channel, k = row: x
// read MN-major, made into a in the fragment's registers) against g (B, k
// = row, n = output, MN-major). The Q partials meet in shared memory: after
// a cluster barrier rank k sums all Q, in rank order, for its share of the
// tile's channels and writes part[group] (C, F). No atomics: the same bits
// run to run.
__device__ __forceinline__ void dw_block_bf16(const DwArgs2& p, int c0, int f0,
                                              int group,
                                              unsigned char* smem) {
  constexpr int kPLd = kBNW + 8;  // the partial's rows, fp32
  static_assert(kBM * kPLd * 4 <= kRingBytesW, "the partial in the ring");
  unsigned char* ring = align_atom(smem);
  float* smul = reinterpret_cast<float*>(ring + kRingBytesW);
  float* sadd = smul + kBM;
  const cg::cluster_group cluster = cg::this_cluster();
  const int q_blocks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const Lane ln;
  const long long r0 =
      static_cast<long long>(group * q_blocks + rank) * p.rows_per_chunk;
  const long long r1 = min(p.n, r0 + p.rows_per_chunk);
  TileCopyW<kBM, false> a_copy(p.x, c0, p.c, 1, r0, r1, p.c, p.x_vec);
  TileCopyW<kBNW, false> b_copy(p.g, f0, p.f, 1, r0, r1, p.f, p.g_vec);
  float acc[kNJW][4];
  wgmma_mainloop<false, false, true, true>(
      ring, static_cast<int>(max(0LL, (r1 - r0 + kBKW - 1) / kBKW)), acc,
      [&](unsigned t) {
        a_copy.start(t);
        b_copy.start(t + kTileBytesW<kBM>);
      },
      [&] {
        stage_vector(smul, p.mul, c0, p.c, kBM);
        stage_vector(sadd, p.add, c0, p.c, kBM);
      },
      [&](unsigned a_tile, int, int kk, uint32_t (&a)[4]) {
        // a = bf16(relu(x*mul + add)) in the fragment's registers: pairs
        // along K of channel 16 w + g (a[0], a[2]) and 16 w + g + 8 (a[1],
        // a[3]). Rows past the chunk become relu(add), against g rows that
        // are 0; channels past C are 0 (mul = add = 0 there).
        ldmatrix_a_mn(a_tile, kk, a);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int ch = 16 * ln.w + ln.g + 8 * (q & 1);
          const float2 v = bf16x2_to_f32(a[q]);
          a[q] = pack_bf16x2(fmaxf(bn_z(v.x, smul[ch], sadd[ch]), 0.f),
                             fmaxf(bn_z(v.y, smul[ch], sadd[ch]), 0.f));
        }
      });
  if (q_blocks == 1) {  // one chunk a partial: no fold
    store_acc<kBNW / 32>(p.part + static_cast<long long>(group) * p.c * p.f, p.f, c0,
                  p.c, f0, p.f, acc, ln, p.out_vec4);
    return;
  }
  float* pk = reinterpret_cast<float*>(ring);  // the ring is free now
#pragma unroll
  for (int j = 0; j < kNJW; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(pk + (16 * ln.w + ln.g + 8 * h) * kPLd +
                                 8 * j + 2 * ln.t) =
          make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
  cluster.sync();  // every partial written and visible to the cluster
  constexpr int kQuads = kBNW / 4;
  const int share = kBM / q_blocks;  // Q divides 64
  float* dst = p.part + static_cast<long long>(group) * p.c * p.f;
  for (int u = threadIdx.x; u < share * kQuads; u += kThreads) {
    const int r = rank * share + u / kQuads, col = (u % kQuads) * 4;
    const int ch = c0 + r, fo = f0 + col;
    const float* mine = pk + r * kPLd + col;
    float4 sum = *reinterpret_cast<const float4*>(
        cluster.map_shared_rank(mine, 0));
    for (int k = 1; k < q_blocks; ++k) {  // rank order
      const float4 v = *reinterpret_cast<const float4*>(
          cluster.map_shared_rank(mine, k));
      sum.x += v.x, sum.y += v.y, sum.z += v.z, sum.w += v.w;
    }
    if (ch >= p.c || fo >= p.f) continue;
    float* at = dst + static_cast<long long>(ch) * p.f + fo;
    if (p.out_vec4 && fo + 4 <= p.f) {
      *reinterpret_cast<float4*>(at) = sum;
    } else {
      const float v[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (fo + e < p.f) at[e] = v[e];
    }
  }
  cluster.sync();  // no block leaves while a peer may still read its partial
}

// The bf16 da = g W^T product and its epilogues: bwd_reduce's dbeta/dgamma
// partials (da_block_bf16) and bwd_dx (bwd_dx_bf16_kernel, and split over
// F, bwd_dx_cluster_bf16_kernel).
struct DaArgs2 {
  const uint16_t *g, *w;
  long long w_sc, w_sf;
  const uint16_t* x;
  const float *mul, *add, *mean, *rstd, *c1, *c2;
  long long n;
  int c, f, k_per_chunk;
  bool g_vec, w_vec, x_vec, v_vec, dx_vec;
  uint16_t* dx;
  float* part;
};

// A da block's shared memory: the ring, its tile of x (rows of 72 bf16:
// fragment reads by row = lane / 4 then hit every bank) and the six
// per-channel vectors (64 floats each).
struct DaSmemW {
  static constexpr int kXLd = kBNW + 8;
  static constexpr int kBytes =
      kAtomBytes + kRingBytesW + kBM * kXLd * 2 + 6 * kBNW * 4;
  unsigned char* ring;
  uint16_t* x_tile;
  float* vecs;
  __device__ __forceinline__ explicit DaSmemW(unsigned char* smem)
      : ring(align_atom(smem)),
        x_tile(reinterpret_cast<uint16_t*>(ring + kRingBytesW)),
        vecs(reinterpret_cast<float*>(x_tile + kBM * kXLd)) {}
};

// The da product of the 64 x 64 tile at row m0, channel n0 over F chunk
// kz into acc. Behind the first copies it starts the copies of what the
// epilogue reads: rows [r_lo, r_hi) of the tile of x and the tile's slices
// of the first kVecs of (mul, add, mean, rstd, c1, c2).
template <int kVecs, bool kWKC>
__device__ __forceinline__ void da_product_bf16(const DaArgs2& p,
                                                const DaSmemW& s,
                                                long long m0, int n0, int kz,
                                                int r_lo, int r_hi,
                                                float (&acc)[kNJW][4]) {
  constexpr int kBN = kBNW;
  // A(m = row, k = f) = g[row, f], K-major; B(k = f, n = channel) =
  // W[channel, f], K-major where W's F axis is the contiguous one
  const int k_beg = kz * p.k_per_chunk;
  const int k_end = min(p.f, k_beg + p.k_per_chunk);
  TileCopyW<kBM, true> a_copy(p.g, m0, p.n, p.f, k_beg, k_end, 1, p.g_vec);
  TileCopyW<kBN, kWKC> b_copy(p.w, n0, p.c, p.w_sc, k_beg, k_end, p.w_sf,
                              p.w_vec);
  wgmma_mainloop<true, kWKC, false, false>(
      s.ring, (k_end - k_beg + kBKW - 1) / kBKW, acc,
      [&](unsigned t) {
        a_copy.start(t);
        b_copy.start(t + kTileBytesW<kBM>);
      },
      [&] {
        stage_x_tile_bf16<kBN>(s.x_tile, p.x, m0, n0, p.n, p.c, r_lo, r_hi,
                               p.x_vec);
        const float* src[6] = {p.mul, p.add, p.mean, p.rstd, p.c1, p.c2};
#pragma unroll
        for (int v = 0; v < kVecs; ++v)
          stage_vector_async(s.vecs + v * kBN, src[v], n0, p.c, kBN,
                             p.v_vec);
      },
      [](unsigned, int, int, uint32_t (&)[4]) {});
}

// bwd_reduce's da block: the dbeta/dgamma partials of its 64 rows over F
// chunk b.z, part[b.z*(row tiles) + b.x] (2C), as da_block does in fp32.
template <bool kWKC>
__device__ __forceinline__ void da_block_bf16(const DaArgs2& p, const Block& b,
                                              unsigned char* smem) {
  constexpr int kBN = kBNW, kXLd = DaSmemW::kXLd;
  const DaSmemW s(smem);
  const float* vecs = s.vecs;
  const Lane ln;
  const int c = p.c;
  const long long m0 = static_cast<long long>(b.x) * kBM;
  const int n0 = b.y * kBN;
  float acc[kNJW][4];
  da_product_bf16<4, kWKC>(p, s, m0, n0, b.z, 0, kBM, acc);
  float s_db[kNJW][2], s_dg[kNJW][2];
  const auto pair = [](const float* q) {
    return *reinterpret_cast<const float2*>(q);
  };
#pragma unroll
  for (int j = 0; j < kNJW; ++j) {
    // two neighbouring channels a thread; channels past C hold zeros
    // (vectors and x alike) and are not stored
    const int col = 8 * j + 2 * ln.t;
    const float2 mu = pair(vecs + col), ad = pair(vecs + kBN + col);
    const float2 me = pair(vecs + 2 * kBN + col);
    const float2 rs = pair(vecs + 3 * kBN + col);
    s_db[j][0] = s_db[j][1] = s_dg[j][0] = s_dg[j][1] = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // rows past N add 0: their da is 0 (g is zero-filled)
      const int r = 16 * ln.w + ln.g + 8 * h;
      const float2 xv = bf16x2_to_f32(
          *reinterpret_cast<const uint32_t*>(s.x_tile + r * kXLd + col));
      const float dz0 = bn_z(xv.x, mu.x, ad.x) > 0.f ? acc[j][2 * h] : 0.f;
      const float dz1 =
          bn_z(xv.y, mu.y, ad.y) > 0.f ? acc[j][2 * h + 1] : 0.f;
      s_db[j][0] += dz0;
      s_db[j][1] += dz1;
      s_dg[j][0] += dz0 * ((xv.x - me.x) * rs.x);
      s_dg[j][1] += dz1 * ((xv.y - me.y) * rs.y);
    }
  }
  // column sums over the block's 64 rows in a fixed order, as da_block
  constexpr int kWarps = kThreads / 32;
  float* red = reinterpret_cast<float*>(s.ring);  // [2][kWarps][kBN]
#pragma unroll
  for (int j = 0; j < kNJW; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float db = s_db[j][e], dg = s_dg[j][e];
#pragma unroll
      for (int mask = 4; mask < 32; mask <<= 1) {
        db += __shfl_xor_sync(0xffffffffu, db, mask);
        dg += __shfl_xor_sync(0xffffffffu, dg, mask);
      }
      if (ln.g == 0) {
        const int col = 8 * j + 2 * ln.t + e;
        red[ln.w * kBN + col] = db;
        red[(kWarps + ln.w) * kBN + col] = dg;
      }
    }
  __syncthreads();
  if (threadIdx.x < kBN) {
    const int col = threadIdx.x, ch = n0 + col;
    if (ch < c) {
      float db = 0.f, dg = 0.f;
      for (int r = 0; r < kWarps; ++r) {
        db += red[r * kBN + col];
        dg += red[(kWarps + r) * kBN + col];
      }
      float* dst = p.part + (static_cast<long long>(b.z) * b.nx + b.x) * 2 * c;
      dst[ch] = db;
      dst[c + ch] = dg;
    }
  }
}

// Stores 8 bf16 of a row of dx from channel ch on: one 16-byte store where
// `vec` and all 8 channels are below C, else the live ones one by one.
__device__ __forceinline__ void store_dx8(uint16_t* dst, const uint4& v,
                                          int ch, int c, bool vec) {
  if (vec && ch + 8 <= c) {
    *reinterpret_cast<uint4*>(dst) = v;
  } else {
    uint16_t e[8];
    unpack8(v, e);
#pragma unroll
    for (int q = 0; q < 8; ++q)
      if (ch + q < c) dst[q] = e[q];
  }
}

// bf16 bwd_dx, F unsplit: the da product with the BN backward as its
// epilogue; grid (ceil(N/64), ceil(C/64)). dx is written over the x tile,
// then leaves as 16-byte stores, whole rows. Four blocks a SM (44 KB of
// shared memory, at most 128 registers each).
constexpr int kDxMinBlocks = 4;

template <bool kWKC>
__global__ void __launch_bounds__(kThreads, kDxMinBlocks)
bwd_dx_bf16_kernel(const DaArgs2 p) {
  constexpr int kBN = kBNW, kXLd = DaSmemW::kXLd;
  extern __shared__ float4 smem4[];
  const DaSmemW s(reinterpret_cast<unsigned char*>(smem4));
  const float* vecs = s.vecs;
  const Lane ln;
  const long long m0 = static_cast<long long>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * kBN, c = p.c;
  float acc[kNJW][4];
  da_product_bf16<6, kWKC>(p, s, m0, n0, 0, 0, kBM, acc);
  const auto pair = [](const float* q) {
    return *reinterpret_cast<const float2*>(q);
  };
#pragma unroll
  for (int j = 0; j < kNJW; ++j) {
    const int col = 8 * j + 2 * ln.t;
    float2 v[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) v[k] = pair(vecs + k * kBN + col);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * ln.w + ln.g + 8 * h;
      uint32_t* at = reinterpret_cast<uint32_t*>(s.x_tile + r * kXLd + col);
      const float2 xv = bf16x2_to_f32(*at);
      *at = pack_bf16x2(
          dx_of(xv.x, acc[j][2 * h], v[0].x, v[1].x, v[2].x, v[3].x, v[4].x,
                v[5].x),
          dx_of(xv.y, acc[j][2 * h + 1], v[0].y, v[1].y, v[2].y, v[3].y,
                v[4].y, v[5].y));
    }
  }
  __syncthreads();
  constexpr int kChunks = kBN / 8;
  for (int u = threadIdx.x; u < kBM * kChunks; u += kThreads) {
    const int r = u / kChunks, col = (u % kChunks) * 8;
    const long long row = m0 + r;
    if (row >= p.n || n0 + col >= c) continue;
    store_dx8(p.dx + row * c + n0 + col,
              *reinterpret_cast<const uint4*>(s.x_tile + r * kXLd + col),
              n0 + col, c, p.dx_vec);
  }
}

// bf16 bwd_dx with F split across a thread-block cluster, as
// bwd_dx_cluster_kernel: grid (ceil(N/64), ceil(C/64), chunks), cluster (1,
// 1, chunks), 2 <= chunks <= kMaxCluster. Block k of a cluster contracts F
// chunk k and leaves P_k (fp32) in its own shared memory; after a cluster
// barrier rank r sums P_0 + P_1 + ... in that order for its share of the
// tile's live rows, reading its peers' shared memory, applies the mask and
// the BN backward, and stores 8 channels of dx a thread in one 16-byte
// store. No scratch in device memory, no atomics: the same bits run to run.
template <bool kWKC>
__global__ void __launch_bounds__(kThreads, kDxMinBlocks)
bwd_dx_cluster_bf16_kernel(const DaArgs2 p) {
  constexpr int kBN = kBNW, kXLd = DaSmemW::kXLd;
  constexpr int kPLd = kBN + 8;  // P_k's rows, fp32
  static_assert(kBM * kPLd * 4 <= kRingBytesW, "P_k in the ring");
  extern __shared__ float4 smem4[];
  const DaSmemW s(reinterpret_cast<unsigned char*>(smem4));
  float* part = reinterpret_cast<float*>(s.ring);  // once the ring is free
  const cg::cluster_group cluster = cg::this_cluster();
  const int chunks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const Lane ln;
  const long long n = p.n, m0 = static_cast<long long>(blockIdx.x) * kBM;
  const int c = p.c, n0 = blockIdx.y * kBN;
  // this rank's rows of the tile: an even share of the live ones
  const int live = static_cast<int>(min(1LL * kBM, n - m0));
  const int share = (live + chunks - 1) / chunks;
  const int r_lo = min(live, rank * share), r_hi = min(live, r_lo + share);
  float acc[kNJW][4];
  da_product_bf16<6, kWKC>(p, s, m0, n0, rank, r_lo, r_hi, acc);
#pragma unroll
  for (int j = 0; j < kNJW; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * ln.w + ln.g + 8 * h, col = 8 * j + 2 * ln.t;
      *reinterpret_cast<float2*>(part + r * kPLd + col) =
          make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
    }
  cluster.sync();  // every P_k written and visible to the whole cluster

  const float* peer[kMaxCluster];
#pragma unroll
  for (int k = 0; k < kMaxCluster; ++k)
    peer[k] = cluster.map_shared_rank(part, k < chunks ? k : 0);
  const auto quad = [](const float* q) {
    return *reinterpret_cast<const float4*>(q);
  };
  constexpr int kOcts = kBN / 8;
  for (int u = threadIdx.x; u < (r_hi - r_lo) * kOcts; u += kThreads) {
    const int r = r_lo + u / kOcts, col = (u % kOcts) * 8;
    float da[8];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int at = r * kPLd + col + 4 * half;
      float4 q[kMaxCluster];  // all loads in flight before the sum
#pragma unroll
      for (int k = 0; k < kMaxCluster; ++k)
        if (k < chunks) q[k] = quad(peer[k] + at);
      float4 sum = q[0];
#pragma unroll
      for (int k = 1; k < kMaxCluster; ++k)
        if (k < chunks) sum.x += q[k].x, sum.y += q[k].y, sum.z += q[k].z,
                        sum.w += q[k].w;
      da[4 * half] = sum.x, da[4 * half + 1] = sum.y;
      da[4 * half + 2] = sum.z, da[4 * half + 3] = sum.w;
    }
    uint16_t xe[8], out[8];
    unpack8(*reinterpret_cast<const uint4*>(s.x_tile + r * kXLd + col), xe);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float* v = s.vecs + col + e;
      out[e] = f32_to_bf16_bits(dx_of(bf16_bits_to_f32(xe[e]), da[e], v[0],
                                      v[kBN], v[2 * kBN], v[3 * kBN],
                                      v[4 * kBN], v[5 * kBN]));
    }
    store_dx8(p.dx + (m0 + r) * c + n0 + col, pack8(out), n0 + col, c,
              p.dx_vec);
  }
  cluster.sync();  // no block leaves while a peer may still read its P_k
}

// bf16 bwd_reduce's two products in one launch, as bwd_reduce_kernel, both
// in 64 x 64 tiles, launched in thread-block clusters of Q blocks along the
// 1-D grid: blocks [0, dw_grid.n) are dW's (Q row chunks a cluster,
// clusters tile-fastest), the rest da's, padded to a whole cluster (the
// padding returns at once; a da cluster never meets at a barrier). Four
// blocks a SM (~122 registers; 64 x 128 dW tiles took 255 and spilled).
constexpr int kReduceSmemW =
    kDwSmemW > DaSmemW::kBytes ? kDwSmemW : DaSmemW::kBytes;

template <bool kWKC>
__global__ void __launch_bounds__(kThreads, 4)
bwd_reduce_bf16_kernel(const DwArgs2 dw, const DaArgs2 da, const Grid dw_grid,
                       const Grid da_grid) {
  extern __shared__ float4 smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
  int id = blockIdx.x;
  if (id < dw_grid.n) {
    const int cl = id / static_cast<int>(cg::this_cluster().num_blocks());
    const int tile = cl % (dw_grid.x * dw_grid.y);
    dw_block_bf16(dw, tile % dw_grid.x * kBM, tile / dw_grid.x * 64,
                  cl / (dw_grid.x * dw_grid.y), smem);
  } else if ((id -= dw_grid.n) < da_grid.n) {
    da_block_bf16<kWKC>(da, Block{id % da_grid.x, id / da_grid.x % da_grid.y,
                                  id / (da_grid.x * da_grid.y), da_grid.x},
                        smem);
  }
}

// The core alone, for its tests: out (64, 64) fp32 = A B^T over k, A and B
// (64, k) bf16, each given K-major (a[m*k + kk]) or MN-major (a[kk*64 + m])
// as kAKC / kBKC say. kARegs: A reaches wgmma from registers by the
// fragment loads the prologues use (ldmatrix_a_k, ldmatrix_a_mn), else
// through its descriptor.
template <bool kAKC, bool kBKC, bool kARegs>
__global__ void __launch_bounds__(kThreads)
wgmma_bf16_tile_kernel(const uint16_t* a, const uint16_t* b, int k, bool a_vec,
                       bool b_vec, float* out) {
  constexpr int kBN = kBNW;
  extern __shared__ float4 smem4[];
  unsigned char* ring = align_atom(reinterpret_cast<unsigned char*>(smem4));
  const Lane ln;
  TileCopyW<kBM, kAKC> a_copy(a, 0, kBM, kAKC ? k : 1, 0, k, kAKC ? 1 : kBM,
                              a_vec);
  TileCopyW<kBN, kBKC> b_copy(b, 0, kBN, kBKC ? k : 1, 0, k, kBKC ? 1 : kBN,
                              b_vec);
  float acc[kNJW][4];
  wgmma_mainloop<kAKC, kBKC, false, kARegs>(
      ring, (k + kBKW - 1) / kBKW, acc,
      [&](unsigned t) {
        a_copy.start(t);
        b_copy.start(t + kTileBytesW<kBM>);
      },
      [] {},
      [](unsigned a_tile, int, int kk, uint32_t (&a)[4]) {
        if constexpr (kAKC)
          ldmatrix_a_k(a_tile, kk, a);
        else
          ldmatrix_a_mn(a_tile, kk, a);
      });
  store_acc<kBNW / 32>(out, kBN, 0, kBM, 0, kBN, acc, ln, true);
}

// bf16 apply (see the notes above kBKW): out (N, F) = bf16(a @ W), a =
// bf16(relu(x*mul + add)) made in the A fragment's registers. Grid
// (ceil(N/64), ceil(F/(64 kNH)), chunks); with chunks > 1 a thread-block
// cluster (1, 1, chunks): rank k contracts channels [k*k_per_chunk,
// +k_per_chunk) (whole steps), and the ranks fold their partials in rank
// order. kWKC: W's channel axis is the contiguous one (the conv kernel's
// layout: B K-major); else its F axis (B MN-major).
struct ApplyArgs2 {
  const uint16_t *x, *w;
  const float *mul, *add;
  long long w_sc, w_sf, n;
  int c, f, k_per_chunk;
  bool x_vec, w_vec, v_vec, out_vec;
  uint16_t* out;
};

// A 64 x 64 block (the only tile whose channels the plan splits) keeps a
// ring of 2 steps: 3 or 4 cost it blocks a SM and ran no faster at any
// stage on an H100 (ops/bf16_fwd_sweep.py); the wide tiles (one block a SM
// by their registers) keep 4,
// all of a chunk's copies in flight at once at every wide stage of the
// train step. Shared memory: the ring, each stage's mul and add (kBKW
// each), and where the channels split, the inbox of the fold (a slot of
// the owner's rows for each rank: chunks * share <= kBM + chunks - 1 rows)
// and its transaction barrier.
template <int kWG, int kNH>
constexpr bool kApplySplits = kWG == 1 && kNH == 1;
template <int kWG, int kNH>
constexpr int kApplyStages = kApplySplits<kWG, kNH> ? 2 : 4;
constexpr int kInboxFloats = (kBM + kMaxCluster) * (kBNW + 8);
template <int kWG, int kNH>
constexpr int kApplySmemW =
    kAtomBytes +
    kApplyStages<kWG, kNH> * (kStageBytesOf<kNH, kWG> + 2 * kBKW * 4) +
    (kApplySplits<kWG, kNH> ? kInboxFloats * 4 + 16 : 0);

// The cluster barrier in halves: a block arrives as it starts and waits
// before its first copy into a peer's shared memory (the peer must have
// started and set up its barrier; the wait costs nothing by then).
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// A transaction barrier (mbarrier) in shared memory at `bar`, for the bulk
// copies that peers of the cluster send into this block.
__device__ __forceinline__ void mbar_init(unsigned bar) {
  asm volatile(
      "mbarrier.init.shared::cta.b64 [%0], 1;\n"
      "fence.mbarrier_init.release.cluster;\n" ::"r"(bar)
      : "memory");
}
// This block's arrival, expecting `bytes` of copies before the phase ends.
__device__ __forceinline__ void mbar_expect(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned bar) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], 0;\n"
      "@!done bra WAIT;\n}\n" ::"r"(bar)
      : "memory");
}
// Address `at` of this block's shared memory in block `rank`'s.
__device__ __forceinline__ unsigned peer_addr(unsigned at, int rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(at), "r"(rank));
  return out;
}
// `bytes` (a multiple of 16) from this block's shared memory at `src` to
// `dst` in a peer's, completing on the peer's barrier `bar`.
__device__ __forceinline__ void bulk_copy_to_peer(unsigned dst, unsigned src,
                                                  unsigned bytes,
                                                  unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "r"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// kWG warpgroups (64 kWG rows) by kNH 64-wide halves: 64 x 64 (1, 1) or
// 128 x 128 (2, 2); only 64 x 64 blocks take chunks > 1.
// 64 x 64 blocks: three a SM (four left 128 registers, and the fold
// spilled), as many as the plan's largest grid (256 blocks) needs.
template <int kWG, int kNH, bool kWKC>
__global__ void __launch_bounds__(kWG * kThreads,
                                  kApplySplits<kWG, kNH> ? 3 : 1)
apply_bf16_kernel(const ApplyArgs2 p) {
  constexpr bool kSplit = kApplySplits<kWG, kNH>;
  constexpr int kStages = kApplyStages<kWG, kNH>;
  constexpr int kRows = kWG * kBM, kThr = kWG * kThreads;
  constexpr int kBN = kNH * kBNW, kPLd = kBN + 8;  // partials' rows, fp32
  constexpr int kStage = kStageBytesOf<kNH, kWG>;
  static_assert(kRows * kPLd * 4 <= kStages * kStage, "P in the ring");
  extern __shared__ float4 smem4[];
  unsigned char* ring = align_atom(reinterpret_cast<unsigned char*>(smem4));
  float* svec = reinterpret_cast<float*>(ring + kStages * kStage);
  float* const part = reinterpret_cast<float*>(ring);  // after the mainloop
  float* const inbox = svec + kStages * 2 * kBKW;  // where kSplit
  const unsigned bar = smem_addr(inbox + kInboxFloats);
  const cg::cluster_group cluster = cg::this_cluster();
  const int chunks = kSplit ? static_cast<int>(cluster.num_blocks()) : 1;
  const int rank = kSplit ? static_cast<int>(cluster.block_rank()) : 0;
  if (chunks > 1) {
    if (threadIdx.x == 0) mbar_init(bar);
    cluster_arrive_relaxed();
  }
  const Lane ln;  // warp ln.w of the block: rows 16 ln.w ..
  const long long m0 = static_cast<long long>(blockIdx.x) * kRows;
  const int n0 = blockIdx.y * kBN;
  const int k_beg = rank * p.k_per_chunk;
  const int k_end = min(p.c, k_beg + p.k_per_chunk);
  // A(m = row, k = channel) = x, K-major; B(k = channel, n = output) = W
  TileCopyW<kRows, true, kThr> a_copy(p.x, m0, p.n, p.c, k_beg, k_end, 1,
                                      p.x_vec);
  TileCopyW<kBN, kWKC, kThr> b_copy(p.w, n0, p.f, p.w_sf, k_beg, k_end,
                                    p.w_sc, p.w_vec);
  int staged = 0;  // steps whose copies have started
  float acc[kNH * kNJW][4];
  wgmma_mainloop<true, kWKC, false, true, kNH, kStages, kWG>(
      ring, (k_end - k_beg + kBKW - 1) / kBKW, acc,
      [&](unsigned t) {
        a_copy.start(t);
        b_copy.start(t + kWG * kTileBytesW<kBM>);
        float* v = svec + (staged % kStages) * 2 * kBKW;
        const int ch0 = k_beg + staged * kBKW;
        stage_vector_async(v, p.mul, ch0, k_end, kBKW, p.v_vec);
        stage_vector_async(v + kBKW, p.add, ch0, k_end, kBKW, p.v_vec);
        ++staged;
      },
      [] {},
      [&](unsigned a_tile, int s, int kk, uint32_t (&a)[4]) {
        // a[q] holds rows 16 w + g (q even) and + 8 (q odd) at depths
        // 16 kk + 2t + 8 (q / 2) and + 1 of step s
        ldmatrix_a_k(a_tile, kk, a);
        const float* v = svec + (s % kStages) * 2 * kBKW;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int k = 16 * kk + 2 * ln.t + 8 * (q / 2);
          const float2 x2 = bf16x2_to_f32(a[q]);
          const float2 mu = *reinterpret_cast<const float2*>(v + k);
          const float2 ad = *reinterpret_cast<const float2*>(v + kBKW + k);
          a[q] = pack_bf16x2(fmaxf(bn_z(x2.x, mu.x, ad.x), 0.f),
                             fmaxf(bn_z(x2.y, mu.y, ad.y), 0.f));
        }
      });

  // The fold. Each rank leaves its partial P in its own ring, and rank r
  // owns rows [r*share, (r+1)*share) of the tile's live rows: every other
  // rank sends it those rows of its P by one bulk copy into slot [rank]
  // of r's inbox (a peer's inbox is in use only for the fold, so no barrier
  // comes first), completing on r's transaction barrier; r waits on it,
  // sums P_0, P_1, ... in rank order, rounds once to bf16 and stores
  // 16-byte rows. No thread writes another block's shared memory itself:
  // on an H100 those small stores, and the cluster barrier behind them,
  // were slower.
#pragma unroll
  for (int j = 0; j < kNH * kNJW; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(
          part + (16 * ln.w + ln.g + 8 * h) * kPLd + 8 * j + 2 * ln.t) =
          make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
  const int live = static_cast<int>(min(1LL * kRows, p.n - m0));
  const int share = (live + chunks - 1) / chunks;
  const int r_lo = min(live, rank * share), r_hi = min(live, r_lo + share);
  if (chunks > 1) {
    fence_async_proxy();  // P's writes visible to the bulk copies
    cluster_wait();       // every peer's inbox barrier is set up
    __syncthreads();      // P written and fenced by every thread
    if (threadIdx.x == 0) {
      constexpr unsigned kRowBytes = kPLd * 4;
      mbar_expect(bar, (chunks - 1) * (r_hi - r_lo) * kRowBytes);
      const unsigned slot = smem_addr(inbox + rank * share * kPLd);
      for (int k = 0; k < chunks; ++k) {
        const int lo = min(live, k * share), hi = min(live, lo + share);
        if (k != rank && hi > lo)
          bulk_copy_to_peer(peer_addr(slot, k), smem_addr(part + lo * kPLd),
                            (hi - lo) * kRowBytes, peer_addr(bar, k));
      }
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
    mbar_wait(bar);  // every peer's rows have landed
  } else {
    __syncthreads();
  }
  constexpr int kOcts = kBN / 8;
  for (int u = threadIdx.x; u < (r_hi - r_lo) * kOcts; u += kThr) {
    const int rr = u / kOcts, col = (u % kOcts) * 8;
    if (n0 + col >= p.f) continue;
    uint32_t o[4];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int at = col + 4 * half;
      const auto slot = [&](int k) {  // P_k's row
        return *reinterpret_cast<const float4*>(
            (k == rank ? part + (r_lo + rr) * kPLd
                       : inbox + (k * share + rr) * kPLd) + at);
      };
      float4 sum = slot(0);
      for (int k = 1; k < chunks; ++k) {  // rank order
        const float4 v = slot(k);
        sum.x += v.x, sum.y += v.y, sum.z += v.z, sum.w += v.w;
      }
      o[2 * half] = pack_bf16x2(sum.x, sum.y);
      o[2 * half + 1] = pack_bf16x2(sum.z, sum.w);
    }
    store_dx8(p.out + (m0 + r_lo + rr) * p.f + n0 + col,
              make_uint4(o[0], o[1], o[2], o[3]), n0 + col, p.f, p.out_vec);
  }
  // P stays in place until the bulk copies have read it
  if (chunks > 1 && threadIdx.x == 0)
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// ---------------------------------------------------------- bf16 moments
//
// Per-channel sum x and sum x^2 (fp32) over bf16 x (N, C), one launch. A
// block of kMomThreads2 threads sums one chunk of rows of one 32-channel
// slab: a thread reads 16 bytes, 8 channels of a row (4 threads a row, 64
// bytes, neighbouring threads on neighbouring addresses), kUnroll rows
// (64 apart) all in flight, into 8 sums and 8 sums of squares in fp32
// registers. A chunk is 64 kUnroll rows, 256, 512 or 1,024, as the launch
// plan picks them (fused_dense.py: moments_rows_bf16; ops/bf16_fwd_sweep.py
// times the three).
// Where a slab has one chunk (256 and 32 rows) the block writes the
// output. Else each block writes its partial, and the last block of the
// slab to finish (it finds itself last by the slab's counter, which it
// leaves at 0 for the next launch) folds the slab's partials: one launch,
// no second kernel. The counter's add is a release-acquire at GPU scope
// behind the block's barrier, as CUTLASS's semaphores are: faster on an
// H100 than a __threadfence on both sides. The row chunks of a slab are not
// a thread-block cluster: folded in distributed shared memory (two cluster
// barriers a block) they were slower at the 16,384-row stage on an H100.
// The order of every sum is fixed by N and C alone: within a thread its
// rows ascending; the 8 row lanes of a warp by a butterfly (xor 1, 2, 4 of
// the row lane); the 8 warps in order; the chunks k of a slab in 4 lanes
// (lane l: k = l, l + 4, ... ascending), then the 4 lanes in order. So
// repeats are bit-equal; no value is ever added by an atomic. Where C is
// not a multiple of 8 or x is not 16-byte aligned the pieces are loaded
// element by element, out of line.
constexpr int kMomThreads2 = 256;
constexpr int kMomGroups2 = 4;  // 8-channel groups of a slab
constexpr int kMomSlab2 = 8 * kMomGroups2;
constexpr int kMomLanes2 = kMomThreads2 / kMomGroups2;  // row lanes: 64
constexpr int kMomFoldLanes2 = kMomThreads2 / (2 * kMomSlab2);  // 4

#if defined(MSP_FUSED_FWD) && defined(MSP_FUSED_BF16)
// 8 elements from p, the first `live` read and the rest 0, as a piece.
__device__ __noinline__ uint4 load_piece_slow(const uint16_t* p, int live) {
  uint16_t e[8];
#pragma unroll
  for (int q = 0; q < 8; ++q)
    e[q] = q < live ? __ldg(p + q) : static_cast<uint16_t>(0);
  return pack8(e);
}

// Grid (chunks, ceil(C/32)). out: sums, then sums of squares (2C). With
// chunks > 1, part[chunk][2C] holds the blocks' partials and done[slab]
// is 0 on entry and on exit.
template <int kUnroll>
__global__ void __launch_bounds__(kMomThreads2)
moments_bf16_kernel(const uint16_t* __restrict__ x, long long n, int c,
                    bool vec, float* __restrict__ part,
                    unsigned* __restrict__ done, float* __restrict__ out) {
  const int group = threadIdx.x % kMomGroups2;
  const int lane_row = threadIdx.x / kMomGroups2;
  const int ch = blockIdx.y * kMomSlab2 + 8 * group;
  const long long r0 =
      static_cast<long long>(blockIdx.x) * kMomLanes2 * kUnroll;
  float s[8], q[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) s[e] = q[e] = 0.f;
  if (ch < c) {
    uint4 v[kUnroll];
    const uint16_t* p = x + (r0 + lane_row) * c + ch;
    const long long step = static_cast<long long>(kMomLanes2) * c;
    if (vec) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        v[u] = r0 + lane_row + u * kMomLanes2 < n
                   ? __ldg(reinterpret_cast<const uint4*>(p + u * step))
                   : make_uint4(0, 0, 0, 0);
    } else {
      const int live = min(8, c - ch);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        v[u] = r0 + lane_row + u * kMomLanes2 < n
                   ? load_piece_slow(p + u * step, live)
                   : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      uint16_t e8[8];
      unpack8(v[u], e8);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float f = bf16_bits_to_f32(e8[e]);
        s[e] += f;
        q[e] = fmaf(f, f, q[e]);
      }
    }
  }
  // the warp's 8 row lanes (lane bits 2-4) by butterfly
#pragma unroll
  for (int mask = kMomGroups2; mask < 32; mask <<= 1)
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      s[e] += __shfl_xor_sync(0xffffffffu, s[e], mask);
      q[e] += __shfl_xor_sync(0xffffffffu, q[e], mask);
    }
  constexpr int kWarps = kMomThreads2 / 32, kVals = 2 * kMomSlab2;
  __shared__ float red[kWarps][kVals];  // then the fold's lanes
  __shared__ bool last;
  if (threadIdx.x % 32 < kMomGroups2) {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      red[threadIdx.x / 32][8 * group + e] = s[e];
      red[threadIdx.x / 32][kMomSlab2 + 8 * group + e] = q[e];
    }
  }
  __syncthreads();
  // value t < 64 of the slab: sums, then sums of squares, of its channels
  const int t = threadIdx.x, j = t % kVals;
  const int slab_ch = blockIdx.y * kMomSlab2 + j % kMomSlab2;
  const long long at = static_cast<long long>(j / kMomSlab2) * c + slab_ch;
  const bool live = slab_ch < c;
  if (t < kVals) {
    float v = red[0][t];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) v += red[w][t];
    if (gridDim.x == 1) {
      if (live) out[at] = v;
    } else if (live) {
      part[blockIdx.x * 2LL * c + at] = v;
    }
  }
  if (gridDim.x == 1) return;
  // the block's partial (ordered before the add by the barrier) released,
  // every other block's acquired: the last to count reads them all
  __syncthreads();
  if (t == 0) {
    unsigned seen;
    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;\n"
                 : "=r"(seen)
                 : "l"(done + blockIdx.y)
                 : "memory");
    last = seen == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  const int lane = t / kVals;  // chunks lane, lane + 4, ... ascending
  float v = 0.f;
  if (live) {
    const int chunks = static_cast<int>(gridDim.x);
    int k = lane;
#pragma unroll 4
    for (; k < chunks; k += kMomFoldLanes2) v += __ldcg(part + k * 2LL * c + at);
  }
  red[lane][j] = v;  // no thread reads red since the barrier above
  __syncthreads();
  if (t < kVals && live) {
    float o = red[0][t];
#pragma unroll
    for (int l = 1; l < kMomFoldLanes2; ++l) o += red[l][t];
    out[at] = o;
  }
  if (t == 0) done[blockIdx.y] = 0u;  // for the next launch on this stream
}
#endif  // MSP_FUSED_FWD && MSP_FUSED_BF16

// --------------------------------------------------------- host launchers

int ceil_div(long long a, long long b) {
  return static_cast<int>((a + b - 1) / b);
}

// True when 4-float pieces along a unit-stride axis are 16-byte aligned:
// `contiguous` is that axis's stride, `ld` the other axis's.
bool vec4_ok(const void* p, long long contiguous, long long ld) {
  return contiguous == 1 && ld % 4 == 0 &&
         reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

bool vec2_ok(const void* p, long long ld) {
  return ld % 2 == 0 && reinterpret_cast<uintptr_t>(p) % 8 == 0;
}

// Lets `kernel` use `bytes` of dynamic shared memory (above the 48 KB a
// launch gets unasked).
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// share_chunks: let 8 lanes share a long walk over the chunks; without it
// one thread sums a column's chunks in ascending order.
cudaError_t launch_fold_parts(const float* part, int chunks1, long long m1,
                              int chunks2, long long m2, float* out,
                              bool share_chunks, cudaStream_t s) {
  // float4 columns where there are outputs enough to fill the card with them
  const bool wide = m1 % 4 == 0 && m2 % 4 == 0 && m1 + m2 >= (1 << 16) &&
                    reinterpret_cast<uintptr_t>(part) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  // few chunks: a thread walks them all; many: 8 lanes share them
  const bool lanes =
      share_chunks && (chunks1 > chunks2 ? chunks1 : chunks2) > 8;
  const int groups = ceil_div(m1 + m2, wide ? 4 : 1);
#define MSP_FOLD(W, L)                                                      \
  fold_parts_kernel<W, L>                                                   \
      <<<ceil_div(groups, kFoldThreads / L), kFoldThreads, 0, s>>>(         \
          part, chunks1, m1, chunks2, m2, out)
  if (wide && lanes) MSP_FOLD(4, 8);
  else if (wide) MSP_FOLD(4, 1);
  else if (lanes) MSP_FOLD(1, 8);
  else MSP_FOLD(1, 1);
#undef MSP_FOLD
  return cudaGetLastError();
}

template <int NT, bool kWKC>
cudaError_t launch_apply(const float* x, const float* mul, const float* add,
                         const float* w, long long w_sc, long long w_sf,
                         long long n, int c, int f, int chunks,
                         int k_per_chunk, float* dst, cudaStream_t s) {
  auto kernel = apply_kernel<NT, kWKC>;
  cudaError_t e = allow_smem(kernel, kSmemBytes<NT>);
  if (e != cudaSuccess) return e;
  dim3 grid(ceil_div(n, kBM), ceil_div(f, 32 * NT), chunks);
  const bool w_vec = kWKC ? vec4_ok(w, w_sc, w_sf) : vec4_ok(w, w_sf, w_sc);
  // every chunk's (n, f) slab must keep the 8-byte alignment
  const bool out_vec = vec2_ok(dst, f) && (chunks == 1 || (n * f) % 2 == 0);
  kernel<<<grid, kThreads, kSmemBytes<NT>, s>>>(
      x, mul, add, w, w_sc, w_sf, n, c, f, k_per_chunk, vec4_ok(x, 1, c),
      w_vec, out_vec, dst);
  return cudaGetLastError();
}

Grid dw_grid_of(const DwArgs& dw, int tile_cols) {
  Grid grid{ceil_div(dw.c, kBM), ceil_div(dw.f, tile_cols), 0};
  grid.n = grid.x * grid.y * ceil_div(dw.n, dw.rows_per_chunk);
  return grid;
}

template <class Da>  // DaArgs or DaArgs2
Grid da_grid_of(const Da& da) {
  Grid grid{ceil_div(da.n, kBM), ceil_div(da.c, 64), 0};
  grid.n = grid.x * grid.y * ceil_div(da.f, da.k_per_chunk);
  return grid;
}

template <int NT, bool kWKC>
cudaError_t launch_bwd_dx(const DaArgs& da, cudaStream_t s) {
  auto kernel = bwd_dx_kernel<NT, kWKC>;
  cudaError_t e = allow_smem(kernel, kDaSmemBytes<NT>);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(ceil_div(da.n, kBM), ceil_div(da.c, 32 * NT)), kThreads,
           kDaSmemBytes<NT>, s>>>(da);
  return cudaGetLastError();
}

// A launch of `grid` in thread-block clusters of its grid.z blocks along z
// (bwd_dx's F chunks, apply's channel chunks: one cluster a tile), the
// cluster's size set at run time (it differs from stage to stage). `attr`
// backs the returned config.
cudaLaunchConfig_t z_cluster_config(dim3 grid, int smem_bytes, cudaStream_t s,
                                    cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = 1;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = grid.z;
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// bwd_dx's cluster grid: 64 x 64 tiles, `chunks` F chunks a tile
dim3 dx_grid(long long n, int c, int chunks) {
  return dim3(ceil_div(n, kBM), ceil_div(c, 64), chunks);
}

template <bool kWKC>
cudaError_t launch_bwd_dx_cluster(const DaArgs& da, int chunks,
                                  cudaStream_t s) {
  auto kernel = bwd_dx_cluster_kernel<kWKC>;
  cudaError_t e = allow_smem(kernel, kDaSmemBytes<2>);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = z_cluster_config(
      dx_grid(da.n, da.c, chunks), kDaSmemBytes<2>, s, &attr);
  void* args[] = {const_cast<DaArgs*>(&da)};
  e = cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(kernel), args);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// How many clusters of bwd_dx_cluster_kernel<kWKC> the card keeps resident
// at once for this launch shape.
template <bool kWKC>
cudaError_t dx_max_clusters(long long n, int c, int chunks, int* clusters) {
  auto kernel = bwd_dx_cluster_kernel<kWKC>;
  cudaError_t e = allow_smem(kernel, kDaSmemBytes<2>);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      z_cluster_config(dx_grid(n, c, chunks), kDaSmemBytes<2>, 0, &attr);
  return cudaOccupancyMaxActiveClusters(
      clusters, reinterpret_cast<const void*>(kernel), &cfg);
}

template <int kDwNT, bool kWKC>
cudaError_t launch_bwd_reduce(const DwArgs& dw, const DaArgs& da,
                              cudaStream_t s) {
  auto kernel = bwd_reduce_kernel<kDwNT, kWKC>;
  constexpr int kBytes = kSmemBytes<kDwNT> > kDaSmemBytes<2>
                             ? kSmemBytes<kDwNT> : kDaSmemBytes<2>;
  cudaError_t e = allow_smem(kernel, kBytes);
  if (e != cudaSuccess) return e;
  const Grid dw_grid = dw_grid_of(dw, 32 * kDwNT);
  const Grid da_grid = da_grid_of(da);
  kernel<<<dw_grid.n + da_grid.n, kThreads, kBytes, s>>>(dw, da, dw_grid,
                                                         da_grid);
  return cudaGetLastError();
}

// The da product's arguments but dx, part and the plan.
DaArgs da_args(const float* g, const float* w, long long w_sc, long long w_sf,
               const float* x, const float* mul, const float* add,
               const float* mean, const float* rstd, long long n, int c,
               int f) {
  DaArgs da{};
  da.g = g, da.w = w, da.w_sc = w_sc, da.w_sf = w_sf, da.x = x;
  da.mul = mul, da.add = add, da.mean = mean, da.rstd = rstd;
  da.n = n, da.c = c, da.f = f;
  da.g_vec = vec4_ok(g, 1, f), da.x_vec = vec4_ok(x, 1, c);
  // W[channel, f]: the tile's K axis (f) is contiguous when w_sf == 1
  da.w_vec = w_sf == 1 ? vec4_ok(w, w_sf, w_sc) : vec4_ok(w, w_sc, w_sf);
  return da;
}

bool tile_cols_ok(int tile_cols) { return tile_cols == 64 || tile_cols == 128; }

// ---------------------------------------------------- bf16 host launchers

// True when 8-element bf16 pieces along a unit-stride axis are 16-byte
// aligned: `contiguous` is that axis's stride, `ld` the other axis's.
bool vec8_ok(const void* p, long long contiguous, long long ld) {
  return contiguous == 1 && ld % 8 == 0 &&
         reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

bool k_chunk_w_ok(long long k) { return k > 0 && k % kBKW == 0; }

DaArgs2 da_args_bf16(const uint16_t* g, const uint16_t* w, long long w_sc,
                     long long w_sf, const uint16_t* x, const float* mul,
                     const float* add, const float* mean, const float* rstd,
                     long long n, int c, int f) {
  DaArgs2 da{};
  da.g = g, da.w = w, da.w_sc = w_sc, da.w_sf = w_sf, da.x = x;
  da.mul = mul, da.add = add, da.mean = mean, da.rstd = rstd;
  da.n = n, da.c = c, da.f = f;
  da.g_vec = vec8_ok(g, 1, f), da.x_vec = vec8_ok(x, 1, c);
  // W[channel, f]: the tile's K axis (f) is contiguous when w_sf == 1
  da.w_vec = w_sf == 1 ? vec8_ok(w, w_sf, w_sc) : vec8_ok(w, w_sc, w_sf);
  return da;
}

// The vectors a da block stages take 16-byte copies when all are aligned.
bool vecs_aligned(const float* const* v, int count) {
  for (int i = 0; i < count; ++i)
    if (reinterpret_cast<uintptr_t>(v[i]) % 16) return false;
  return true;
}

// bf16 apply's launch: (1, 1, chunks) clusters where chunks > 1, else a
// plain launch; kWG x 64 by kNH x 64 tiles.
template <int kWG, int kNH>
cudaLaunchConfig_t apply_config(const ApplyArgs2& p, int chunks,
                                cudaStream_t s, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = z_cluster_config(
      dim3(ceil_div(p.n, kWG * kBM), ceil_div(p.f, kNH * kBNW), chunks),
      kApplySmemW<kWG, kNH>, s, attr);
  cfg.blockDim = dim3(kWG * kThreads);
  if (chunks == 1) cfg.numAttrs = 0;
  return cfg;
}

template <int kWG, int kNH, bool kWKC>
cudaError_t launch_apply_bf16(const ApplyArgs2& p, int chunks,
                              cudaStream_t s) {
  auto kernel = apply_bf16_kernel<kWG, kNH, kWKC>;
  cudaError_t e = allow_smem(kernel, kApplySmemW<kWG, kNH>);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = apply_config<kWG, kNH>(p, chunks, s, &attr);
  void* args[] = {const_cast<ApplyArgs2*>(&p)};
  e = cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(kernel), args);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <int kWG, int kNH, bool kWKC>
cudaError_t apply_max_clusters_bf16(const ApplyArgs2& p, int chunks,
                                    int* clusters) {
  auto kernel = apply_bf16_kernel<kWG, kNH, kWKC>;
  cudaError_t e = allow_smem(kernel, kApplySmemW<kWG, kNH>);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = apply_config<kWG, kNH>(p, chunks, 0, &attr);
  return cudaOccupancyMaxActiveClusters(
      clusters, reinterpret_cast<const void*>(kernel), &cfg);
}

// apply's arguments from the entry points' (tiles 64 x 64 or 128 x 128,
// chunks of k_per_chunk, a multiple of 64: at most kMaxCluster of them, one
// for 128 x 128); false for a plan the kernel does not take.
bool apply_args_bf16(const uint16_t* x, const float* mul, const float* add,
                     const uint16_t* w, long long w_sc, long long w_sf,
                     long long n, int c, int f, int tile_rows, int tile_cols,
                     int k_per_chunk, uint16_t* out, ApplyArgs2* p,
                     int* chunks) {
  if (!(tile_rows == 64 || tile_rows == 128) || tile_cols != tile_rows ||
      !k_chunk_w_ok(k_per_chunk))
    return false;
  *chunks = ceil_div(c, k_per_chunk);
  if (*chunks > kMaxCluster || (*chunks > 1 && tile_cols != 64)) return false;
  const float* vecs[2] = {mul, add};
  *p = ApplyArgs2{x, w, mul, add, w_sc, w_sf, n, c, f, k_per_chunk,
                  vec8_ok(x, 1, c),
                  w_sc == 1 ? vec8_ok(w, w_sc, w_sf) : vec8_ok(w, w_sf, w_sc),
                  vecs_aligned(vecs, 2), vec8_ok(out, 1, f), out};
  return true;
}

// dW's row chunks in clusters of q_blocks (2 to 8, dividing 64), or (1) a
// plain launch.
template <bool kWKC>
cudaError_t launch_bwd_reduce_bf16(const DwArgs2& dw, const DaArgs2& da,
                                   int q_blocks, cudaStream_t s) {
  auto kernel = bwd_reduce_bf16_kernel<kWKC>;
  constexpr int kBytes = kReduceSmemW;
  cudaError_t e = allow_smem(kernel, kBytes);
  if (e != cudaSuccess) return e;
  Grid dw_grid{ceil_div(dw.c, kBM), ceil_div(dw.f, 64), 0};
  dw_grid.n = dw_grid.x * dw_grid.y * q_blocks *
              ceil_div(ceil_div(dw.n, dw.rows_per_chunk), q_blocks);
  const Grid da_grid = da_grid_of(da);
  if (q_blocks == 1) {  // no cluster: a plain launch
    kernel<<<dw_grid.n + da_grid.n, kThreads, kBytes, s>>>(dw, da, dw_grid,
                                                           da_grid);
    return cudaGetLastError();
  }
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = q_blocks;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3(dw_grid.n + q_blocks * ceil_div(da_grid.n, q_blocks));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kBytes;
  cfg.stream = s;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  void* args[] = {const_cast<DwArgs2*>(&dw), const_cast<DaArgs2*>(&da),
                  &dw_grid, const_cast<Grid*>(&da_grid)};
  e = cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(kernel), args);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <bool kWKC>
cudaError_t launch_bwd_dx_bf16(const DaArgs2& da, cudaStream_t s) {
  auto kernel = bwd_dx_bf16_kernel<kWKC>;
  constexpr int kBytes = DaSmemW::kBytes;
  cudaError_t e = allow_smem(kernel, kBytes);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(ceil_div(da.n, kBM), ceil_div(da.c, 64)), kThreads, kBytes,
           s>>>(da);
  return cudaGetLastError();
}

template <bool kWKC>
cudaError_t launch_bwd_dx_cluster_bf16(const DaArgs2& da, int chunks,
                                       cudaStream_t s) {
  auto kernel = bwd_dx_cluster_bf16_kernel<kWKC>;
  constexpr int kBytes = DaSmemW::kBytes;
  cudaError_t e = allow_smem(kernel, kBytes);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      z_cluster_config(dx_grid(da.n, da.c, chunks), kBytes, s, &attr);
  void* args[] = {const_cast<DaArgs2*>(&da)};
  e = cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(kernel), args);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <bool kWKC>
cudaError_t dx_max_clusters_bf16(long long n, int c, int chunks,
                                 int* clusters) {
  auto kernel = bwd_dx_cluster_bf16_kernel<kWKC>;
  constexpr int kBytes = DaSmemW::kBytes;
  cudaError_t e = allow_smem(kernel, kBytes);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      z_cluster_config(dx_grid(n, c, chunks), kBytes, 0, &attr);
  return cudaOccupancyMaxActiveClusters(
      clusters, reinterpret_cast<const void*>(kernel), &cfg);
}

template <bool kAKC, bool kBKC, bool kARegs>
cudaError_t launch_wgmma_tile(const uint16_t* a, const uint16_t* b, int k,
                              float* out, cudaStream_t s) {
  auto kernel = wgmma_bf16_tile_kernel<kAKC, kBKC, kARegs>;
  constexpr int kBytes = kAtomBytes + kRingBytesW;
  cudaError_t e = allow_smem(kernel, kBytes);
  if (e != cudaSuccess) return e;
  const bool a_vec = kAKC ? vec8_ok(a, 1, k) : vec8_ok(a, 1, kBM);
  const bool b_vec = kBKC ? vec8_ok(b, 1, k) : vec8_ok(b, 1, 64);
  kernel<<<1, kThreads, kBytes, s>>>(a, b, k, a_vec, b_vec, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// This source builds into six libraries, one nvcc each, side by side: the
// float32 entry points, and with -DMSP_FUSED_BF16 the bf16 ones, of one of
// three parts, -DMSP_FUSED_FWD (moments, apply), -DMSP_FUSED_BWD_REDUCE or
// -DMSP_FUSED_BWD_DX. Only the entry points differ; the kernel templates a
// library's entry points do not reach are not instantiated, so no build
// compiles another's kernels.
#ifndef MSP_FUSED_BF16

// All pointers are device pointers to float32; x is (n, c) and g (n, f),
// both C-contiguous; W is read as W[c*w_sc + f*w_sf]; vectors are (c,).
// Each function launches on `stream` without synchronising and returns the
// first CUDA error of its attribute calls and launches (0 on success;
// cudaErrorInvalidValue for a plan the kernels do not take). Scratch
// (`part`) is allocated by the caller with the sizes noted; the launch plan
// (tile_cols 64 or 128, chunk sizes as multiples of 16) is the caller's.

#ifdef MSP_FUSED_FWD
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
  // one thread a column: the batch statistics are a plain ascending sum of
  // the row chunks
  return launch_fold_parts(part, chunks, 2LL * c, 0, 0, out, false, s);
}

// out (n, f) = relu(x*mul + add) @ W. Channels are contracted in chunks of
// k_per_chunk (a multiple of 16, at most 1024); with one chunk the kernel
// writes out and part is unused, else part holds chunks * n * f floats,
// chunks = ceil(c / k_per_chunk), folded into out in ascending order.
int msp_fused_apply(const float* x, const float* mul, const float* add,
                    const float* w, long long w_sc, long long w_sf,
                    long long n, int c, int f, int tile_cols,
                    int k_per_chunk, float* part, float* out, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (!tile_cols_ok(tile_cols) || k_per_chunk <= 0 || k_per_chunk % kBK ||
      k_per_chunk > kMaxK)
    return cudaErrorInvalidValue;
  const int chunks = ceil_div(c, k_per_chunk);
  float* dst = chunks == 1 ? out : part;
  const bool wide = tile_cols == 128, kc = w_sc == 1;
#define MSP_APPLY(NT, KC)                                                  \
  launch_apply<NT, KC>(x, mul, add, w, w_sc, w_sf, n, c, f, chunks,        \
                       k_per_chunk, dst, s)
  cudaError_t e = wide ? (kc ? MSP_APPLY(4, true) : MSP_APPLY(4, false))
                       : (kc ? MSP_APPLY(2, true) : MSP_APPLY(2, false));
#undef MSP_APPLY
  if (e != cudaSuccess || chunks == 1) return e;
  return launch_fold_parts(part, chunks, n * f, 0, 0, out, true, s);
}

#endif  // MSP_FUSED_FWD

#ifdef MSP_FUSED_BWD_REDUCE
// out (c*f + 2c): dW (c, f), then dbeta (c), then dgamma (c). part:
// dw_chunks * c * f floats, dw_chunks = ceil(n / rows_per_chunk)
// (rows_per_chunk a multiple of 16), then ceil(n / 64) * da_chunks * 2c
// floats, da_chunks = ceil(f / da_k_per_chunk) (a multiple of 16 too).
int msp_fused_bwd_reduce(const float* x, const float* g, const float* w,
                         long long w_sc, long long w_sf, const float* mul,
                         const float* add, const float* mean,
                         const float* rstd, long long n, int c, int f,
                         int dw_tile_cols, long long rows_per_chunk,
                         int da_k_per_chunk, float* part, float* out,
                         void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (!tile_cols_ok(dw_tile_cols) || rows_per_chunk <= 0 ||
      rows_per_chunk % kBK || da_k_per_chunk <= 0 || da_k_per_chunk % kBK)
    return cudaErrorInvalidValue;
  const int dw_chunks = ceil_div(n, rows_per_chunk);
  const long long m_dw = static_cast<long long>(c) * f;
  DwArgs dw{x, g, mul, add, n, c, f, rows_per_chunk, vec4_ok(x, 1, c),
            vec4_ok(g, 1, f),
            vec2_ok(part, f) && (dw_chunks == 1 || m_dw % 2 == 0), part};
  DaArgs da = da_args(g, w, w_sc, w_sf, x, mul, add, mean, rstd, n, c, f);
  da.k_per_chunk = da_k_per_chunk;
  da.part = part + dw_chunks * m_dw;
  const bool dw_wide = dw_tile_cols == 128, kc = w_sf == 1;
  cudaError_t e;
  if (dw_wide) {
    e = kc ? launch_bwd_reduce<4, true>(dw, da, s)
           : launch_bwd_reduce<4, false>(dw, da, s);
  } else {
    e = kc ? launch_bwd_reduce<2, true>(dw, da, s)
           : launch_bwd_reduce<2, false>(dw, da, s);
  }
  if (e != cudaSuccess) return e;
  const int bg_parts = ceil_div(n, kBM) * ceil_div(f, da_k_per_chunk);
  return launch_fold_parts(part, dw_chunks, m_dw, bg_parts, 2LL * c, out, true,
                           s);
}

#endif  // MSP_FUSED_BWD_REDUCE

#ifdef MSP_FUSED_BWD_DX
// dx (n, c) = mul*(dz - c1 - xhat*c2). F is contracted in chunks of
// k_per_chunk (a multiple of 16): one chunk is the unsplit launch (tile_cols
// 64 or 128); 2 to 8 chunks the cluster launch (tile_cols 64), which a card
// may refuse for its cluster shape: that error is returned, nothing falls
// back.
int msp_fused_bwd_dx(const float* x, const float* g, const float* w,
                     long long w_sc, long long w_sf, const float* mul,
                     const float* add, const float* mean, const float* rstd,
                     const float* c1, const float* c2, long long n, int c,
                     int f, int tile_cols, int k_per_chunk, float* dx,
                     void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (!tile_cols_ok(tile_cols) || k_per_chunk <= 0 || k_per_chunk % kBK)
    return cudaErrorInvalidValue;
  const int chunks = ceil_div(f, k_per_chunk);
  if (chunks > kMaxCluster || (chunks > 1 && tile_cols != 64))
    return cudaErrorInvalidValue;
  DaArgs da = da_args(g, w, w_sc, w_sf, x, mul, add, mean, rstd, n, c, f);
  da.c1 = c1, da.c2 = c2, da.dx = dx, da.dx_vec = vec2_ok(dx, c);
  da.dx_vec4 = vec4_ok(dx, 1, c);
  da.k_per_chunk = k_per_chunk;
  const bool kc = w_sf == 1;
  if (chunks > 1)
    return kc ? launch_bwd_dx_cluster<true>(da, chunks, s)
              : launch_bwd_dx_cluster<false>(da, chunks, s);
  if (tile_cols == 128)
    return kc ? launch_bwd_dx<4, true>(da, s)
              : launch_bwd_dx<4, false>(da, s);
  return kc ? launch_bwd_dx<2, true>(da, s) : launch_bwd_dx<2, false>(da, s);
}

// *clusters = how many clusters of bwd_dx's cluster launch for (n, c, f) in
// chunks of k_per_chunk (2 to 8 chunks) the card keeps resident at once
// (cudaOccupancyMaxActiveClusters); w_kc: W's F axis is the contiguous one.
int msp_fused_bwd_dx_max_clusters(long long n, int c, int f, int k_per_chunk,
                                  int w_kc, int* clusters) {
  if (k_per_chunk <= 0 || k_per_chunk % kBK) return cudaErrorInvalidValue;
  const int chunks = ceil_div(f, k_per_chunk);
  if (chunks < 2 || chunks > kMaxCluster) return cudaErrorInvalidValue;
  return w_kc ? dx_max_clusters<true>(n, c, chunks, clusters)
              : dx_max_clusters<false>(n, c, chunks, clusters);
}

#endif  // MSP_FUSED_BWD_DX

#else  // MSP_FUSED_BF16

// The bf16 entry points: x, g and W are bf16 (as their 16 bits), the
// vectors fp32; dW, dgamma, dbeta and the moments fp32, out and dx bf16.
// Chunk sizes are multiples of 64 (the wgmma core's step).

#ifdef MSP_FUSED_FWD
// out (2c): sums then sums of squares, in one launch of rows_per_chunk
// (256, 512 or 1024) row chunks of 32-channel slabs. part: chunks * 2c
// floats, chunks = ceil(n / rows_per_chunk), where chunks > 1 (else
// unused); done: ceil(c / 32) counters, 0 on entry, left at 0 (the caller
// keeps one set for each stream).
int msp_fused_moments_bf16(const uint16_t* x, long long n, int c,
                           long long rows_per_chunk, float* part,
                           unsigned* done, float* out, void* stream) {
  const dim3 grid(ceil_div(n, rows_per_chunk), ceil_div(c, kMomSlab2));
  auto s = static_cast<cudaStream_t>(stream);
  const bool vec = vec8_ok(x, 1, c);
#define MSP_MOMENTS(U)                                                      \
  moments_bf16_kernel<U><<<grid, kMomThreads2, 0, s>>>(x, n, c, vec, part, \
                                                        done, out)
  if (rows_per_chunk == 4 * kMomLanes2) MSP_MOMENTS(4);
  else if (rows_per_chunk == 8 * kMomLanes2) MSP_MOMENTS(8);
  else if (rows_per_chunk == 16 * kMomLanes2) MSP_MOMENTS(16);
  else return cudaErrorInvalidValue;
#undef MSP_MOMENTS
  return cudaGetLastError();
}

// out (n, f) bf16 in one launch: tile_rows x tile_cols tiles (64 x 64 or
// 128 x 128), channels in chunks of k_per_chunk (64 x 64: at most 8
// chunks, one thread-block cluster a tile).
int msp_fused_apply_bf16(const uint16_t* x, const float* mul,
                         const float* add, const uint16_t* w, long long w_sc,
                         long long w_sf, long long n, int c, int f,
                         int tile_rows, int tile_cols, int k_per_chunk,
                         uint16_t* out, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  ApplyArgs2 p;
  int chunks;
  if (!apply_args_bf16(x, mul, add, w, w_sc, w_sf, n, c, f, tile_rows,
                       tile_cols, k_per_chunk, out, &p, &chunks))
    return cudaErrorInvalidValue;
  const bool kc = w_sc == 1;
#define MSP_APPLY(WG, NH)                                                   \
  (kc ? launch_apply_bf16<WG, NH, true>(p, chunks, s)                       \
      : launch_apply_bf16<WG, NH, false>(p, chunks, s))
  return tile_rows == 128 ? MSP_APPLY(2, 2) : MSP_APPLY(1, 1);
#undef MSP_APPLY
}

// *clusters = how many clusters of apply's launch for (n, c, f) at this
// plan (2 to 8 chunks) the card keeps resident at once
// (cudaOccupancyMaxActiveClusters); w_kc: W's channel axis is the
// contiguous one.
int msp_fused_apply_max_clusters_bf16(long long n, int c, int f,
                                      int tile_rows, int tile_cols,
                                      int k_per_chunk, int w_kc,
                                      int* clusters) {
  ApplyArgs2 p;
  int chunks;
  if (!apply_args_bf16(nullptr, nullptr, nullptr, nullptr, w_kc ? 1 : f,
                       w_kc ? c : 1, n, c, f, tile_rows, tile_cols,
                       k_per_chunk, nullptr, &p, &chunks) ||
      chunks < 2)
    return cudaErrorInvalidValue;
#define MSP_CLUSTERS(WG, NH)                                                \
  (w_kc ? apply_max_clusters_bf16<WG, NH, true>(p, chunks, clusters)        \
        : apply_max_clusters_bf16<WG, NH, false>(p, chunks, clusters))
  return MSP_CLUSTERS(1, 1);
#undef MSP_CLUSTERS
}

#endif  // MSP_FUSED_FWD

#ifdef MSP_FUSED_BWD_REDUCE
// out as msp_fused_bwd_reduce (fp32), from bf16 x, g and W. dW takes 64 x
// 64 tiles (dw_tile_cols 64) and row chunks of rows_per_chunk (a multiple
// of 64), in clusters of dw_cluster (1, 2, 4 or 8) that write one partial
// each; part: the partials, ceil(chunks / dw_cluster) * c * f floats, when
// there are two or more (one is written straight into out), then the
// dbeta / dgamma partials as msp_fused_bwd_reduce's. A card that refuses
// the cluster shape returns its error; nothing falls back.
int msp_fused_bwd_reduce_bf16(const uint16_t* x, const uint16_t* g,
                              const uint16_t* w, long long w_sc,
                              long long w_sf, const float* mul,
                              const float* add, const float* mean,
                              const float* rstd, long long n, int c, int f,
                              int dw_tile_cols, long long rows_per_chunk,
                              int dw_cluster, int da_k_per_chunk, float* part,
                              float* out, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dw_tile_cols != 64 || !k_chunk_w_ok(rows_per_chunk) ||
      !k_chunk_w_ok(da_k_per_chunk) || dw_cluster < 1 ||
      dw_cluster > kMaxCluster || kBM % dw_cluster)
    return cudaErrorInvalidValue;
  const int groups = ceil_div(ceil_div(n, rows_per_chunk), dw_cluster);
  const long long m_dw = static_cast<long long>(c) * f;
  // one partial is dW itself: written into out, no fold
  float* dw_part = groups == 1 ? out : part;
  DwArgs2 dw{x, g, mul, add, n, c, f, rows_per_chunk, vec8_ok(x, 1, c),
             vec8_ok(g, 1, f),
             vec4_ok(dw_part, 1, f) && (groups == 1 || m_dw % 4 == 0),
             dw_part};
  DaArgs2 da = da_args_bf16(g, w, w_sc, w_sf, x, mul, add, mean, rstd, n, c,
                            f);
  const float* vecs[4] = {mul, add, mean, rstd};
  da.v_vec = vecs_aligned(vecs, 4);
  da.k_per_chunk = da_k_per_chunk;
  da.part = groups == 1 ? part : part + groups * m_dw;
  const cudaError_t e =
      w_sf == 1 ? launch_bwd_reduce_bf16<true>(dw, da, dw_cluster, s)
                : launch_bwd_reduce_bf16<false>(dw, da, dw_cluster, s);
  if (e != cudaSuccess) return e;
  const int bg_parts = ceil_div(n, kBM) * ceil_div(f, da_k_per_chunk);
  if (groups == 1)
    return launch_fold_parts(da.part, bg_parts, 2LL * c, 0, 0, out + m_dw,
                             true, s);
  return launch_fold_parts(part, groups, m_dw, bg_parts, 2LL * c, out, true,
                           s);
}

#endif  // MSP_FUSED_BWD_REDUCE

#ifdef MSP_FUSED_BWD_DX
// dx (n, c) bf16 = mul*(dz - c1 - xhat*c2) in 64 x 64 tiles (tile_cols
// 64), F in chunks of k_per_chunk (a multiple of 64): one chunk is the
// unsplit launch, 2 to 8 the cluster launch, as msp_fused_bwd_dx.
int msp_fused_bwd_dx_bf16(const uint16_t* x, const uint16_t* g,
                          const uint16_t* w, long long w_sc, long long w_sf,
                          const float* mul, const float* add,
                          const float* mean, const float* rstd,
                          const float* c1, const float* c2, long long n, int c,
                          int f, int tile_cols, int k_per_chunk, uint16_t* dx,
                          void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const int chunks = ceil_div(f, k_per_chunk);
  if (tile_cols != 64 || !k_chunk_w_ok(k_per_chunk) || chunks > kMaxCluster)
    return cudaErrorInvalidValue;
  DaArgs2 da = da_args_bf16(g, w, w_sc, w_sf, x, mul, add, mean, rstd, n, c,
                            f);
  da.c1 = c1, da.c2 = c2, da.dx = dx, da.dx_vec = vec8_ok(dx, 1, c);
  const float* vecs[6] = {mul, add, mean, rstd, c1, c2};
  da.v_vec = vecs_aligned(vecs, 6);
  da.k_per_chunk = k_per_chunk;
  const bool kc = w_sf == 1;
  if (chunks > 1)
    return kc ? launch_bwd_dx_cluster_bf16<true>(da, chunks, s)
              : launch_bwd_dx_cluster_bf16<false>(da, chunks, s);
  return kc ? launch_bwd_dx_bf16<true>(da, s) : launch_bwd_dx_bf16<false>(da, s);
}

// As msp_fused_bwd_dx_max_clusters, for the bf16 cluster launch (F chunks
// of k_per_chunk, a multiple of 64).
int msp_fused_bwd_dx_max_clusters_bf16(long long n, int c, int f,
                                       int k_per_chunk, int w_kc,
                                       int* clusters) {
  if (!k_chunk_w_ok(k_per_chunk)) return cudaErrorInvalidValue;
  const int chunks = ceil_div(f, k_per_chunk);
  if (chunks < 2 || chunks > kMaxCluster) return cudaErrorInvalidValue;
  return w_kc ? dx_max_clusters_bf16<true>(n, c, chunks, clusters)
              : dx_max_clusters_bf16<false>(n, c, chunks, clusters);
}

// The wgmma core alone on one tile (for its tests): out (64, 64) fp32 =
// A B^T over k (a multiple of 8), A (64, k) and B (64, k) bf16, each
// K-major ([row][k]) or, where a_mn / b_mn, MN-major ([k][row]); a_regs:
// A reaches wgmma from registers (ldmatrix), else through its descriptor.
int msp_wgmma_bf16_tile(const uint16_t* a, const uint16_t* b, int a_mn,
                        int b_mn, int a_regs, int k, float* out,
                        void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (k <= 0 || k % 8) return cudaErrorInvalidValue;
#define MSP_TILE(AKC, BKC)                                                  \
  (a_regs ? launch_wgmma_tile<AKC, BKC, true>(a, b, k, out, s)              \
          : launch_wgmma_tile<AKC, BKC, false>(a, b, k, out, s))
  if (a_mn) return b_mn ? MSP_TILE(false, false) : MSP_TILE(false, true);
  return b_mn ? MSP_TILE(true, false) : MSP_TILE(true, true);
#undef MSP_TILE
}

#endif  // MSP_FUSED_BWD_DX

#endif  // MSP_FUSED_BF16

const char* msp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
