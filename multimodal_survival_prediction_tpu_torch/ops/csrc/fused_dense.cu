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

// An element of x as fp32: a float, or a bf16 held as its 16 bits.
__device__ __forceinline__ float bf16_bits_to_f32(uint16_t b) {
  return __uint_as_float(static_cast<uint32_t>(b) << 16);
}
__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const uint16_t* p) {
  return bf16_bits_to_f32(__ldg(p));
}

// Block (kMomCh channels x kMomLanes row lanes) sums one chunk of rows.
// part is (chunks, 2C): sums at [chunk][c], sums of squares at [chunk][C+c].
template <class T>
__device__ __forceinline__ void moments_partial(const T* __restrict__ x,
                                                long long n, int c,
                                                long long rows_per_chunk,
                                                float* __restrict__ part) {
  const int ch = blockIdx.y * kMomCh + threadIdx.x;
  const long long r0 = static_cast<long long>(blockIdx.x) * rows_per_chunk;
  const long long r1 = min(n, r0 + rows_per_chunk);
  float s = 0.f, q = 0.f;
  if (ch < c) {
    for (long long r = r0 + threadIdx.y; r < r1; r += kMomLanes) {
      const float v = load_f32(x + r * c + ch);
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

__global__ void __launch_bounds__(kMomCh * kMomLanes)
moments_partial_kernel(const float* __restrict__ x, long long n, int c,
                       long long rows_per_chunk, float* __restrict__ part) {
  moments_partial(x, n, c, rows_per_chunk, part);
}

// The same sums over bf16 rows (sums in fp32; the fold is the f32 one's).
__global__ void __launch_bounds__(kMomCh * kMomLanes)
moments_partial_bf16_kernel(const uint16_t* __restrict__ x, long long n,
                            int c, long long rows_per_chunk,
                            float* __restrict__ part) {
  moments_partial(x, n, c, rows_per_chunk, part);
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
// The bf16 variants of apply, bwd_reduce and bwd_dx (the JAX kernels run in
// the compute dtype: bf16 operands into the products, fp32 accumulation;
// out and dx in bf16; dW, dgamma and dbeta in fp32). One GEMM core on
// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32: a product of two
// bf16 values is exact in fp32, so one product a 16-deep slab replaces the
// fp32 core's three TF32 ones, and mma.sync needs neither the TF32 split
// nor wgmma's shared-memory layouts. Each warp owns 16 rows of the 64-row
// tile (the fp32 core's Lane layout, so store_acc serves both), and the
// tile is 64 or 128 columns wide as the launch plan says.
//
// Loads: a step is 32 deep (64 bytes of a row, the fp32 step's bytes). Each
// thread loads its 8-element pieces of the next step into registers (one
// 16-byte load a piece where the axis is contiguous and aligned, else one
// element at a time, zero past the edge) while the tensor cores run the
// current step, then writes them to shared memory as [outer][K] rows of
// kBK2 + 8 elements (80 bytes: the fragment reads hit 32 banks). The BN +
// ReLU prologue runs on that write: each element of x is converted to
// fp32, normalized, ReLU'd and rounded to bf16 once, by the thread that
// loaded it (the ReLU mask is the plain version's: the same two fp32
// roundings). Split-K (apply over C, dW over rows) and bwd_reduce's split
// of F write fp32 partials that the fp32 path's fold sums in a fixed order
// (apply's partials fold straight to bf16); bwd_dx is one unsplit launch.

constexpr int kBK2 = 32;         // bf16 K step: two 16-deep mma slabs
constexpr int kLd2 = kBK2 + 8;   // shared-memory row of a bf16 tile
template <int T>
constexpr int kTile2 = T * kLd2;  // bf16 elements of a [T][kLd2] tile
static_assert(kMaxK % kBK2 == 0, "apply's staged vectors hold whole steps");

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

// One bf16 operand's tile loads, step after step along K. Element (o, k) of
// the next step's tile is base[o*so + k*sk] for o < o_left and k < k_left,
// else 0. kKC: the pieces run along K (K is the contiguous axis), else
// along the outer axis. vec: the pieces' axis has stride 1, the other
// stride is a multiple of 8 and the array 16-byte aligned.
template <int T, bool kKC>
struct TileLoad2 {
  static constexpr int kPieces = T * kBK2 / 8 / kThreads;
  static_assert(kPieces * 8 * kThreads == T * kBK2, "tile must split evenly");
  const uint16_t* base;
  long long so, sk;
  int o_left, k_left;
  bool vec;
  uint4 r[kPieces];

  __device__ __forceinline__ TileLoad2(const uint16_t* src, long long o0,
                                       long long o_lim, long long so_,
                                       long long k0, long long k_lim,
                                       long long sk_, bool vec_)
      : base(src + o0 * so_ + k0 * sk_), so(so_), sk(sk_),
        o_left(static_cast<int>(min(max(o_lim - o0, 0LL), 1LL * T))),
        k_left(static_cast<int>(min(max(k_lim - k0, 0LL), 1LL << 30))),
        vec(vec_) {}

  // The outer position and depth of this thread's piece i.
  __device__ __forceinline__ static void piece(int i, int& o, int& k) {
    const int u = threadIdx.x + i * kThreads;
    if (kKC) {
      o = u / (kBK2 / 8);
      k = (u % (kBK2 / 8)) * 8;
    } else {
      o = (u % (T / 8)) * 8;
      k = u / (T / 8);
    }
  }

  // Loads the next step's pieces into registers.
  __device__ __forceinline__ void load() {
#pragma unroll
    for (int i = 0; i < kPieces; ++i) {
      int o, k;
      piece(i, o, k);
      const int along = kKC ? k_left - k : o_left - o;
      const bool across = kKC ? o < o_left : k < k_left;
      const int live = across ? min(max(along, 0), 8) : 0;
      if (vec && live == 8) {
        r[i] = __ldg(reinterpret_cast<const uint4*>(
            base + (kKC ? o * so + k : o + k * sk)));
      } else {
        uint16_t e[8];
#pragma unroll
        for (int q = 0; q < 8; ++q)
          e[q] = q < live ? __ldg(base + (kKC ? o * so + (k + q) * sk
                                              : (o + q) * so + k * sk))
                          : static_cast<uint16_t>(0);
        r[i] = pack8(e);
      }
    }
    base += kBK2 * sk;
    k_left -= kBK2;
  }

  // Writes the pieces of step s into `tile` ([T][kLd2], K contiguous). Each
  // element goes through op(v, o, s*kBK2 + k) in fp32 unless kRaw.
  template <bool kRaw, class Op>
  __device__ __forceinline__ void store(uint16_t* tile, int s, Op op) const {
#pragma unroll
    for (int i = 0; i < kPieces; ++i) {
      int o, k;
      piece(i, o, k);
      uint16_t e[8];
      unpack8(r[i], e);
      if (!kRaw) {
#pragma unroll
        for (int q = 0; q < 8; ++q)
          e[q] = f32_to_bf16_bits(op(bf16_bits_to_f32(e[q]), kKC ? o : o + q,
                                     s * kBK2 + (kKC ? k + q : k)));
      }
      if (kKC) {
        *reinterpret_cast<uint4*>(tile + o * kLd2 + k) = pack8(e);
      } else {
#pragma unroll
        for (int q = 0; q < 8; ++q) tile[(o + q) * kLd2 + k] = e[q];
      }
    }
  }
};

// d += a b: one 16 x 8 x 16 bf16 product of the warp, fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t tile_word(const uint16_t* tile, int o,
                                              int k) {
  return *reinterpret_cast<const uint32_t*>(tile + o * kLd2 + k);
}

// One step's products: A (64 x kBK2) and B (32 NT x kBK2) from shared
// memory, both [outer][K]; warp w's rows 16 w .. 16 w + 15.
template <int NT>
__device__ __forceinline__ void mma_step(const uint16_t* sa,
                                         const uint16_t* sb,
                                         float (&acc)[kNJ<NT>][4],
                                         const Lane& ln) {
#pragma unroll
  for (int slab = 0; slab < kBK2 / 16; ++slab) {
    const int k = 16 * slab + 2 * ln.t, r = 16 * ln.w + ln.g;
    const uint32_t a[4] = {tile_word(sa, r, k), tile_word(sa, r + 8, k),
                           tile_word(sa, r, k + 8),
                           tile_word(sa, r + 8, k + 8)};
#pragma unroll
    for (int j = 0; j < kNJ<NT>; ++j) {
      const int col = 8 * j + ln.g;
      mma_bf16(acc[j], a, tile_word(sb, col, k), tile_word(sb, col, k + 8));
    }
  }
}

// The K loop: step s + 1's loads are in flight while step s's products run.
// a_op(v, o, k) is A's prologue (kARaw: none). What the caller staged in
// shared memory before the call is visible to a_op. On return every thread
// is past its last read of sa and sb.
template <int NT, bool kAKC, bool kBKC, bool kARaw, class AOp>
__device__ __forceinline__ void mainloop_bf16(TileLoad2<kBM, kAKC>& a,
                                              TileLoad2<32 * NT, kBKC>& b,
                                              int steps, uint16_t* sa,
                                              uint16_t* sb,
                                              float (&acc)[kNJ<NT>][4],
                                              const Lane& ln, AOp a_op) {
  const auto raw = [](float v, int, int) { return v; };
#pragma unroll
  for (int j = 0; j < kNJ<NT>; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;
  if (steps <= 0) return;
  a.load();
  b.load();
  __syncthreads();  // the caller's staged vectors
  a.template store<kARaw>(sa, 0, a_op);
  b.template store<true>(sb, 0, raw);
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    const bool more = s + 1 < steps;
    if (more) {
      a.load();
      b.load();
    }
    mma_step<NT>(sa, sb, acc, ln);
    __syncthreads();  // every warp is done with step s's tiles
    if (more) {
      a.template store<kARaw>(sa, s + 1, a_op);
      b.template store<true>(sb, s + 1, raw);
      __syncthreads();
    }
  }
}

// dst[(row0 + r)*ld + col0 + c] = bf16(acc(r, c)) for row0 + r < rows,
// col0 + c < cols; pair: ld is even and dst 4-byte aligned.
template <int NT>
__device__ __forceinline__ void store_acc_bf16(
    uint16_t* __restrict__ dst, long long ld, long long row0, long long rows,
    int col0, int cols, const float (&acc)[kNJ<NT>][4], const Lane& ln,
    bool pair) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long row = row0 + 16 * ln.w + ln.g + 8 * h;
    if (row >= rows) continue;
#pragma unroll
    for (int j = 0; j < kNJ<NT>; ++j) {
      const int col = col0 + 8 * j + 2 * ln.t;
      uint16_t* p = dst + row * ld + col;
      if (pair && col + 1 < cols) {
        *reinterpret_cast<uint32_t*>(p) =
            pack_bf16x2(acc[j][2 * h], acc[j][2 * h + 1]);
      } else {
        if (col < cols) p[0] = f32_to_bf16_bits(acc[j][2 * h]);
        if (col + 1 < cols) p[1] = f32_to_bf16_bits(acc[j][2 * h + 1]);
      }
    }
  }
}

// bf16 apply: out (N, F) = bf16(relu(x*mul + add) rounded to bf16 @ W),
// or, with chunks of C (gridDim.z > 1), fp32 partials at part[blockIdx.z]
// (N, F) for fold_bf16_kernel; grid (ceil(N/64), ceil(F/(32 NT)), chunks).
template <int NT, bool kWKC>
__global__ void __launch_bounds__(kThreads)
apply_bf16_kernel(const uint16_t* __restrict__ x,
                  const float* __restrict__ mul,
                  const float* __restrict__ add,
                  const uint16_t* __restrict__ w, long long w_sc,
                  long long w_sf, long long n, int c, int f, int k_per_chunk,
                  bool x_vec, bool w_vec, bool out_pair,
                  uint16_t* __restrict__ out, float* __restrict__ part) {
  __shared__ float smul[kMaxK], sadd[kMaxK];
  __shared__ __align__(16) uint16_t sa[kTile2<kBM>];
  __shared__ __align__(16) uint16_t sb[kTile2<32 * NT>];
  const Lane ln;
  const long long m0 = static_cast<long long>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * 32 * NT;
  const int k_beg = blockIdx.z * k_per_chunk;
  const int k_end = min(c, k_beg + k_per_chunk);

  // A(m = row, k = channel) = x, B(k = channel, n = output) = W
  TileLoad2<kBM, true> a(x, m0, n, c, k_beg, k_end, 1, x_vec);
  TileLoad2<32 * NT, kWKC> b(w, n0, f, w_sf, k_beg, k_end, w_sc, w_vec);
  stage_vector(smul, mul, k_beg, k_end, k_per_chunk);
  stage_vector(sadd, add, k_beg, k_end, k_per_chunk);
  float acc[kNJ<NT>][4];
  mainloop_bf16<NT, true, kWKC, false>(
      a, b, (k_end - k_beg + kBK2 - 1) / kBK2, sa, sb, acc, ln,
      [&](float v, int, int k) {
        return fmaxf(bn_z(v, smul[k], sadd[k]), 0.f);
      });
  if (gridDim.z == 1)
    store_acc_bf16<NT>(out, f, m0, n, n0, f, acc, ln, out_pair);
  else
    store_acc<NT>(part + static_cast<long long>(blockIdx.z) * n * f, f, m0,
                  n, n0, f, acc, ln, out_pair);
}

// out[j] = bf16(sum_k part[k*m + j]), k ascending: apply's channel chunks.
__global__ void __launch_bounds__(kFoldThreads)
fold_bf16_kernel(const float* __restrict__ part, int chunks, long long m,
                 uint16_t* __restrict__ out) {
  const long long j =
      static_cast<long long>(blockIdx.x) * kFoldThreads + threadIdx.x;
  if (j >= m) return;
  float s = 0.f;
  for (int k = 0; k < chunks; ++k) s += part[k * m + j];
  out[j] = f32_to_bf16_bits(s);
}

struct DwArgs2 {
  const uint16_t *x, *g;
  const float *mul, *add;
  long long n;
  int c, f;
  long long rows_per_chunk;
  bool x_vec, g_vec, out_vec;
  float* part;
};

// bf16 partial dW over one chunk of rows: part[b.z] (C, F) = bf16(a)^T g
// in fp32; grid (ceil(C/64), ceil(F/(32 NT)), chunks).
template <int NT>
__device__ __forceinline__ void dw_block_bf16(const DwArgs2& p, const Block& b,
                                              unsigned char* smem) {
  float* smul = reinterpret_cast<float*>(smem);
  float* sadd = smul + kBM;
  uint16_t* sa = reinterpret_cast<uint16_t*>(sadd + kBM);
  uint16_t* sb = sa + kTile2<kBM>;
  const Lane ln;
  const int c0 = b.x * kBM;
  const int f0 = b.y * 32 * NT;
  const long long r0 = static_cast<long long>(b.z) * p.rows_per_chunk;
  const long long r1 = min(p.n, r0 + p.rows_per_chunk);

  // A(m = channel, k = row) = x[row, channel], B(k = row, n = output) = g
  TileLoad2<kBM, false> a(p.x, c0, p.c, 1, r0, r1, p.c, p.x_vec);
  TileLoad2<32 * NT, false> bl(p.g, f0, p.f, 1, r0, r1, p.f, p.g_vec);
  stage_vector(smul, p.mul, c0, p.c, kBM);
  stage_vector(sadd, p.add, c0, p.c, kBM);
  float acc[kNJ<NT>][4];
  mainloop_bf16<NT, false, false, false>(
      a, bl, static_cast<int>((r1 - r0 + kBK2 - 1) / kBK2), sa, sb, acc, ln,
      [&](float v, int ch, int) {
        // rows past r1 become relu(add) here, against g rows that are 0
        return fmaxf(bn_z(v, smul[ch], sadd[ch]), 0.f);
      });
  store_acc<NT>(p.part + static_cast<long long>(b.z) * p.c * p.f, p.f, c0,
                p.c, f0, p.f, acc, ln, p.out_vec);
}

// The bf16 da = g W^T product and its epilogue, as DaArgs / da_block for
// fp32: kDx = false writes the dbeta/dgamma partials of the block's 64
// rows (F chunk b.z); kDx = true writes dx in bf16 (one chunk).
struct DaArgs2 {
  const uint16_t *g, *w;
  long long w_sc, w_sf;
  const uint16_t* x;
  const float *mul, *add, *mean, *rstd, *c1, *c2;
  long long n;
  int c, f, k_per_chunk;
  bool g_vec, w_vec, x_pair, dx_pair;
  uint16_t* dx;
  float* part;
};

// x[row, ch] and x[row, ch + 1] as fp32, 0 past N or C.
__device__ __forceinline__ float2 x_pair_of(const DaArgs2& p, long long row,
                                            int ch) {
  if (row >= p.n) return make_float2(0.f, 0.f);
  const uint16_t* at = p.x + row * p.c + ch;
  if (p.x_pair && ch + 1 < p.c) {
    const uint32_t v = __ldg(reinterpret_cast<const unsigned int*>(at));
    return make_float2(bf16_bits_to_f32(static_cast<uint16_t>(v)),
                       bf16_bits_to_f32(static_cast<uint16_t>(v >> 16)));
  }
  return make_float2(ch < p.c ? load_f32(at) : 0.f,
                     ch + 1 < p.c ? load_f32(at + 1) : 0.f);
}

// v[ch] and v[ch + 1], 0 past C.
__device__ __forceinline__ float2 vec_pair_of(const float* v, int ch, int c) {
  return make_float2(ch < c ? __ldg(v + ch) : 0.f,
                     ch + 1 < c ? __ldg(v + ch + 1) : 0.f);
}

template <bool kDx, int NT, bool kWKC>
__device__ __forceinline__ void da_block_bf16(const DaArgs2& p,
                                              const Block& b,
                                              unsigned char* smem) {
  constexpr int kBN = 32 * NT;
  uint16_t* sa = reinterpret_cast<uint16_t*>(smem);
  uint16_t* sb = sa + kTile2<kBM>;
  const int c = p.c;
  const Lane ln;
  const long long m0 = static_cast<long long>(b.x) * kBM;
  const int n0 = b.y * kBN;
  const int k_beg = b.z * p.k_per_chunk;
  const int k_end = min(p.f, k_beg + p.k_per_chunk);
  // A(m = row, k = f) = g[row, f], B(k = f, n = channel) = W[channel, f]
  TileLoad2<kBM, true> a(p.g, m0, p.n, p.f, k_beg, k_end, 1, p.g_vec);
  TileLoad2<kBN, kWKC> bl(p.w, n0, c, p.w_sc, k_beg, k_end, p.w_sf, p.w_vec);
  float acc[kNJ<NT>][4];
  mainloop_bf16<NT, true, kWKC, true>(
      a, bl, (k_end - k_beg + kBK2 - 1) / kBK2, sa, sb, acc, ln,
      [](float v, int, int) { return v; });

  float s_db[kNJ<NT>][2], s_dg[kNJ<NT>][2];
#pragma unroll
  for (int j = 0; j < kNJ<NT>; ++j) {
    // two neighbouring channels a thread; channels past C read zeros and
    // are not stored
    const int ch = n0 + 8 * j + 2 * ln.t;
    const float2 mu = vec_pair_of(p.mul, ch, c), ad = vec_pair_of(p.add, ch, c);
    const float2 me = vec_pair_of(p.mean, ch, c);
    const float2 rs = vec_pair_of(p.rstd, ch, c);
    s_db[j][0] = s_db[j][1] = s_dg[j][0] = s_dg[j][1] = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long row = m0 + 16 * ln.w + ln.g + 8 * h;
      const float2 xv = x_pair_of(p, row, ch);
      if constexpr (kDx) {
        if (row >= p.n) continue;
        const float2 k1 = vec_pair_of(p.c1, ch, c);
        const float2 k2 = vec_pair_of(p.c2, ch, c);
        const float d0 =
            dx_of(xv.x, acc[j][2 * h], mu.x, ad.x, me.x, rs.x, k1.x, k2.x);
        const float d1 = dx_of(xv.y, acc[j][2 * h + 1], mu.y, ad.y, me.y,
                               rs.y, k1.y, k2.y);
        uint16_t* dst = p.dx + row * c + ch;
        if (p.dx_pair && ch + 1 < c) {
          *reinterpret_cast<uint32_t*>(dst) = pack_bf16x2(d0, d1);
        } else {
          if (ch < c) dst[0] = f32_to_bf16_bits(d0);
          if (ch + 1 < c) dst[1] = f32_to_bf16_bits(d1);
        }
      } else {
        // rows past N add 0: their da is 0 (g is zero-filled)
        const float dz0 = bn_z(xv.x, mu.x, ad.x) > 0.f ? acc[j][2 * h] : 0.f;
        const float dz1 =
            bn_z(xv.y, mu.y, ad.y) > 0.f ? acc[j][2 * h + 1] : 0.f;
        s_db[j][0] += dz0;
        s_db[j][1] += dz1;
        s_dg[j][0] += dz0 * ((xv.x - me.x) * rs.x);
        s_dg[j][1] += dz1 * ((xv.y - me.y) * rs.y);
      }
    }
  }

  if constexpr (!kDx) {
    // column sums over the block's 64 rows in a fixed order, as da_block
    constexpr int kWarps = kThreads / 32;
    float* red = reinterpret_cast<float*>(smem);  // [2][kWarps][kBN]
    static_assert(2 * kWarps * kBN * 4 <= kTile2<kBM> * 2, "red fits in sa");
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

template <int NT>
constexpr int kDwSmem2 = 2 * kBM * 4 + (kTile2<kBM> + kTile2<32 * NT>) * 2;
template <int NT>
constexpr int kDaSmem2 = (kTile2<kBM> + kTile2<32 * NT>) * 2;

// bf16 bwd_dx: the da product with the BN backward as its epilogue; grid
// (ceil(N/64), ceil(C/(32 NT))).
template <int NT, bool kWKC>
__global__ void __launch_bounds__(kThreads)
bwd_dx_bf16_kernel(const DaArgs2 p) {
  __shared__ __align__(16) unsigned char smem[kDaSmem2<NT>];
  da_block_bf16<true, NT, kWKC>(
      p, Block{static_cast<int>(blockIdx.x), static_cast<int>(blockIdx.y), 0,
               static_cast<int>(gridDim.x)},
      smem);
}

// bf16 bwd_reduce's two products in one launch, as bwd_reduce_kernel.
template <int kDwNT, bool kWKC>
__global__ void __launch_bounds__(kThreads)
bwd_reduce_bf16_kernel(const DwArgs2 dw, const DaArgs2 da, const Grid dw_grid,
                       const Grid da_grid) {
  constexpr int kBytes =
      kDwSmem2<kDwNT> > kDaSmem2<2> ? kDwSmem2<kDwNT> : kDaSmem2<2>;
  __shared__ __align__(16) unsigned char smem[kBytes];
  int id = blockIdx.x;
  if (id < dw_grid.n) {
    dw_block_bf16<kDwNT>(dw, Block{id % dw_grid.x, id / dw_grid.x % dw_grid.y,
                                   id / (dw_grid.x * dw_grid.y), dw_grid.x},
                         smem);
  } else {
    id -= dw_grid.n;
    da_block_bf16<false, 2, kWKC>(
        da, Block{id % da_grid.x, id / da_grid.x % da_grid.y,
                  id / (da_grid.x * da_grid.y), da_grid.x},
        smem);
  }
}

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

template <class Dw>  // DwArgs or DwArgs2
Grid dw_grid_of(const Dw& dw, int tile_cols) {
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

// The cluster launch of bwd_dx: `chunks` F chunks, one cluster of `chunks`
// blocks a 64 x 64 tile, the cluster's size set at run time (it differs
// from stage to stage). `attr` backs the returned config.
cudaLaunchConfig_t dx_cluster_config(long long n, int c, int chunks,
                                     cudaStream_t s,
                                     cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = 1;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = chunks;
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3(ceil_div(n, kBM), ceil_div(c, 64), chunks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kDaSmemBytes<2>;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <bool kWKC>
cudaError_t launch_bwd_dx_cluster(const DaArgs& da, int chunks,
                                  cudaStream_t s) {
  auto kernel = bwd_dx_cluster_kernel<kWKC>;
  cudaError_t e = allow_smem(kernel, kDaSmemBytes<2>);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = dx_cluster_config(da.n, da.c, chunks, s,
                                                   &attr);
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
  const cudaLaunchConfig_t cfg = dx_cluster_config(n, c, chunks, 0, &attr);
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

// Pairs of bf16 along rows of `ld` elements take 4-byte accesses.
bool pair_ok(const void* p, long long ld) {
  return ld % 2 == 0 && reinterpret_cast<uintptr_t>(p) % 4 == 0;
}

bool k_chunk_ok(long long k) { return k > 0 && k % kBK2 == 0; }

template <int NT, bool kWKC>
cudaError_t launch_apply_bf16(const uint16_t* x, const float* mul,
                              const float* add, const uint16_t* w,
                              long long w_sc, long long w_sf, long long n,
                              int c, int f, int chunks, int k_per_chunk,
                              uint16_t* out, float* part, cudaStream_t s) {
  dim3 grid(ceil_div(n, kBM), ceil_div(f, 32 * NT), chunks);
  const bool w_vec = kWKC ? vec8_ok(w, w_sc, w_sf) : vec8_ok(w, w_sf, w_sc);
  // bf16 pairs into out, or float2 pairs into every chunk's (n, f) slab
  const bool out_pair = chunks == 1
                            ? pair_ok(out, f)
                            : vec2_ok(part, f) && (n * f) % 2 == 0;
  apply_bf16_kernel<NT, kWKC><<<grid, kThreads, 0, s>>>(
      x, mul, add, w, w_sc, w_sf, n, c, f, k_per_chunk, vec8_ok(x, 1, c),
      w_vec, out_pair, out, part);
  return cudaGetLastError();
}

DaArgs2 da_args_bf16(const uint16_t* g, const uint16_t* w, long long w_sc,
                     long long w_sf, const uint16_t* x, const float* mul,
                     const float* add, const float* mean, const float* rstd,
                     long long n, int c, int f) {
  DaArgs2 da{};
  da.g = g, da.w = w, da.w_sc = w_sc, da.w_sf = w_sf, da.x = x;
  da.mul = mul, da.add = add, da.mean = mean, da.rstd = rstd;
  da.n = n, da.c = c, da.f = f;
  da.g_vec = vec8_ok(g, 1, f), da.x_pair = pair_ok(x, c);
  // W[channel, f]: the tile's K axis (f) is contiguous when w_sf == 1
  da.w_vec = w_sf == 1 ? vec8_ok(w, w_sf, w_sc) : vec8_ok(w, w_sc, w_sf);
  return da;
}

template <int kDwNT, bool kWKC>
cudaError_t launch_bwd_reduce_bf16(const DwArgs2& dw, const DaArgs2& da,
                                   cudaStream_t s) {
  const Grid dw_grid = dw_grid_of(dw, 32 * kDwNT);
  const Grid da_grid = da_grid_of(da);
  bwd_reduce_bf16_kernel<kDwNT, kWKC>
      <<<dw_grid.n + da_grid.n, kThreads, 0, s>>>(dw, da, dw_grid, da_grid);
  return cudaGetLastError();
}

template <int NT, bool kWKC>
cudaError_t launch_bwd_dx_bf16(const DaArgs2& da, cudaStream_t s) {
  bwd_dx_bf16_kernel<NT, kWKC>
      <<<dim3(ceil_div(da.n, kBM), ceil_div(da.c, 32 * NT)), kThreads, 0,
         s>>>(da);
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
// Chunk sizes are multiples of 32 (the bf16 K step).

#ifdef MSP_FUSED_FWD
int msp_fused_moments_bf16(const uint16_t* x, long long n, int c,
                           long long rows_per_chunk, float* part, float* out,
                           void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const int chunks = ceil_div(n, rows_per_chunk);
  dim3 grid(chunks, ceil_div(c, kMomCh));
  moments_partial_bf16_kernel<<<grid, dim3(kMomCh, kMomLanes), 0, s>>>(
      x, n, c, rows_per_chunk, part);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return launch_fold_parts(part, chunks, 2LL * c, 0, 0, out, false, s);
}

// out (n, f) bf16. With more than one chunk of C, part holds chunks * n * f
// floats folded into out in ascending order.
int msp_fused_apply_bf16(const uint16_t* x, const float* mul,
                         const float* add, const uint16_t* w, long long w_sc,
                         long long w_sf, long long n, int c, int f,
                         int tile_cols, int k_per_chunk, float* part,
                         uint16_t* out, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (!tile_cols_ok(tile_cols) || !k_chunk_ok(k_per_chunk) ||
      k_per_chunk > kMaxK)
    return cudaErrorInvalidValue;
  const int chunks = ceil_div(c, k_per_chunk);
  const bool wide = tile_cols == 128, kc = w_sc == 1;
#define MSP_APPLY(NT, KC)                                                  \
  launch_apply_bf16<NT, KC>(x, mul, add, w, w_sc, w_sf, n, c, f, chunks,   \
                            k_per_chunk, out, part, s)
  cudaError_t e = wide ? (kc ? MSP_APPLY(4, true) : MSP_APPLY(4, false))
                       : (kc ? MSP_APPLY(2, true) : MSP_APPLY(2, false));
#undef MSP_APPLY
  if (e != cudaSuccess || chunks == 1) return e;
  fold_bf16_kernel<<<ceil_div(n * f, kFoldThreads), kFoldThreads, 0, s>>>(
      part, chunks, n * f, out);
  return cudaGetLastError();
}

#endif  // MSP_FUSED_FWD

#ifdef MSP_FUSED_BWD_REDUCE
// out and part as msp_fused_bwd_reduce (fp32), from bf16 x, g and W.
int msp_fused_bwd_reduce_bf16(const uint16_t* x, const uint16_t* g,
                              const uint16_t* w, long long w_sc,
                              long long w_sf, const float* mul,
                              const float* add, const float* mean,
                              const float* rstd, long long n, int c, int f,
                              int dw_tile_cols, long long rows_per_chunk,
                              int da_k_per_chunk, float* part, float* out,
                              void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (!tile_cols_ok(dw_tile_cols) || !k_chunk_ok(rows_per_chunk) ||
      !k_chunk_ok(da_k_per_chunk))
    return cudaErrorInvalidValue;
  const int dw_chunks = ceil_div(n, rows_per_chunk);
  const long long m_dw = static_cast<long long>(c) * f;
  DwArgs2 dw{x, g, mul, add, n, c, f, rows_per_chunk, vec8_ok(x, 1, c),
             vec8_ok(g, 1, f),
             vec2_ok(part, f) && (dw_chunks == 1 || m_dw % 2 == 0), part};
  DaArgs2 da = da_args_bf16(g, w, w_sc, w_sf, x, mul, add, mean, rstd, n, c,
                            f);
  da.k_per_chunk = da_k_per_chunk;
  da.part = part + dw_chunks * m_dw;
  const bool dw_wide = dw_tile_cols == 128, kc = w_sf == 1;
  cudaError_t e;
  if (dw_wide) {
    e = kc ? launch_bwd_reduce_bf16<4, true>(dw, da, s)
           : launch_bwd_reduce_bf16<4, false>(dw, da, s);
  } else {
    e = kc ? launch_bwd_reduce_bf16<2, true>(dw, da, s)
           : launch_bwd_reduce_bf16<2, false>(dw, da, s);
  }
  if (e != cudaSuccess) return e;
  const int bg_parts = ceil_div(n, kBM) * ceil_div(f, da_k_per_chunk);
  return launch_fold_parts(part, dw_chunks, m_dw, bg_parts, 2LL * c, out, true,
                           s);
}

#endif  // MSP_FUSED_BWD_REDUCE

#ifdef MSP_FUSED_BWD_DX
// dx (n, c) bf16 = mul*(dz - c1 - xhat*c2), F unsplit (tile_cols 64 or 128).
int msp_fused_bwd_dx_bf16(const uint16_t* x, const uint16_t* g,
                          const uint16_t* w, long long w_sc, long long w_sf,
                          const float* mul, const float* add,
                          const float* mean, const float* rstd,
                          const float* c1, const float* c2, long long n, int c,
                          int f, int tile_cols, uint16_t* dx, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (!tile_cols_ok(tile_cols)) return cudaErrorInvalidValue;
  DaArgs2 da = da_args_bf16(g, w, w_sc, w_sf, x, mul, add, mean, rstd, n, c,
                            f);
  da.c1 = c1, da.c2 = c2, da.dx = dx, da.dx_pair = pair_ok(dx, c);
  da.k_per_chunk = ceil_div(f, kBK2) * kBK2;
  const bool kc = w_sf == 1;
  if (tile_cols == 128)
    return kc ? launch_bwd_dx_bf16<4, true>(da, s)
              : launch_bwd_dx_bf16<4, false>(da, s);
  return kc ? launch_bwd_dx_bf16<2, true>(da, s)
            : launch_bwd_dx_bf16<2, false>(da, s);
}

#endif  // MSP_FUSED_BWD_DX

#endif  // MSP_FUSED_BF16

const char* msp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
