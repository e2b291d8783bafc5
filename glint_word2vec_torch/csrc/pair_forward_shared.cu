// Forward half of the fused SGNS pair step with a shared negative pool, for
// Hopper (sm_90a).
//
// Replaces glint_word2vec_tpu/ops/pallas_sgns.py::pair_forward_shared
// (kernel body _pair_forward_shared_kernel, :284-405), the first phase of
// fused_pair_step_shared. For each pair p of a dense pair batch, with
// h = syn0[centers[p]], u = syn1[contexts[p]] and the S pool rows
// syn1[pool[s]], all upcast to fp32, it writes
//   c_pos[p]     = alpha * (1 - sigmoid(h.u)) * mask[p]
//   w[p, s]      = mask[p] * (n / S) * (pool[s] != contexts[p])
//   c_pool[p, s] = -alpha * sigmoid(h.pool_s) * w[p, s]
//   h_out[p]     = h
//   d_center[p]  = c_pos[p] * u + sum_s c_pool[p, s] * pool_s
//   d_pool[s]    = sum_p c_pool[p, s] * h_p
//   loss         = sum_p -log sigmoid(h.u) * mask[p]
//                  + sum_{p, s} -log sigmoid(-h.pool_s) * w[p, s]
// in fp32 whatever the tables' dtype, with no TF32 and no rounding of the
// operands to bf16.
//
// Bound: arithmetic. The three pool products, f_pool = h . pool^T,
// c_pool . pool and c_pool^T . h, are 2 * P * S * d flops each: 24.2 GFLOP
// at P = 3,277, S = 4,096, d = 300, 0.361 ms at the card's 67 TFLOP/s of
// fp32 outside the tensor cores, against about 25.6 MB of rows and outputs
// (0.0076 ms at 3.35 TB/s).
//
// Design: four launches on one stream, from this one source.
//   1. stage: one warp per pair copies h to h_out and takes f_pos, c_pos
//      and the pair's positive loss; one warp per pool row copies that row,
//      upcast, into the fp32 workspace pool32 (S x d).
//   2. pool logits: a tiled product h . pool32^T whose epilogue applies the
//      collision mask and the weight, writes c_pool (P x S fp32, a device
//      workspace) and one partial pool loss per pair and column tile.
//   3. d_center: c_pool . pool32, plus c_pos * u in the epilogue.
//   4. d_pool: c_pool^T . h. Each block owns a tile of d_pool's rows and
//      loops over all P pairs in a fixed order.
// The TPU kernel keeps c_pool in VMEM and sums d_pool across its sequential
// grid steps in one resident block (:394-399). Hopper blocks run in no
// order, so here every output element has exactly one owner block that sums
// its terms in a fixed order: the result is the same on every run (bitwise
// resume), with no float atomics. The c_pool round trip through device
// memory (about 107 MB at full width, roughly 0.03 ms) is the price of that
// simplicity; keeping c_pool on chip is later work.
//
// The products are plain tiled fp32 FFMA: blocks of 16 x 16 threads,
// operand tiles of depth 8 staged in shared memory (double buffered, the
// next tile's loads in registers while the current one is multiplied).
// The logits product takes 128 x 128 output tiles, 8 x 8 a thread, held
// to 128 registers so that two blocks share an SM; the two products whose
// depth is S or P take 64 x 64 tiles, 4 x 4 a thread, so that their few
// tiles (260 and 320 at full width) still fill the card.
// Ragged edges in every dimension are zero-filled on load and masked on
// store, so any P, S >= 1 and any d >= 1 work, and masked pairs (mask 0,
// hence w 0 and c_pool +-0) add exact zeros to d_pool. wgmma, TMA and
// tensor-core operands are later work. Row offsets are 64-bit: id * d
// passes 2^31 at V = 10,000,000. The partial losses are summed by the
// wrapper in a fixed order.
//
// Preconditions: the tables share one row stride; every id lies in [0, V)
// (the caller keeps this, as the training path does by drawing ids from the
// corpus and the alias table: no id is range-checked here).
//
// Plain C interface, built by glint_word2vec_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound with ctypes by glint_word2vec_torch/ops/fused_sgns.py.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kStageThreads = kWarpsPerBlock * 32;

// Product tiles: 16 x 16 threads; a thread owns TM x TN outputs in groups
// of 4 rows (columns) spaced 64 apart, so the tile is 16 * TM rows by
// 16 * TN columns.
constexpr int kThreads = 256;
constexpr int kBK = 8;
constexpr int kPad = 4;
constexpr int kTiles1N = 128;  // column tile of the pool-logits product

constexpr int32_t kDtypeF32 = 0;
constexpr int32_t kDtypeBF16 = 1;

__device__ __forceinline__ float load_f(const float* p, int64_t i) {
  return __ldg(p + i);
}

// bf16 -> fp32 is exact: the bf16 bits are the high half of the fp32 bits.
__device__ __forceinline__ float load_f(const uint16_t* p, int64_t i) {
  return __uint_as_float(static_cast<uint32_t>(__ldg(p + i)) << 16);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// log(sigmoid(x)) = -softplus(-x) = -(max(-x, 0) + log1p(exp(-|x|))).
__device__ __forceinline__ float log_sigmoid(float x) {
  return -(fmaxf(-x, 0.0f) + log1pf(expf(-fabsf(x))));
}

// ----------------------------------------------------------------------
// 1. Stage: pairs and pool rows
// ----------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kStageThreads)
stage_kernel(const T* __restrict__ syn0, const T* __restrict__ syn1,
             int64_t stride, const int32_t* __restrict__ centers,
             const int32_t* __restrict__ contexts,
             const float* __restrict__ mask, const int32_t* __restrict__ pool,
             const float* __restrict__ alpha_p, int64_t P, int64_t S,
             int64_t d, int64_t pair_blocks, float* __restrict__ c_pos_out,
             float* __restrict__ h_out, float* __restrict__ loss_pos,
             float* __restrict__ pool32) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (static_cast<int64_t>(blockIdx.x) < pair_blocks) {
    const int64_t p = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + warp;
    if (p >= P) return;
    const T* hrow = syn0 + static_cast<int64_t>(__ldg(centers + p)) * stride;
    const T* urow = syn1 + static_cast<int64_t>(__ldg(contexts + p)) * stride;
    float* hdst = h_out + p * d;
    float acc = 0.0f;
    for (int64_t j = lane; j < d; j += 32) {
      const float hv = load_f(hrow, j);
      hdst[j] = hv;
      acc = fmaf(hv, load_f(urow, j), acc);
    }
    const float f_pos = warp_sum(acc);
    if (lane == 0) {
      const float m = __ldg(mask + p);
      c_pos_out[p] = __ldg(alpha_p) * (1.0f - sigmoid(f_pos)) * m;
      loss_pos[p] = -log_sigmoid(f_pos) * m;
    }
  } else {
    const int64_t s =
        (static_cast<int64_t>(blockIdx.x) - pair_blocks) * kWarpsPerBlock + warp;
    if (s >= S) return;
    const T* row = syn1 + static_cast<int64_t>(__ldg(pool + s)) * stride;
    float* dst = pool32 + s * d;
    for (int64_t j = lane; j < d; j += 32) dst[j] = load_f(row, j);
  }
}

// ----------------------------------------------------------------------
// The tiled fp32 product C(m, n) = sum_k A(m, k) B(k, n)
// ----------------------------------------------------------------------

// A(m, k) is a[m * lda + k] when A_K is true (rows of A contiguous in k),
// else a[k * lda + m]; B(k, n) is b[n * ldb + k] when B_K is true, else
// b[k * ldb + n]. Entries outside [0, M) x [0, K) or [0, K) x [0, N) read
// as zero.
template <int TM, int TN, bool A_K, bool B_K>
struct Tile {
  static constexpr int BM = 16 * TM;
  static constexpr int BN = 16 * TN;
  static constexpr int LA = BM * kBK / kThreads;  // A values a thread loads
  static constexpr int LB = BN * kBK / kThreads;

  // 16-byte aligned rows of (BM + 4) floats: the float4 reads below, and
  // the padding spreads a tile's stores over all 32 banks.
  alignas(16) float as[2][kBK][BM + kPad];
  alignas(16) float bs[2][kBK][BN + kPad];

  static __device__ __forceinline__ void load(
      const float* __restrict__ a, int64_t lda, const float* __restrict__ b,
      int64_t ldb, int64_t M, int64_t N, int64_t K, int64_t m0, int64_t n0,
      int64_t k0, float (&ra)[LA], float (&rb)[LB]) {
    const int tid = threadIdx.x;
#pragma unroll
    for (int r = 0; r < LA; ++r) {
      const int idx = tid + kThreads * r;
      const int kk = A_K ? idx % kBK : idx / BM;
      const int mi = A_K ? idx / kBK : idx % BM;
      const int64_t m = m0 + mi, k = k0 + kk;
      ra[r] = (m < M && k < K) ? __ldg(a + (A_K ? m * lda + k : k * lda + m))
                               : 0.0f;
    }
#pragma unroll
    for (int r = 0; r < LB; ++r) {
      const int idx = tid + kThreads * r;
      const int kk = B_K ? idx % kBK : idx / BN;
      const int ni = B_K ? idx / kBK : idx % BN;
      const int64_t n = n0 + ni, k = k0 + kk;
      rb[r] = (n < N && k < K) ? __ldg(b + (B_K ? n * ldb + k : k * ldb + n))
                               : 0.0f;
    }
  }

  __device__ __forceinline__ void store(int buf, const float (&ra)[LA],
                                        const float (&rb)[LB]) {
    const int tid = threadIdx.x;
#pragma unroll
    for (int r = 0; r < LA; ++r) {
      const int idx = tid + kThreads * r;
      as[buf][A_K ? idx % kBK : idx / BM][A_K ? idx / kBK : idx % BM] = ra[r];
    }
#pragma unroll
    for (int r = 0; r < LB; ++r) {
      const int idx = tid + kThreads * r;
      bs[buf][B_K ? idx % kBK : idx / BN][B_K ? idx / kBK : idx % BN] = rb[r];
    }
  }

  // Local row of a thread's i-th output row, and column of its j-th.
  static __device__ __forceinline__ int row(int i) {
    return (i >> 2) * 64 + (threadIdx.x >> 4) * 4 + (i & 3);
  }
  static __device__ __forceinline__ int col(int j) {
    return (j >> 2) * 64 + (threadIdx.x & 15) * 4 + (j & 3);
  }

  // acc[i][j] = C(m0 + row(i), n0 + col(j)), the sum over k taken in
  // increasing k, one fused multiply-add a term.
  __device__ __forceinline__ void run(const float* __restrict__ a, int64_t lda,
                                      const float* __restrict__ b, int64_t ldb,
                                      int64_t M, int64_t N, int64_t K,
                                      int64_t m0, int64_t n0,
                                      float (&acc)[TM][TN]) {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
    float ra[LA], rb[LB];
    load(a, lda, b, ldb, M, N, K, m0, n0, 0, ra, rb);
    store(0, ra, rb);
    __syncthreads();
    const int64_t tiles = (K + kBK - 1) / kBK;
    const int ty4 = (threadIdx.x >> 4) * 4;
    const int tx4 = (threadIdx.x & 15) * 4;
    for (int64_t t = 0; t < tiles; ++t) {
      const int cur = static_cast<int>(t & 1);
      if (t + 1 < tiles)
        load(a, lda, b, ldb, M, N, K, m0, n0, (t + 1) * kBK, ra, rb);
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        float av[TM], bv[TN];
#pragma unroll
        for (int g = 0; g < TM / 4; ++g) {
          const float4 v =
              *reinterpret_cast<const float4*>(&as[cur][kk][g * 64 + ty4]);
          av[4 * g] = v.x;
          av[4 * g + 1] = v.y;
          av[4 * g + 2] = v.z;
          av[4 * g + 3] = v.w;
        }
#pragma unroll
        for (int g = 0; g < TN / 4; ++g) {
          const float4 v =
              *reinterpret_cast<const float4*>(&bs[cur][kk][g * 64 + tx4]);
          bv[4 * g] = v.x;
          bv[4 * g + 1] = v.y;
          bv[4 * g + 2] = v.z;
          bv[4 * g + 3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      // The other buffer was last read before the previous barrier.
      if (t + 1 < tiles) store(cur ^ 1, ra, rb);
      __syncthreads();
    }
  }
};

// ----------------------------------------------------------------------
// 2. Pool logits, coefficients and pool loss
// ----------------------------------------------------------------------

using LogitTile = Tile<8, 8, true, true>;
static_assert(LogitTile::BN == kTiles1N, "column tile of the logits");

__global__ void __launch_bounds__(kThreads, 2)
pool_logits_kernel(const float* __restrict__ h, const float* __restrict__ pool32,
                   int64_t P, int64_t S, int64_t d,
                   const int32_t* __restrict__ contexts,
                   const float* __restrict__ mask,
                   const int32_t* __restrict__ pool,
                   const float* __restrict__ alpha_p, float w_scale,
                   int64_t n_tiles, float* __restrict__ c_pool,
                   float* __restrict__ loss_part) {
  __shared__ LogitTile tile;
  __shared__ float red[LogitTile::BM][17];
  const int64_t m0 = static_cast<int64_t>(blockIdx.x / n_tiles) * LogitTile::BM;
  const int64_t tn = static_cast<int64_t>(blockIdx.x % n_tiles);
  const int64_t n0 = tn * LogitTile::BN;
  float acc[8][8];
  // f_pool(p, s) = sum_k h[p, k] * pool32[s, k].
  tile.run(h, d, pool32, d, P, S, d, m0, n0, acc);
  const float neg_alpha = -__ldg(alpha_p);
  const int tx = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t p = m0 + LogitTile::row(i);
    float lsum = 0.0f;
    if (p < P) {
      const float wrow = __ldg(mask + p) * w_scale;
      const int32_t ctx = __ldg(contexts + p);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int64_t s = n0 + LogitTile::col(j);
        if (s < S) {
          const float f = acc[i][j];
          const float w = __ldg(pool + s) != ctx ? wrow : 0.0f;
          c_pool[p * S + s] = neg_alpha * sigmoid(f) * w;
          lsum += -log_sigmoid(-f) * w;
        }
      }
    }
    red[LogitTile::row(i)][tx] = lsum;
  }
  __syncthreads();
  if (threadIdx.x < LogitTile::BM) {
    const int64_t p = m0 + threadIdx.x;
    if (p < P) {
      float t = 0.0f;
      for (int x = 0; x < 16; ++x) t += red[threadIdx.x][x];
      loss_part[p * n_tiles + tn] = t;
    }
  }
}

// ----------------------------------------------------------------------
// 3. d_center = c_pos * u + c_pool . pool32
// ----------------------------------------------------------------------

using RowTile = Tile<4, 4, true, false>;

template <typename T>
__global__ void __launch_bounds__(kThreads)
d_center_kernel(const float* __restrict__ c_pool,
                const float* __restrict__ pool32, const T* __restrict__ syn1,
                int64_t stride, const int32_t* __restrict__ contexts,
                const float* __restrict__ c_pos, int64_t P, int64_t S,
                int64_t d, int64_t n_tiles, float* __restrict__ d_center) {
  __shared__ RowTile tile;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x / n_tiles) * RowTile::BM;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x % n_tiles) * RowTile::BN;
  float acc[4][4];
  tile.run(c_pool, S, pool32, d, P, d, S, m0, n0, acc);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t p = m0 + RowTile::row(i);
    if (p >= P) continue;
    const T* urow = syn1 + static_cast<int64_t>(__ldg(contexts + p)) * stride;
    const float cp = __ldg(c_pos + p);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t c = n0 + RowTile::col(j);
      if (c < d)
        d_center[p * d + c] = __fadd_rn(__fmul_rn(cp, load_f(urow, c)), acc[i][j]);
    }
  }
}

// ----------------------------------------------------------------------
// 4. d_pool = c_pool^T . h
// ----------------------------------------------------------------------

using PoolTile = Tile<4, 4, false, false>;

__global__ void __launch_bounds__(kThreads)
d_pool_kernel(const float* __restrict__ c_pool, const float* __restrict__ h,
              int64_t P, int64_t S, int64_t d, int64_t n_tiles,
              float* __restrict__ d_pool) {
  __shared__ PoolTile tile;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x / n_tiles) * PoolTile::BM;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x % n_tiles) * PoolTile::BN;
  float acc[4][4];
  // d_pool(s, c) = sum_p c_pool[p, s] * h[p, c], p in increasing order.
  tile.run(c_pool, S, h, d, S, d, P, m0, n0, acc);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t s = m0 + PoolTile::row(i);
    if (s >= S) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t c = n0 + PoolTile::col(j);
      if (c < d) d_pool[s * d + c] = acc[i][j];
    }
  }
}

int grid_of(int64_t m, int64_t bm, int64_t n, int64_t bn, int64_t* n_tiles,
            unsigned* blocks) {
  *n_tiles = (n + bn - 1) / bn;
  const int64_t b = ((m + bm - 1) / bm) * *n_tiles;
  if (b > 0x7fffffff) return cudaErrorInvalidValue;
  *blocks = static_cast<unsigned>(b);
  return cudaSuccess;
}

template <typename T>
int launch(const void* syn0, const void* syn1, int64_t stride,
           const void* centers, const void* contexts, const void* mask,
           const void* pool, const void* alpha, int64_t P, int64_t S,
           int64_t d, float w_scale, void* c_pos, void* h, void* d_center,
           void* d_pool, void* loss_pos, void* loss_part, void* pool32,
           void* c_pool, cudaStream_t s) {
  const T* t0 = static_cast<const T*>(syn0);
  const T* t1 = static_cast<const T*>(syn1);
  const int32_t* cen = static_cast<const int32_t*>(centers);
  const int32_t* ctx = static_cast<const int32_t*>(contexts);
  const int32_t* pl = static_cast<const int32_t*>(pool);
  const float* m = static_cast<const float*>(mask);
  const float* a = static_cast<const float*>(alpha);
  float* cpos = static_cast<float*>(c_pos);
  float* hf = static_cast<float*>(h);
  float* p32 = static_cast<float*>(pool32);
  float* cpl = static_cast<float*>(c_pool);

  const int64_t pair_blocks = (P + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int64_t stage_blocks = pair_blocks + (S + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (stage_blocks > 0x7fffffff) return cudaErrorInvalidValue;
  stage_kernel<T><<<static_cast<unsigned>(stage_blocks), kStageThreads, 0, s>>>(
      t0, t1, stride, cen, ctx, m, pl, a, P, S, d, pair_blocks, cpos, hf,
      static_cast<float*>(loss_pos), p32);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  int64_t nt;
  unsigned blocks;
  int rc = grid_of(P, LogitTile::BM, S, LogitTile::BN, &nt, &blocks);
  if (rc != cudaSuccess) return rc;
  pool_logits_kernel<<<blocks, kThreads, 0, s>>>(
      hf, p32, P, S, d, ctx, m, pl, a, w_scale, nt, cpl,
      static_cast<float*>(loss_part));
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);

  rc = grid_of(P, RowTile::BM, d, RowTile::BN, &nt, &blocks);
  if (rc != cudaSuccess) return rc;
  d_center_kernel<T><<<blocks, kThreads, 0, s>>>(
      cpl, p32, t1, stride, ctx, cpos, P, S, d, nt,
      static_cast<float*>(d_center));
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);

  rc = grid_of(S, PoolTile::BM, d, PoolTile::BN, &nt, &blocks);
  if (rc != cudaSuccess) return rc;
  d_pool_kernel<<<blocks, kThreads, 0, s>>>(cpl, hf, P, S, d, nt,
                                            static_cast<float*>(d_pool));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Columns of the per-pair partial pool losses: one per tile of 128 pool
// columns.
int64_t glint_pair_forward_shared_loss_tiles(int64_t S) {
  return (S + kTiles1N - 1) / kTiles1N;
}

// Launches the shared-pool forward pass on `stream` and returns the first
// non-zero cudaGetLastError() of its four launches as an int (0 = launched).
// syn0/syn1 are [V, stride] of `dtype` (0 = f32, 1 = bf16); centers,
// contexts [P] int32; mask [P] f32; pool [S] int32; alpha a device f32
// scalar; w_scale = n / S rounded to f32. Outputs, contiguous fp32: c_pos
// [P], h [P, d], d_center [P, d], d_pool [S, d], and the loss in two
// parts: loss_pos [P] and loss_part [P, glint_pair_forward_shared_loss_tiles
// (S)], whose entries sum to the loss. Workspaces, contiguous fp32: pool32
// [S, d], c_pool [P, S]. Does not synchronise and allocates nothing.
int glint_pair_forward_shared(const void* syn0, const void* syn1,
                              int64_t stride, int32_t dtype,
                              const void* centers, const void* contexts,
                              const void* mask, const void* pool,
                              const void* alpha, int64_t P, int64_t S,
                              int64_t d, float w_scale, void* c_pos, void* h,
                              void* d_center, void* d_pool, void* loss_pos,
                              void* loss_part, void* pool32, void* c_pool,
                              void* stream) {
  if (P < 0 || S < 1 || d <= 0 || stride < d) return cudaErrorInvalidValue;
  if (P == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kDtypeF32:
      return launch<float>(syn0, syn1, stride, centers, contexts, mask, pool,
                           alpha, P, S, d, w_scale, c_pos, h, d_center, d_pool,
                           loss_pos, loss_part, pool32, c_pool, s);
    case kDtypeBF16:
      return launch<uint16_t>(syn0, syn1, stride, centers, contexts, mask,
                              pool, alpha, P, S, d, w_scale, c_pos, h,
                              d_center, d_pool, loss_pos, loss_part, pool32,
                              c_pool, s);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* glint_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
