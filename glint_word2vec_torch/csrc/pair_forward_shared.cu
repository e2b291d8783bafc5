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
// to fp32 accuracy whatever the tables' dtype: no operand is rounded to
// bf16 or to a single TF32 value.
//
// Bound: arithmetic. The three pool products, f_pool = h . pool^T,
// c_pool . pool and c_pool^T . h, are 2 * P * S * d flops each, 8.02 GFLOP
// over the 3,264 live pairs at P = 3,277, S = 4,096, d = 300. They run on
// the tensor cores in split TF32 (below): 3 passes a product for fp32
// tables, 72.2 GFLOP, 0.146 ms at the card's 495 TFLOP/s of dense TF32;
// for bf16 tables 1 pass for the logits and 2 for each other product,
// 0.081 ms. On the fp32 cores outside the tensor cores (67 TFLOP/s) the
// same 24.1 GFLOP would take 0.359 ms. The distinct rows read and the
// outputs written are about 20.5 MB, 0.0061 ms at 3.35 TB/s.
//
// Split TF32. TF32 keeps 10 of fp32's 23 fraction bits. Each fp32 operand
// x is split as hi = tf32(x) and lo = tf32(x - hi), each rounded as
// cvt.rna.tf32.f32 does (to nearest, ties away; done with integer ops),
// so x = hi + lo to within 2^-22 |x|, and a product a.b is taken as
// a_lo.b_hi + a_hi.b_lo + a_hi.b_hi (the small terms first), leaving out
// a_lo.b_lo, about 2^-22 |a.b|: the size of fp32's own rounding over a
// few additions. A bf16 value is exactly a TF32 value, so with bf16
// tables h and the pool rows have no lo and their terms are skipped. The
// tensor cores do not round their fp32 sums to nearest, and the error of
// one tensor-core sum over thousands of terms grows with the depth: with
// one such sum over each K chunk, d_center came out 12 times further from
// float64 than the plain fp32 version on the H100 (chip_smoke.py phase 9
// on a copy of this file). So each block sums one stage of 32 k-values in
// a tensor-core accumulator, then adds it to its running fp32 sum with a
// round-to-nearest add: the error stays below the plain version's.
//
// Design: four launches on one stream, from this one source.
//   1. stage: one warp per pair copies h to h_out and takes f_pos, c_pos
//      and the pair's positive loss; one warp per pool row copies that row,
//      upcast, into the fp32 workspace pool32 (S x d).
//   2. pool logits: h . pool32^T, whose epilogue applies the collision
//      mask and the weight, writes c_pool (P x S fp32, a device workspace)
//      and one partial pool loss per pair and 64-column tile.
//   3. grads: d_center's c_pool . pool32 and d_pool's c_pool^T . h in one
//      launch, each output tile's K cut into kSplit chunks of whole
//      stages; chunk 0 lands in the output, the others in the workspace
//      `part`.
//   4. finish: per output entry, the chunks added in chunk order, then
//      c_pos * u added to d_center.
// The TPU kernel keeps c_pool in VMEM and sums d_pool across its sequential
// grid steps in one resident block (:394-399). Hopper blocks run in no
// order, so here every output element (and every chunk of it) has exactly
// one owner block that sums its terms in a fixed order: the result is the
// same on every run (bitwise resume), with no atomics. The c_pool round
// trip through device memory (about 107 MB at full width) is the price of
// that simplicity.
//
// The three products share one core: blocks of 4 warps own 64 x 64 output
// tiles, each warp 32 x 32 of them as 2 x 4 tiles of
// mma.sync.m16n8k8.tf32. Operand tiles of depth 32 come into shared
// memory through a cp.async ring of 3 stages (16-byte copies where rows
// are 16-byte aligned, 4-byte ones otherwise; zero-fill past every edge,
// so any P, S >= 1 and d >= 1 work, and masked pairs add exact zeros).
// Tiles are stored K-contiguous (row stride 36 floats) or M- or
// N-contiguous (row stride 72), as each operand lies in memory, and both
// strides make a warp's fragment reads hit 32 different banks. The
// operands are split into hi and lo as the fragments are read. At full
// width (P = 3,277, S = 4,096, d = 300) and 4 blocks an SM the logits
// run 3,328 blocks, 6.3 waves on 132 SMs; d_center's 260 tiles and
// d_pool's 320 would run 0.49 and 0.61 waves, 2 or 3 blocks on an SM.
// Split in 2 chunks they run 1,160 blocks in one launch, 2.2 waves, which
// took the two products from 0.439 to 0.409 ms with the sum pass; 3 or 4
// chunks were within 1.3 % of that (chip_smoke.py phase 9, H100).
// mma.sync, not wgmma: wgmma reads TF32 operands only K-contiguous from
// shared memory, and d_center's B (pool32 along S) and both operands of
// d_pool (c_pool^T and h along P) are not; it would need transposed
// copies, a second c_pool among them. mma.sync peaks near 317 TFLOP/s of
// TF32 on the H100, 64 % of wgmma's 495 (scripts/torch_mma_rate.py).
// wgmma on transposed operands, and keeping c_pool on chip, are later
// work. Row offsets are 64-bit: id * d passes 2^31 at V = 10,000,000.
// The partial losses are summed by the wrapper in a fixed order.
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

// The product core: 64 x 64 block tiles of 4 warps (2 x 2), each warp
// 32 x 32 outputs as kMT x kNT tiles of m16n8; stages of depth kBK.
constexpr int kThreads = 128;
constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 32;
constexpr int kStages = 3;
constexpr int kMT = 2;
constexpr int kNT = 4;
// Chunks of K that d_center's and d_pool's tiles are split into, so that
// their launch fills the card (fixed: the sums' order depends on the
// shape alone).
constexpr int kSplit = 2;
static_assert(kSplit >= 1, "at least one chunk");
// Row strides in shared memory: a K-contiguous tile is kBM rows of kBK
// values, an M- or N-contiguous one kBK rows of kBM; both take kTile
// floats and keep rows 16-byte aligned.
constexpr int kSldK = kBK + 4;
constexpr int kSldMN = kBM + 8;
constexpr int kTile = kBM * kSldK;
static_assert(kBM == kBN && kBK * kSldMN == kTile, "one tile size");
constexpr int kSmemBytes = kStages * 2 * kTile * 4;

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
// The tensor-core product core
// ----------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copies `bytes` (0 to 16) from src into 16 bytes at dst, zero-filling the
// rest; with 0 nothing is read.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// cvt.rna.tf32.f32 of a finite x below 2^128 (every value here): half a
// TF32 unit added to the magnitude bits, then the 13 low bits cleared,
// which rounds to nearest with ties away from zero, bit for bit. Integer
// adds and ands run at the full ALU rate, faster here than the cvt.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo to within 2^-22 |x|, both TF32; an EXACT operand (copied
// from bf16) is its own hi.
template <bool EXACT>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  if (EXACT) {
    hi = __float_as_uint(x);
    lo = 0u;
  } else {
    hi = tf32_rna(x);
    lo = tf32_rna(x - __uint_as_float(hi));
  }
}

// c += a . b on one 16 x 8 x 8 tile, fp32 accumulator.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Starts copying a ROWS x COLS tile into s (row stride SLD): element
// (r, c) is g[(r0 + r) * ld + c0 + c] where r0 + r < R and c0 + c < C, and
// 0 elsewhere. `vec`: ld is a multiple of 4 and g 16-byte aligned.
template <int ROWS, int COLS, int SLD>
__device__ __forceinline__ void load_tile(float* s, const float* __restrict__ g,
                                          int64_t ld, int64_t R, int64_t C,
                                          int64_t r0, int64_t c0, bool vec) {
  if (vec) {
    constexpr int kChunks = COLS / 4;
    static_assert(ROWS * kChunks % kThreads == 0, "whole rounds");
#pragma unroll
    for (int j = 0; j < ROWS * kChunks / kThreads; ++j) {
      const int i = static_cast<int>(threadIdx.x) + j * kThreads;
      const int r = i / kChunks, c = (i % kChunks) * 4;
      const int64_t gr = r0 + r, gc = c0 + c;
      const float* src = g;
      int bytes = 0;
      if (gr < R && gc < C) {
        src = g + gr * ld + gc;
        bytes = C - gc >= 4 ? 16 : static_cast<int>(C - gc) * 4;
      }
      cp_async16(s + r * SLD + c, src, bytes);
    }
  } else {
    static_assert(ROWS * COLS % kThreads == 0, "whole rounds");
#pragma unroll 4
    for (int j = 0; j < ROWS * COLS / kThreads; ++j) {
      const int i = static_cast<int>(threadIdx.x) + j * kThreads;
      const int r = i / COLS, c = i % COLS;
      const int64_t gr = r0 + r, gc = c0 + c;
      const bool in = gr < R && gc < C;
      cp_async4(s + r * SLD + c, in ? g + gr * ld + gc : g, in ? 4 : 0);
    }
  }
}

// The warp's place in its block tile, and its lane's in the fragments.
struct Lane {
  int wm, wn, g, t;
  __device__ __forceinline__ Lane()
      : wm((static_cast<int>(threadIdx.x) >> 6) * 32),
        wn(((static_cast<int>(threadIdx.x) >> 5) & 1) * 32),
        g((static_cast<int>(threadIdx.x) & 31) >> 2),
        t(static_cast<int>(threadIdx.x) & 3) {}
  // Tile row of accumulator entry i of m-tile mt, and column of entry i
  // of n-tile nt.
  __device__ __forceinline__ int row(int mt, int i) const {
    return wm + mt * 16 + g + 8 * (i >> 1);
  }
  __device__ __forceinline__ int col(int nt, int i) const {
    return wn + nt * 8 + 2 * t + (i & 1);
  }
};

// acc += the product of one stage: A(m, k) is as[m * kSldK + k] when A_K
// (else as[k * kSldMN + m]), B(k, n) is bs[n * kSldK + k] when B_K (else
// bs[k * kSldMN + n]). The stage's 4 steps of depth 8, each its split
// terms small first, go into a tensor-core sum that is then added to acc
// with one round-to-nearest add an entry.
template <bool A_K, bool B_K, bool A_EXACT, bool B_EXACT>
__device__ __forceinline__ void mma_stage(const float* as, const float* bs,
                                          const Lane& ln,
                                          float (&acc)[kMT][kNT][4]) {
  float part[kMT][kNT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) part[mt][nt][i] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < kBK; kk += 8) {
    uint32_t bh[kNT][2], bl[kNT][2];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int n = ln.wn + nt * 8 + ln.g, k = kk + ln.t + 4 * j;
        split<B_EXACT>(B_K ? bs[n * kSldK + k] : bs[k * kSldMN + n], bh[nt][j],
                       bl[nt][j]);
      }
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      uint32_t ah[4], al[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int m = ln.wm + mt * 16 + ln.g + 8 * (j & 1);
        const int k = kk + ln.t + 4 * (j >> 1);
        split<A_EXACT>(A_K ? as[m * kSldK + k] : as[k * kSldMN + m], ah[j],
                       al[j]);
      }
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        if (!A_EXACT) mma(part[mt][nt], al, bh[nt][0], bh[nt][1]);
        if (!B_EXACT) mma(part[mt][nt], ah, bl[nt][0], bl[nt][1]);
        mma(part[mt][nt], ah, bh[nt][0], bh[nt][1]);
      }
    }
  }
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        acc[mt][nt][i] = __fadd_rn(acc[mt][nt][i], part[mt][nt][i]);
}

// The block's tile of C(m, n) = sum_k A(m, k) B(k, n) at rows m0.. and
// columns n0.., over the stages kt0 <= kt < kt1 of depth kBK (k from
// kt0 * kBK), in acc (entries placed as Lane::row and Lane::col say).
// A(m, k) is a[m * lda + k] when A_K, else a[k * lda + m]; B(k, n) is
// b[n * ldb + k] when B_K, else b[k * ldb + n]; va, vb: load_tile's vec.
// k runs in increasing stages; each output's sum has one order. Leaves
// smem free for the epilogue.
template <bool A_K, bool B_K, bool A_EXACT, bool B_EXACT>
__device__ __forceinline__ void product(
    float* smem, const float* __restrict__ a, int64_t lda, bool va,
    const float* __restrict__ b, int64_t ldb, bool vb, int64_t M, int64_t N,
    int64_t K, int64_t m0, int64_t n0, int64_t kt0, int64_t kt1,
    const Lane& ln, float (&acc)[kMT][kNT][4]) {
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.0f;
  auto slot = [&](int64_t kt) { return smem + ((kt - kt0) % kStages) * 2 * kTile; };
  auto load = [&](int64_t kt) {
    float* as = slot(kt);
    float* bs = as + kTile;
    const int64_t k0 = kt * kBK;
    if constexpr (A_K)
      load_tile<kBM, kBK, kSldK>(as, a, lda, M, K, m0, k0, va);
    else
      load_tile<kBK, kBM, kSldMN>(as, a, lda, K, M, k0, m0, va);
    if constexpr (B_K)
      load_tile<kBN, kBK, kSldK>(bs, b, ldb, N, K, n0, k0, vb);
    else
      load_tile<kBK, kBN, kSldMN>(bs, b, ldb, K, N, k0, n0, vb);
  };
  for (int64_t kt = kt0; kt < kt0 + kStages - 1; ++kt) {
    if (kt < kt1) load(kt);
    cp_async_commit();
  }
  for (int64_t kt = kt0; kt < kt1; ++kt) {
    // Stage kt has landed, and every warp is done with stage kt - 1,
    // whose slot the next load takes.
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (kt + kStages - 1 < kt1) load(kt + kStages - 1);
    cp_async_commit();
    const float* as = slot(kt);
    mma_stage<A_K, B_K, A_EXACT, B_EXACT>(as, as + kTile, ln, acc);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// ----------------------------------------------------------------------
// 2. Pool logits, coefficients and pool loss
// ----------------------------------------------------------------------

// f_pool(p, s) = sum_k h[p, k] * pool32[s, k]; EXACT: both copied from
// bf16 rows.
template <bool EXACT>
__global__ void __launch_bounds__(kThreads, 4)
pool_logits_kernel(const float* __restrict__ h, const float* __restrict__ pool32,
                   bool vec, int64_t P, int64_t S, int64_t d,
                   const int32_t* __restrict__ contexts,
                   const float* __restrict__ mask,
                   const int32_t* __restrict__ pool,
                   const float* __restrict__ alpha_p, float w_scale,
                   int64_t n_tiles, float* __restrict__ c_pool,
                   float* __restrict__ loss_part) {
  extern __shared__ __align__(16) float smem[];
  const Lane ln;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x / n_tiles) * kBM;
  const int64_t tn = static_cast<int64_t>(blockIdx.x % n_tiles);
  const int64_t n0 = tn * kBN;
  float acc[kMT][kNT][4];
  product<true, true, EXACT, EXACT>(smem, h, d, vec, pool32, d, vec, P, S, d,
                                    m0, n0, 0, (d + kBK - 1) / kBK, ln, acc);
  const float neg_alpha = -__ldg(alpha_p);
  int32_t pid[kNT][2];
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int64_t s = n0 + ln.col(nt, j);
      pid[nt][j] = s < S ? __ldg(pool + s) : 0;
    }
  const bool pairs = S % 2 == 0;
  float* red = smem;  // [kBM][2] partial losses, by row and warp column
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = ln.row(mt, 2 * half);
      const int64_t p = m0 + r;
      float lsum = 0.0f;
      if (p < P) {
        const float wrow = __ldg(mask + p) * w_scale;
        const int32_t ctx = __ldg(contexts + p);
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          const int64_t s0 = n0 + ln.col(nt, 0);
          float cv[2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            cv[j] = 0.0f;
            if (s0 + j < S) {
              const float f = acc[mt][nt][2 * half + j];
              const float w = pid[nt][j] != ctx ? wrow : 0.0f;
              // sigmoid(f) and -log sigmoid(-f) from one exp(-|f|).
              const float e = expf(-fabsf(f));
              const float sig = f >= 0.0f ? 1.0f / (1.0f + e) : e / (1.0f + e);
              cv[j] = neg_alpha * sig * w;
              lsum += (fmaxf(f, 0.0f) + log1pf(e)) * w;
            }
          }
          float* dst = c_pool + p * S + s0;
          if (pairs && s0 + 1 < S) {
            *reinterpret_cast<float2*>(dst) = make_float2(cv[0], cv[1]);
          } else {
            if (s0 < S) dst[0] = cv[0];
            if (s0 + 1 < S) dst[1] = cv[1];
          }
        }
      }
      // The 4 lanes of a row, in a fixed order.
      lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
      lsum += __shfl_xor_sync(0xffffffffu, lsum, 2);
      if (ln.t == 0) red[r * 2 + (ln.wn >> 5)] = lsum;
    }
  __syncthreads();
  if (threadIdx.x < kBM) {
    const int64_t p = m0 + threadIdx.x;
    if (p < P)
      loss_part[p * n_tiles + tn] = red[2 * threadIdx.x] + red[2 * threadIdx.x + 1];
  }
}

// ----------------------------------------------------------------------
// 3. d_center = c_pos * u + c_pool . pool32 and d_pool = c_pool^T . h
// ----------------------------------------------------------------------

// One launch for both products, grid (d_center's tiles + d_pool's tiles)
// x kSplit: blockIdx.y is the chunk of K (stages split evenly, fixed by
// the shape) whose sum the block takes. Chunk 0 lands in d_center or
// d_pool, chunk c > 0 in part[c - 1] ((P + S) x d: d_center's rows, then
// d_pool's); finish_kernel adds them in chunk order.
template <bool EXACT>
__global__ void __launch_bounds__(kThreads, 4)
grads_kernel(const float* __restrict__ c_pool, bool va,
             const float* __restrict__ pool32, const float* __restrict__ h,
             bool vb, int64_t P, int64_t S, int64_t d, int64_t n_tiles,
             int64_t dc_blocks, float* __restrict__ d_center,
             float* __restrict__ d_pool, float* __restrict__ part) {
  extern __shared__ __align__(16) float smem[];
  const Lane ln;
  const bool dc = static_cast<int64_t>(blockIdx.x) < dc_blocks;
  const int64_t tile = dc ? blockIdx.x : blockIdx.x - dc_blocks;
  const int64_t m0 = tile / n_tiles * kBM;
  const int64_t n0 = tile % n_tiles * kBN;
  const int64_t K = dc ? S : P;
  const int64_t stages = (K + kBK - 1) / kBK;
  const int64_t chunk = blockIdx.y;
  const int64_t kt0 = stages * chunk / kSplit;
  const int64_t kt1 = stages * (chunk + 1) / kSplit;
  float acc[kMT][kNT][4];
  if (dc)
    product<true, false, false, EXACT>(smem, c_pool, S, va, pool32, d, vb, P,
                                       d, S, m0, n0, kt0, kt1, ln, acc);
  else
    product<false, false, false, EXACT>(smem, c_pool, S, va, h, d, vb, S, d,
                                        P, m0, n0, kt0, kt1, ln, acc);
  const int64_t rows = dc ? P : S;
  float* out = dc ? d_center : d_pool;
  if (chunk > 0) out = part + ((chunk - 1) * (P + S) + (dc ? 0 : P)) * d;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t r = m0 + ln.row(mt, i);
      if (r >= rows) continue;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const int64_t c = n0 + ln.col(nt, i);
        if (c < d) out[r * d + c] = acc[mt][nt][i];
      }
    }
}

// 4. The chunks' sums in chunk order, then c_pos * u added to d_center:
// one thread an output entry, d_center's then d_pool's.
template <typename T>
__global__ void __launch_bounds__(kStageThreads)
finish_kernel(const float* __restrict__ part, const T* __restrict__ syn1,
              int64_t stride, const int32_t* __restrict__ contexts,
              const float* __restrict__ c_pos, int64_t P, int64_t S,
              int64_t d, float* __restrict__ d_center,
              float* __restrict__ d_pool) {
  const int64_t n = (P + S) * d;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kStageThreads + threadIdx.x;
  if (i >= n) return;
  const bool dc = i < P * d;
  float* out = dc ? d_center + i : d_pool + (i - P * d);
  float v = *out;
#pragma unroll
  for (int c = 1; c < kSplit; ++c) v = __fadd_rn(v, __ldg(part + (c - 1) * n + i));
  if (dc) {
    const int64_t p = i / d;
    const T* urow = syn1 + static_cast<int64_t>(__ldg(contexts + p)) * stride;
    v = __fadd_rn(__fmul_rn(__ldg(c_pos + p), load_f(urow, i - p * d)), v);
  }
  *out = v;
}

// Rows of `ld` floats from `p` can be copied 16 bytes at a time.
bool vec_rows(const void* p, int64_t ld) {
  return ld % 4 == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Lets `kernel` take kSmemBytes of dynamic shared memory, set once a
// device (the attribute is a constant; the call is a driver round trip).
template <auto kernel>
int allow_smem() {
  constexpr int kDevices = 64;
  static bool done[kDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && (dev >= kDevices || !done[dev])) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
    if (e == cudaSuccess && dev < kDevices) done[dev] = true;
  }
  return static_cast<int>(e);
}

// The launches' grids: the logits' tiles of 64 pool columns (lt), the
// blocks of the logits (lb) and of the products (gx x kSplit), and
// d_center's tiles (dcb) among gx, of which there are nt in a row.
struct Grid {
  int64_t lt, lb, nt, dcb, gx;
};

int grid_of(int64_t P, int64_t S, int64_t d, Grid* g) {
  g->lt = (S + kBN - 1) / kBN;
  g->lb = (P + kBM - 1) / kBM * g->lt;
  g->nt = (d + kBN - 1) / kBN;
  g->dcb = (P + kBM - 1) / kBM * g->nt;
  g->gx = g->dcb + (S + kBM - 1) / kBM * g->nt;
  const bool fits = g->lb <= 0x7fffffff && g->gx <= 0x7fffffff &&
                    (P + S) * d / kStageThreads < 0x7fffffff;
  return fits ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename T>
int launch(const void* syn0, const void* syn1, int64_t stride,
           const void* centers, const void* contexts, const void* mask,
           const void* pool, const void* alpha, int64_t P, int64_t S,
           int64_t d, float w_scale, void* c_pos, void* h, void* d_center,
           void* d_pool, void* loss_pos, void* loss_part, void* pool32,
           void* c_pool, void* part, cudaStream_t s) {
  // bf16 rows copied to fp32 are exact TF32 values: no lo terms for them.
  constexpr bool kExact = sizeof(T) == 2;
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
  float* dcen = static_cast<float*>(d_center);
  float* dpl = static_cast<float*>(d_pool);
  const bool vh = vec_rows(hf, d) && vec_rows(p32, d);
  const bool vc = vec_rows(cpl, S);

  Grid g;
  int rc = grid_of(P, S, d, &g);
  if (rc == cudaSuccess) rc = allow_smem<pool_logits_kernel<kExact>>();
  if (rc == cudaSuccess) rc = allow_smem<grads_kernel<kExact>>();
  if (rc != cudaSuccess) return rc;

  const int64_t pair_blocks = (P + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int64_t stage_blocks = pair_blocks + (S + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (stage_blocks > 0x7fffffff) return cudaErrorInvalidValue;
  stage_kernel<T><<<static_cast<unsigned>(stage_blocks), kStageThreads, 0, s>>>(
      t0, t1, stride, cen, ctx, m, pl, a, P, S, d, pair_blocks, cpos, hf,
      static_cast<float*>(loss_pos), p32);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  pool_logits_kernel<kExact><<<static_cast<unsigned>(g.lb), kThreads, kSmemBytes, s>>>(
      hf, p32, vh, P, S, d, ctx, m, pl, a, w_scale, g.lt, cpl,
      static_cast<float*>(loss_part));
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);

  grads_kernel<kExact><<<dim3(static_cast<unsigned>(g.gx), kSplit), kThreads,
                         kSmemBytes, s>>>(cpl, vc, p32, hf, vh, P, S, d, g.nt,
                                          g.dcb, dcen, dpl,
                                          static_cast<float*>(part));
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);

  const int64_t fb = ((P + S) * d + kStageThreads - 1) / kStageThreads;
  finish_kernel<T><<<static_cast<unsigned>(fb), kStageThreads, 0, s>>>(
      static_cast<const float*>(part), t1, stride, ctx, cpos, P, S, d, dcen, dpl);
  return static_cast<int>(cudaGetLastError());
}

// Blocks an SM holds at once of the logits' and the products' kernels;
// kExact: bf16 tables.
template <bool kExact>
int occupancy(int* logits, int* grads) {
  int rc = allow_smem<pool_logits_kernel<kExact>>();
  if (rc == cudaSuccess) rc = allow_smem<grads_kernel<kExact>>();
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        logits, pool_logits_kernel<kExact>, kThreads, kSmemBytes);
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        grads, grads_kernel<kExact>, kThreads, kSmemBytes);
  return rc;
}

}  // namespace

extern "C" {

// Columns of the per-pair partial pool losses: one per tile of 64 pool
// columns.
int64_t glint_pair_forward_shared_loss_tiles(int64_t S) {
  return (S + kBN - 1) / kBN;
}

// fp32 entries of the workspace `part` that glint_pair_forward_shared
// takes: the products' K chunks past the first.
int64_t glint_pair_forward_shared_part_size(int64_t P, int64_t S, int64_t d) {
  return (kSplit - 1) * (P + S) * d;
}

// The launches of glint_pair_forward_shared for (P, S, d) and `dtype`:
// out[0] the logits' blocks, out[1] the products' blocks, out[2] and
// out[3] the blocks an SM holds at once of each, out[4] the card's SMs
// (blocks / (per SM * SMs) is a launch's number of waves). Returns a
// cudaError_t as an int.
int glint_pair_forward_shared_grid(int64_t P, int64_t S, int64_t d,
                                   int32_t dtype, int64_t* out) {
  Grid g;
  int rc = grid_of(P, S, d, &g);
  int logits = 0, grads = 0, sms = 0, dev = 0;
  if (rc == cudaSuccess && dtype != kDtypeF32 && dtype != kDtypeBF16)
    rc = cudaErrorInvalidValue;
  if (rc == cudaSuccess)
    rc = dtype == kDtypeF32 ? occupancy<false>(&logits, &grads)
                            : occupancy<true>(&logits, &grads);
  if (rc == cudaSuccess) rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess)
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  out[0] = g.lb;
  out[1] = g.gx * kSplit;
  out[2] = logits;
  out[3] = grads;
  out[4] = sms;
  return rc;
}

// Launches the shared-pool forward pass on `stream` and returns the first
// non-zero cudaGetLastError() of its launches as an int (0 = launched).
// syn0/syn1 are [V, stride] of `dtype` (0 = f32, 1 = bf16); centers,
// contexts [P] int32; mask [P] f32; pool [S] int32; alpha a device f32
// scalar; w_scale = n / S rounded to f32. Outputs, contiguous fp32: c_pos
// [P], h [P, d], d_center [P, d], d_pool [S, d], and the loss in two
// parts: loss_pos [P] and loss_part [P, glint_pair_forward_shared_loss_tiles
// (S)], whose entries sum to the loss. Workspaces, contiguous fp32: pool32
// [S, d], c_pool [P, S], part [glint_pair_forward_shared_part_size(P, S,
// d)]. Does not synchronise and allocates nothing.
int glint_pair_forward_shared(const void* syn0, const void* syn1,
                              int64_t stride, int32_t dtype,
                              const void* centers, const void* contexts,
                              const void* mask, const void* pool,
                              const void* alpha, int64_t P, int64_t S,
                              int64_t d, float w_scale, void* c_pos, void* h,
                              void* d_center, void* d_pool, void* loss_pos,
                              void* loss_part, void* pool32, void* c_pool,
                              void* part, void* stream) {
  if (P < 0 || S < 1 || d <= 0 || stride < d) return cudaErrorInvalidValue;
  if (P == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kDtypeF32:
      return launch<float>(syn0, syn1, stride, centers, contexts, mask, pool,
                           alpha, P, S, d, w_scale, c_pos, h, d_center, d_pool,
                           loss_pos, loss_part, pool32, c_pool, part, s);
    case kDtypeBF16:
      return launch<uint16_t>(syn0, syn1, stride, centers, contexts, mask,
                              pool, alpha, P, S, d, w_scale, c_pos, h,
                              d_center, d_pool, loss_pos, loss_part, pool32,
                              c_pool, part, s);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* glint_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
