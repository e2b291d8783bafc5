// Run-summing table scatters for Hopper (sm_90a). Four entry points over
// one warp routine (scatter_run_warp):
//   scatter_add_rows_f32   table[ids[k]] += upd[k]               (fp32 upd)
//   scatter_add_rank1_hbm  table[ids[k]] += coef[k] * h[hidx[k]]
//       fp32 run sums, one rounding to the storage dtype per run: the
//       update half of the fused SGNS pair step;
//   scatter_add_rows       table[ids[k]] += upd[k] cast to the table's
//                          dtype                                 (fp32 upd)
//   scatter_add_rank1      table[ids[k]] += (coef[k] * h[hidx[k]]) cast to
//                          the table's dtype
//       runs summed in the table's dtype, one rounding per add: the
//       updates of the composed step (fastText, the host batcher).
//
// Replaces glint_word2vec_tpu/ops/pallas_sgns.py::scatter_add_rows_f32
// (kernels _scatter_rows_f32_kernel and _scatter_runs_f32, :504-639),
// ::scatter_add_rank1_hbm (kernel _scatter_rank1_hbm_kernel, :642-723),
// glint_word2vec_tpu/ops/pallas_rows.py::scatter_add_rows (kernels
// _scatter_kernel and _scatter_runs, :109-196, :275-326) and
// ::scatter_add_rank1 (kernel _scatter_rank1_kernel, :198-272).
//
// The wrapper sorts the ids stably and hands in the sorted ids and the
// permutation (`order`); equal ids then form contiguous runs, and each
// column of a run's table row belongs to exactly one lane (see Design),
// which reads it once, adds the run's updates to it in sorted (= input)
// order and writes it once. The TPU kernels let a run
// span sequential grid steps; on Hopper two blocks holding one run would
// race, so the work is segmented at run starts instead, and no float
// atomics are used: the result is deterministic. The sums use __fadd_rn /
// __fmul_rn so that nvcc contracts nothing into an FMA, and the kernels are
// bitwise equal to their plain versions run on the CPU (index_add_ over the
// sorted ids adds in input order there).
//
// The two contracts differ only under bf16 storage. The fp32-sum policy
// (kRoundEach = false) keeps the run's sum in fp32 and rounds once per run
// (the TPU kernel rounds once per grid block the run spans). The table-dtype
// policy (kRoundEach = true) rounds the update row to the table's dtype and
// every partial sum to it, as the TPU kernel's table-dtype accumulator does:
// under bf16 that is an fp32 add and a round to nearest even per update.
// For fp32 tables both policies are ((row + u0) + u1) + ... in fp32. Every
// payload is fp32: the table-dtype policy rounds each update to the table's
// dtype in the kernel, which is the cast the TPU wrapper makes before its
// kernel (pallas_rows.py:291), with the same result: round to nearest
// even. (bf16 payload rows, read as 2-byte words, made the long-run path
// several times slower on an H100.)
//
// Bound: memory bandwidth. A call must read the payload rows (N x d fp32,
// or the B x d fp32 h of the rank-1 forms), read and write
// each of the R distinct table rows once in storage dtype, and read per
// update its sorted id and permutation entry (8 bytes), plus its
// coefficient and h row index for the rank-1 forms (16 bytes). The
// table-dtype policy adds a second floor that no design removes: a run of
// L updates is, in every column, a chain of L dependent adds (each add
// rounds, so the chain cannot be reassociated or split), so a call takes
// at least the longest run times one add's latency.
//
// Design: one warp per sorted position. Each lane loads one update's
// permutation entry (and coefficient and h row index) and the warp
// broadcasts them with shuffles, so the row loads of consecutive updates do
// not wait on a chain of scalar index loads; the run's end comes from a
// ballot over the next 32 ids, then a galloping search for longer runs.
// - A short run (under kLongRun = 32 updates, almost every run) belongs to
//   the warp at its first position, which keeps up to 10 columns per lane
//   (320 per pass, so d = 300 is one pass) in registers; the other warps
//   exit.
// - A long run (row 0, which every padded slot of a grid batch targets, or
//   a frequent word drawn as a negative many times in one step):
//   * scatter_add_rows (B3) gives it blocks of its own. A pre-pass
//     (find_long_runs_kernel), one warp every 32 sorted positions (a long
//     run holds at least one multiple of 32), appends each
//     long run's (first, end) to a device list through an integer atomic
//     counter; the entries are independent, so their order changes no
//     result. Then rows_kernel, on a grid fixed from N on the host (no
//     readback), starts with up to 2 blocks an SM (of the 3 it keeps
//     resident) that take the items (long run, 8-column slice) in turn,
//     followed by the position warps, which now leave long runs alone:
//     the long runs' add chains run beside the short runs, and however
//     many long runs there are, every SM keeps a slot for the short
//     runs. A long-run block of 256 threads stages the slice's
//     update rows (32 bytes of each) through a ring of 4 shared-memory
//     chunks of 256 rows with cp.async, 3 chunks in flight, each thread
//     copying one row of a chunk (two 16-byte copies when d % 4 == 0 and
//     the payload is 16-byte aligned, else 4-byte ones) from a
//     permutation entry fetched a chunk ahead. Each of the slice's 8
//     columns is summed by one thread in sorted order, which reads the
//     next 16 staged values into registers while it adds the last 16;
//     the row is written once. Under bf16 that thread keeps its sum as
//     bf16 bits and adds with one fma.rn.bf16 (see Chain<uint16_t>: bit
//     for bit the fp32 add rounded to bf16). At d = 300 a run has 38
//     blocks on 38 SMs loading it, so its 11 MB of payload no longer sets
//     its time; the add chain does.
//   * The other three forms share the run among the warps at its first
//     min(ceil(d / 32), 32) positions, each taking 32-column slices of the
//     row; a lane loads its column of 32 updates before adding them in
//     order, so 32 row loads are in flight. The run's length sets their
//     time.
// In every path each column of a run is one thread's serial sum in sorted
// order, one rounding to the table's dtype per add, so every path gives
// the same bits.
// Row offsets are 64-bit: id * d passes 2^31 at V = 10,000,000. bf16 table
// rows are read as 2-byte words, so any row alignment is fine.
//
// Preconditions: sorted_ids is sorted and order is a permutation of
// [0, N) that sorts the ids stably (the wrapper's sort keeps both); every
// id lies in [0, V) (the caller keeps this: no id is range-checked here).
//
// Plain C interface, built by glint_word2vec_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound with ctypes by glint_word2vec_torch/ops/fused_sgns.py (the
// fp32-sum forms) and glint_word2vec_torch/ops/rows.py (the table-dtype
// forms).

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr int kCols = 10;  // columns per lane per pass of a short run
constexpr int kLongRun = 32;  // runs this long or longer are long runs
constexpr int kHelpers = 32;  // at most this many warps share one run
constexpr unsigned kFull = 0xffffffffu;
// scatter_add_rows's long-run blocks: kSlice columns an item (32 B of
// fp32), chunks of kChunk update rows (one a thread), a ring of kStages.
constexpr int kSlice = 8;
constexpr int kChunk = 256;
constexpr int kStages = 4;
constexpr int kGroup = 16;  // staged values an adder holds in registers
static_assert(kChunk == kThreads, "a long-run block copies a row a thread");
// rows_kernel keeps at least kRowsBlocksPerSm blocks an SM resident, and
// gives at most kLongBlocksPerSm of them (per SM of the card) to long
// runs, so that however many long runs a call has, every SM keeps a slot
// for the short runs' warps.
constexpr int kRowsBlocksPerSm = 3;
constexpr int kLongBlocksPerSm = 2;
static_assert(kLongBlocksPerSm < kRowsBlocksPerSm,
              "long-run blocks must leave the short runs a slot an SM");

// The long runs find_long_runs_kernel lists: the count (zeroed before it
// runs), then each run's (first, end) positions.
struct LongRuns {
  int32_t* count;
  int2* list;
};

__host__ __device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

constexpr int32_t kDtypeF32 = 0;
constexpr int32_t kDtypeBF16 = 1;

// Table rows are read with plain loads (the warp writes them back later);
// payload rows, which no launch writes, through the read-only cache
// (__ldg).
__device__ __forceinline__ float load_f(const float* p, int64_t i) {
  return p[i];
}

// bf16 -> fp32 is exact: the bf16 bits are the high half of the fp32 bits.
__device__ __forceinline__ float load_f(const uint16_t* p, int64_t i) {
  return __uint_as_float(static_cast<uint32_t>(p[i]) << 16);
}

__device__ __forceinline__ void store_f(float* p, int64_t i, float v) {
  p[i] = v;
}

// fp32 -> bf16, round to nearest even (what torch's .to(bfloat16) does).
__device__ __forceinline__ void store_f(uint16_t* p, int64_t i, float v) {
  p[i] = __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// The value of `v` rounded to the storage dtype T, as an fp32.
template <typename T>
__device__ __forceinline__ float round_to(float v);

template <>
__device__ __forceinline__ float round_to<float>(float v) {
  return v;
}

template <>
__device__ __forceinline__ float round_to<uint16_t>(float v) {
  return __uint_as_float(
      static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(v)))
      << 16);
}

// Per-update data a lane prefetches for the warp: the source row index and
// a coefficient.
struct Meta {
  int32_t row;
  float coef;
};

// Update k is row order[k] of upd ([N, d] fp32, in input order).
struct RowsPayload {
  const float* upd;
  int64_t d;
  struct Row {
    const float* p;
    __device__ __forceinline__ float at(int64_t j) const { return __ldg(p + j); }
  };
  __device__ __forceinline__ Meta meta(int32_t src) const { return {src, 1.0f}; }
  __device__ __forceinline__ Row row(Meta m) const {
    return {upd + static_cast<int64_t>(m.row) * d};
  }
};

// Update k is coef[order[k]] * h[hidx[order[k]]].
struct Rank1Payload {
  const float* coef;    // [N]
  const float* h;       // [B, h_stride] fp32
  const int32_t* hidx;  // [N]
  int64_t h_stride;
  struct Row {
    const float* p;
    float c;
    __device__ __forceinline__ float at(int64_t j) const {
      return __fmul_rn(c, __ldg(p + j));
    }
  };
  __device__ __forceinline__ Meta meta(int32_t src) const {
    return {__ldg(hidx + src), __ldg(coef + src)};
  }
  __device__ __forceinline__ Row row(Meta m) const {
    return {h + static_cast<int64_t>(m.row) * h_stride, m.coef};
  }
};

// acc + x under the policy: fp32 sums, or every add rounded to T.
template <typename T, bool kRoundEach>
__device__ __forceinline__ float add(float acc, float x) {
  if (kRoundEach) return round_to<T>(__fadd_rn(acc, round_to<T>(x)));
  return __fadd_rn(acc, x);
}

// The end of the run of `id` that holds position `a`: the least e > a with
// e == n or sorted_ids[e] != id. The ids equal to `id` after `a` are a
// prefix, so every probe below is a ballot over a prefix of lanes: first
// the 32 ids after `a` (most runs end there), then, for a longer run,
// lanes probe a + 2^lane and the bracket found is cut 32 ways a round
// (a run of 9,262 takes 5 probes instead of 290).
__device__ __forceinline__ int64_t run_end(const int32_t* __restrict__ ids,
                                           int64_t n, int64_t a, int32_t id,
                                           int lane) {
  const int64_t p = a + 1 + lane;
  unsigned m = __ballot_sync(kFull, p < n && __ldg(ids + p) == id);
  if (m != kFull) return a + __ffs(~m);
  a += 32;  // in the run
  const int64_t q = a + (int64_t{1} << lane);
  m = __ballot_sync(kFull, q < n && __ldg(ids + q) == id);
  const int c = __popc(m);
  int64_t lo = c == 0 ? a : a + (int64_t{1} << (c - 1));  // in the run
  int64_t hi = c == 32 ? n : min64(n, a + (int64_t{1} << c));  // past it
  while (hi - lo > 1) {
    const int64_t step = (hi - lo + 31) / 32;
    const int64_t r = lo + step * (lane + 1);
    m = __ballot_sync(kFull, r < hi && __ldg(ids + r) == id);
    const int64_t in = lo + step * __popc(m);
    hi = min64(hi, in + step);
    lo = in;
  }
  return hi;
}

// The run of sorted position w, for the warp at w (see Design). With
// kDefer (scatter_add_rows) a long run belongs to the long-run blocks,
// which find_long_runs_kernel listed, and only a short run's first warp
// works; otherwise helper warps share a long run.
template <typename T, typename Payload, bool kRoundEach, bool kDefer>
__device__ __forceinline__ void scatter_run_warp(
    T* __restrict__ table, int64_t stride, int64_t d,
    const int32_t* __restrict__ sorted_ids, const int32_t* __restrict__ order,
    int64_t n, const Payload& pay, int64_t w) {
  if (w >= n) return;  // uniform across the warp
  const int lane = threadIdx.x & 31;
  const int32_t id = __ldg(sorted_ids + w);

  // w's offset k in its run, if k < helpers: the ids before w equal to
  // `id` are a prefix of the lanes' probes.
  const int64_t slices = (d + 31) / 32;
  const int helpers =
      kDefer ? 1 : static_cast<int>(slices < kHelpers ? slices : kHelpers);
  const int64_t back = w - 1 - lane;
  const unsigned before = __ballot_sync(
      kFull, lane < helpers && back >= 0 && __ldg(sorted_ids + back) == id);
  if (before == kFull) return;
  const int k = __ffs(~before) - 1;
  if (k >= helpers) return;
  const int64_t s0 = w - k;  // the run's first position
  if (kDefer || k > 0) {
    const int64_t q = s0 + kLongRun - 1;
    const bool long_run = q < n && __ldg(sorted_ids + q) == id;
    // Deferred, a long run is the long-run blocks'; a short run belongs
    // to its first warp alone.
    if (kDefer ? long_run : !long_run) return;
  }
  const int64_t end = run_end(sorted_ids, n, s0, id, lane);
  const int64_t len = end - s0;
  T* trow = table + static_cast<int64_t>(id) * stride;

  if (len < kLongRun) {  // always, when deferring
    // Short run, one warp: kCols columns a lane per pass, the updates in
    // order, each update's row loads issued together.
    Meta mine{0, 0.0f};
    if (lane < len) mine = pay.meta(__ldg(order + s0 + lane));
    const int cnt = static_cast<int>(len);
    for (int64_t c0 = 0; c0 < d; c0 += 32 * kCols) {
      float acc[kCols];
#pragma unroll
      for (int i = 0; i < kCols; ++i) {
        const int64_t j = c0 + lane + 32 * i;
        acc[i] = j < d ? load_f(trow, j) : 0.0f;
      }
#pragma unroll 4
      for (int t = 0; t < cnt; ++t) {
        const Meta m{__shfl_sync(kFull, mine.row, t),
                     __shfl_sync(kFull, mine.coef, t)};
        const typename Payload::Row row = pay.row(m);
#pragma unroll
        for (int i = 0; i < kCols; ++i) {
          const int64_t j = c0 + lane + 32 * i;
          if (j < d) acc[i] = add<T, kRoundEach>(acc[i], row.at(j));
        }
      }
#pragma unroll
      for (int i = 0; i < kCols; ++i) {
        const int64_t j = c0 + lane + 32 * i;
        if (j < d) store_f(trow, j, acc[i]);
      }
    }
    return;
  }

  // Long run: `helpers` warps split the row into 32-column slices (warp k
  // takes slices k, k + helpers, ...), and each walks the whole run for
  // its slice, one column a lane. A lane loads its column of 32 updates
  // before it adds any of them, and the next 32 updates' indices are
  // fetched before the adds: the loads overlap, the adds stay in order.
  for (int64_t s = k; s < slices; s += helpers) {
    const int64_t j = 32 * s + lane;
    const bool col = j < d;
    float acc = col ? load_f(trow, j) : 0.0f;
    Meta mine = pay.meta(__ldg(order + s0 + lane));  // len >= 32
    for (int64_t b = s0; b < end; b += 32) {
      const int cnt = static_cast<int>(end - b < 32 ? end - b : 32);
      float v[32];
#pragma unroll
      for (int t = 0; t < 32; ++t) {
        const Meta m{__shfl_sync(kFull, mine.row, t),
                     __shfl_sync(kFull, mine.coef, t)};
        v[t] = (t < cnt && col) ? pay.row(m).at(j) : 0.0f;
      }
      if (b + 32 + lane < end) mine = pay.meta(__ldg(order + b + 32 + lane));
#pragma unroll
      for (int t = 0; t < 32; ++t) {
        if (t < cnt) acc = add<T, kRoundEach>(acc, v[t]);
      }
    }
    if (col) store_f(trow, j, acc);
  }
}

// The three entry points that share long runs among helper warps.
template <typename T, typename Payload, bool kRoundEach>
__global__ void __launch_bounds__(kThreads)
scatter_runs_kernel(T* __restrict__ table, int64_t stride, int64_t d,
                    const int32_t* __restrict__ sorted_ids,
                    const int32_t* __restrict__ order, int64_t n,
                    Payload pay) {
  scatter_run_warp<T, Payload, kRoundEach, false>(
      table, stride, d, sorted_ids, order, n, pay,
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5));
}

// scatter_add_rows's pre-pass: lists the runs of kLongRun or more updates.
// Each such run holds a multiple of kLongRun (= 32) among its positions,
// so one warp a multiple p suffices: the warp whose p is the run's first
// multiple appends (first, end) to `runs`.
__global__ void __launch_bounds__(kThreads)
find_long_runs_kernel(const int32_t* __restrict__ sorted_ids, int64_t n,
                      LongRuns runs) {
  const int64_t p = (static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock +
                     (threadIdx.x >> 5)) * kLongRun;
  if (p >= n) return;  // uniform across the warp
  const int lane = threadIdx.x & 31;
  const int32_t id = __ldg(sorted_ids + p);
  // p is the run's first multiple unless p - 32 is in the run too.
  if (p >= kLongRun && __ldg(sorted_ids + p - kLongRun) == id) return;
  // The run starts in (p - 32, p]: the ids before p equal to `id` are a
  // prefix of the lanes' probes.
  const int64_t back = p - 1 - lane;
  const unsigned before =
      __ballot_sync(kFull, back >= 0 && __ldg(sorted_ids + back) == id);
  const int64_t first = p - (__ffs(~before) - 1);
  const int64_t end = run_end(sorted_ids, n, p, id, lane);
  if (end - first >= kLongRun && lane == 0) {
    const int32_t i = atomicAdd(runs.count, 1);  // < n / kLongRun
    runs.list[i] =
        make_int2(static_cast<int32_t>(first), static_cast<int32_t>(end));
  }
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// One column's running sum over a long run, in the table's dtype.
template <typename T>
struct Chain;

// fp32: the add helper of every other path.
template <>
struct Chain<float> {
  float acc;
  __device__ __forceinline__ explicit Chain(float row) : acc(row) {}
  __device__ __forceinline__ void push(float x) {
    acc = add<float, true>(acc, x);
  }
  __device__ __forceinline__ float value() const { return acc; }
};

// bf16: the sum kept as bf16 bits, each add one fma.rn.bf16 of the update
// rounded to bf16 (x * 1 + acc, rounded once to bf16). That is bit for bit
// add<uint16_t, true>, an fp32 add rounded to bf16: fp32 keeps 24 bits,
// more than 2 x 8 + 1 of bf16's, and with that margin rounding a sum first
// to fp32 and then to bf16 gives the correctly rounded bf16 sum (S. A.
// Figueroa, "When is double rounding innocuous?", SIGNUM Newsletter 30(3),
// 1995). The chain is one instruction an add instead of an add, a
// conversion and a shift (times in PERF.md §6).
template <>
struct Chain<uint16_t> {
  unsigned short acc;
  __device__ __forceinline__ explicit Chain(float row) {
    acc = static_cast<unsigned short>(__float_as_uint(row) >> 16);
  }
  __device__ __forceinline__ void push(float x) {
    const unsigned short u = __bfloat16_as_ushort(__float2bfloat16_rn(x));
    const unsigned short one = 0x3f80;  // bf16 1.0
    asm("fma.rn.bf16 %0, %1, %2, %3;" : "=h"(acc) : "h"(u), "h"(one), "h"(acc));
  }
  __device__ __forceinline__ float value() const {
    return __uint_as_float(static_cast<uint32_t>(acc) << 16);
  }
};

// The long runs' items w = item0, item0 + step, ... of scatter_add_rows:
// item w is run w / slices, 8-column slice w % slices (see Design). Each of
// the block's threads copies one update row of a chunk into the ring; the
// threads of the slice's columns (in warp 0) each sum one column.
template <typename T>
__device__ __forceinline__ void long_runs_block(
    T* __restrict__ table, int64_t stride, int64_t d,
    const int32_t* __restrict__ sorted_ids, const int32_t* __restrict__ order,
    const float* __restrict__ upd, LongRuns runs, int64_t item0,
    int64_t step) {
  __shared__ __align__(16) float ring[kStages][kChunk][kSlice];
  const int tid = threadIdx.x;
  const int64_t slices = (d + kSlice - 1) / kSlice;
  const int64_t items = static_cast<int64_t>(*runs.count) * slices;
  // 16-byte copies need every slice of every payload row 16-byte aligned.
  const bool vec =
      d % 4 == 0 && (reinterpret_cast<uintptr_t>(upd) & 15) == 0;
  for (int64_t w = item0; w < items; w += step) {
    const int2 run = runs.list[w / slices];
    const int64_t c0 = (w % slices) * kSlice;
    const int cols = static_cast<int>(min64(kSlice, d - c0));
    const int64_t first = run.x, end = run.y;
    const int chunks = static_cast<int>((end - first + kChunk - 1) / kChunk);
    // The payload row of row `tid` of chunk c, or -1 past the run.
    auto src_of = [&](int c) -> int32_t {
      const int64_t k = first + static_cast<int64_t>(c) * kChunk + tid;
      return k < end ? __ldg(order + k) : -1;
    };
    // Every thread commits one group a chunk, empty or not, so group c is
    // chunk c in every thread.
    auto issue = [&](int c, int32_t src) {
      if (src >= 0) {
        float* dst = &ring[c % kStages][tid][0];
        const float* p = upd + static_cast<int64_t>(src) * d + c0;
        if (vec) {
          for (int u = 0; u < cols; u += 4) cp_async16(dst + u, p + u);
        } else {
          for (int u = 0; u < cols; ++u) cp_async4(dst + u, p + u);
        }
      }
      cp_async_commit();
    };
    for (int c = 0; c < kStages - 1; ++c) issue(c, src_of(c));
    int32_t src = src_of(kStages - 1);
    T* trow =
        table + static_cast<int64_t>(__ldg(sorted_ids + first)) * stride + c0;
    const bool adder = tid < cols;
    Chain<T> sum(adder ? load_f(trow, tid) : 0.0f);
    for (int c = 0; c < chunks; ++c) {
      cp_async_wait<kStages - 2>();  // chunk c has landed (this thread's)
      // Chunk c is visible to the adders, and every adder is done with
      // chunk c - 1, whose stage the issue below refills.
      __syncthreads();
      issue(c + kStages - 1, src);
      src = src_of(c + kStages);
      if (adder) {
        const float* col = &ring[c % kStages][0][tid];
        const int64_t rows = min64(kChunk, end - first - int64_t{c} * kChunk);
        if (rows == kChunk) {
          // Each group of 16 staged values is read into registers while
          // the group before it is added, so the shared-memory reads stay
          // off the add chain.
          float v[kGroup];
#pragma unroll
          for (int j = 0; j < kGroup; ++j) v[j] = col[j * kSlice];
#pragma unroll
          for (int i = kGroup; i < kChunk; i += kGroup) {
            float next[kGroup];
#pragma unroll
            for (int j = 0; j < kGroup; ++j) next[j] = col[(i + j) * kSlice];
#pragma unroll
            for (int j = 0; j < kGroup; ++j) {
              sum.push(v[j]);
              v[j] = next[j];
            }
          }
#pragma unroll
          for (int j = 0; j < kGroup; ++j) sum.push(v[j]);
        } else {
#pragma unroll 4
          for (int i = 0; i < rows; ++i) sum.push(col[i * kSlice]);
        }
      }
    }
    if (adder) store_f(trow, tid, sum.value());
    cp_async_wait<0>();
    __syncthreads();  // the ring is free for the next item
  }
}

// scatter_add_rows after find_long_runs_kernel: blocks [0, long_blocks)
// take the long runs' items, the others one sorted position a warp, so
// the long runs' add chains run beside the short runs. Three blocks an SM
// keep the short runs' warps in flight (at 94 registers the bf16 form
// held two, and its short runs ran slower: PERF.md §6).
template <typename T>
__global__ void __launch_bounds__(kThreads, kRowsBlocksPerSm)
rows_kernel(T* __restrict__ table, int64_t stride, int64_t d,
            const int32_t* __restrict__ sorted_ids,
            const int32_t* __restrict__ order, int64_t n,
            const float* __restrict__ upd, LongRuns runs,
            int64_t long_blocks) {
  if (blockIdx.x < long_blocks) {
    long_runs_block<T>(table, stride, d, sorted_ids, order, upd, runs,
                       blockIdx.x, long_blocks);
    return;
  }
  scatter_run_warp<T, RowsPayload, true, true>(
      table, stride, d, sorted_ids, order, n, RowsPayload{upd, d},
      (static_cast<int64_t>(blockIdx.x) - long_blocks) * kWarpsPerBlock +
          (threadIdx.x >> 5));
}

template <typename T, typename Payload, bool kRoundEach>
int launch(void* table, int64_t stride, int64_t d, const void* sorted_ids,
           const void* order, int64_t n, const Payload& pay, cudaStream_t s) {
  if (n < 0 || d <= 0 || stride < d) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const int64_t blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  scatter_runs_kernel<T, Payload, kRoundEach>
      <<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
          static_cast<T*>(table), stride, d,
          static_cast<const int32_t*>(sorted_ids),
          static_cast<const int32_t*>(order), n, pay);
  return static_cast<int>(cudaGetLastError());
}

// The table's storage type for `dtype`, with the launch of `Payload` under
// policy kRoundEach.
template <typename Payload, bool kRoundEach>
int launch_dtype(void* table, int64_t stride, int64_t d, int32_t dtype,
                 const void* sorted_ids, const void* order, int64_t n,
                 const Payload& pay, cudaStream_t s) {
  switch (dtype) {
    case kDtypeF32:
      return launch<float, Payload, kRoundEach>(table, stride, d, sorted_ids,
                                                order, n, pay, s);
    case kDtypeBF16:
      return launch<uint16_t, Payload, kRoundEach>(table, stride, d,
                                                   sorted_ids, order, n, pay,
                                                   s);
    default:
      return cudaErrorInvalidValue;
  }
}

// int32 words of scatter_add_rows's workspace for n updates: the count,
// one word of padding, then (first, end) of at most n / kLongRun runs.
int64_t rows_workspace_words(int64_t n) { return 2 + 2 * (n / kLongRun); }

// scatter_add_rows. Three stream operations when a long run can exist
// (n >= kLongRun): the count's memset, find_long_runs_kernel and
// rows_kernel; rows_kernel alone otherwise.
template <typename T>
int launch_rows(void* table, int64_t stride, int64_t d,
                const void* sorted_ids, const void* order, int64_t n,
                const float* upd, void* work, cudaStream_t s) {
  if (n > 0x7fffffff) return cudaErrorInvalidValue;  // int32 positions
  const int32_t* ids = static_cast<const int32_t*>(sorted_ids);
  int32_t* words = static_cast<int32_t*>(work);
  const LongRuns runs{words, reinterpret_cast<int2*>(words + 2)};
  const int64_t blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int64_t max_runs = n / kLongRun;
  int64_t long_blocks = 0;
  if (max_runs > 0) {
    cudaError_t e = cudaMemsetAsync(words, 0, sizeof(int32_t), s);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int64_t probes = (n + kLongRun - 1) / kLongRun;  // one a warp
    find_long_runs_kernel<<<static_cast<unsigned>(
                                (probes + kWarpsPerBlock - 1) / kWarpsPerBlock),
                            kThreads, 0, s>>>(ids, n, runs);
    e = cudaGetLastError();
    int dev = 0, sms = 0;
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess) {
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (e != cudaSuccess) return static_cast<int>(e);
    long_blocks = min64(max_runs * ((d + kSlice - 1) / kSlice),
                        int64_t{kLongBlocksPerSm} * sms);
  }
  rows_kernel<T><<<static_cast<unsigned>(long_blocks + blocks), kThreads, 0,
                   s>>>(static_cast<T*>(table), stride, d, ids,
                        static_cast<const int32_t*>(order), n, upd, runs,
                        long_blocks);
  return static_cast<int>(cudaGetLastError());
}

Rank1Payload rank1_payload(const void* coef, const void* h, const void* hidx,
                           int64_t h_stride) {
  return Rank1Payload{static_cast<const float*>(coef),
                      static_cast<const float*>(h),
                      static_cast<const int32_t*>(hidx), h_stride};
}

}  // namespace

extern "C" {

// Every entry launches on `stream` and returns cudaGetLastError() as an int
// (0 = launched). `table` is [V, stride] of `dtype` (0 = f32, 1 = bf16),
// updated in place; sorted_ids and order are [n] int32. None synchronises
// or allocates.

// fp32-sum policy. upd is [n, d] fp32, contiguous, in input order.
int glint_scatter_add_rows_f32(void* table, int64_t stride, int64_t d,
                               int32_t dtype, const void* sorted_ids,
                               const void* order, int64_t n, const void* upd,
                               void* stream) {
  const RowsPayload pay{static_cast<const float*>(upd), d};
  return launch_dtype<RowsPayload, false>(
      table, stride, d, dtype, sorted_ids, order, n, pay,
      static_cast<cudaStream_t>(stream));
}

// fp32-sum policy. coef [n] fp32 and hidx [n] int32 in input order; h is
// [B, h_stride] fp32 with rows of at least d values.
int glint_scatter_add_rank1(void* table, int64_t stride, int64_t d,
                            int32_t dtype, const void* sorted_ids,
                            const void* order, int64_t n, const void* coef,
                            const void* h, const void* hidx, int64_t h_stride,
                            void* stream) {
  if (h_stride < d) return cudaErrorInvalidValue;
  return launch_dtype<Rank1Payload, false>(
      table, stride, d, dtype, sorted_ids, order, n,
      rank1_payload(coef, h, hidx, h_stride),
      static_cast<cudaStream_t>(stream));
}

// int32 words of the workspace glint_scatter_add_rows needs for n updates.
int64_t glint_scatter_add_rows_workspace(int64_t n) {
  return rows_workspace_words(n);
}

// Table-dtype policy. upd is [n, d] fp32, contiguous, in input order; each
// update row is rounded to the table's dtype before it is added. work is
// int32 [glint_scatter_add_rows_workspace(n)], 8-byte aligned, contents
// ignored; the call overwrites it.
int glint_scatter_add_rows(void* table, int64_t stride, int64_t d,
                           int32_t dtype, const void* sorted_ids,
                           const void* order, int64_t n, const void* upd,
                           void* work, void* stream) {
  if (n < 0 || d <= 0 || stride < d) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const float* u = static_cast<const float*>(upd);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kDtypeF32:
      return launch_rows<float>(table, stride, d, sorted_ids, order, n, u,
                                work, s);
    case kDtypeBF16:
      return launch_rows<uint16_t>(table, stride, d, sorted_ids, order, n, u,
                                   work, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// Table-dtype policy, rank-1 payload; arguments as glint_scatter_add_rank1.
int glint_scatter_add_rank1_table(void* table, int64_t stride, int64_t d,
                                  int32_t dtype, const void* sorted_ids,
                                  const void* order, int64_t n,
                                  const void* coef, const void* h,
                                  const void* hidx, int64_t h_stride,
                                  void* stream) {
  if (h_stride < d) return cudaErrorInvalidValue;
  return launch_dtype<Rank1Payload, true>(
      table, stride, d, dtype, sorted_ids, order, n,
      rank1_payload(coef, h, hidx, h_stride),
      static_cast<cudaStream_t>(stream));
}

const char* glint_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
