// Run-summing table scatters for Hopper (sm_90a). Four entry points:
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
// column of a run's table row belongs to exactly one thread (see Design),
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
// coefficient and h row index for the rank-1 forms (16 bytes). A second
// floor no design removes: a run of L updates is, in every column, a
// chain of L dependent adds (rounded, or summed in a fixed order: neither
// may be reassociated or split and stay bitwise), so a call takes at
// least the longest run times one add's latency. At the sizes of one
// training step (N of a few thousand) neither floor is near: the time is
// the launch and a few dependent round trips to device memory.
//
// Design. A run of 32 (kLongRun) or more updates is long: row 0, which
// every padded slot of a batch targets, or a frequent word. Every form is
// two kernels, with the payload (an update row of upd, or a rank-1 update
// coef * h[hidx]) and the policy template parameters: scatter_add_rows_f32
// (B6: rows, fp32 sums), scatter_add_rank1_hbm (B7: rank-1, fp32 sums),
// scatter_add_rows (B3: rows, table dtype) and scatter_add_rank1 (B2:
// rank-1, table dtype).
// - A pre-pass (find_long_runs_kernel), one warp every 32 sorted
//   positions (a long run holds at least one multiple of 32), writes a
//   slot for each multiple p: (first, end) of the long run whose first
//   multiple p is, else (-1, -1). Every slot is written, so the workspace
//   needs no clearing; one round trip reads the ids around p and every
//   32nd id up to p + 1024, and a second one finds the end of a run past
//   p + 32.
// - Then rows_kernel, on a grid fixed from N on the host (no readback),
//   starts with up to 2 blocks an SM that take the items (slot, 8-column
//   slice) in turn, skipping empty slots, followed by one warp per sorted
//   position, which leave long runs alone: the long runs' add chains run
//   beside the short runs, and however many long runs there are, every SM
//   keeps a slot for the short runs. Under the fp32-sum policy and for
//   the rank-1 payload rows_kernel is a programmatic dependent launch: its
//   short runs start while the pre-pass runs, and only its long-run
//   blocks wait for the pre-pass's grid (griddepcontrol.wait).
//   * A long-run block of 256 threads stages the slice's payload rows (32
//     bytes of each update row, or of each update's h row) through a ring
//     of 4 shared-memory chunks of 256 rows with cp.async, 3 chunks in
//     flight, each thread copying one row of a chunk (two 16-byte copies
//     when the rows' stride is a multiple of 4 and the payload 16-byte
//     aligned, else 4-byte ones). Rows of upd come from a permutation
//     entry fetched a chunk ahead; a rank-1 update's h row from its h row
//     index, loaded with its coefficient a chunk ahead from an entry
//     fetched two chunks ahead, and its coefficient goes into a second
//     ring of 4 x 256 floats. Each of the slice's 8 columns is summed by
//     one thread in sorted order, which reads the next 16 staged values
//     into registers (a rank-1 update formed there, the fp32 product of
//     coefficient and h value, off the add chain) while it adds the last
//     16; the row is written once. The fp32-sum policy keeps the sum in
//     fp32 from the row's fp32 value and rounds at the store; under the
//     table-dtype policy on bf16 the thread keeps its sum as bf16 bits and
//     adds with one fma.rn.bf16 (see Chain<uint16_t>: bit for bit the fp32
//     add rounded to bf16). At d = 300 a run has 38 blocks on 38 SMs
//     loading it, so its payload does not set its time.
//   * A short run's warps (short_run_warp) load, in one round trip, the
//     ids and permutation entries of the 32 positions each side of their
//     own, so each knows its run and its offset k in it. Rows payload: a
//     run of one update (most runs) is its warp's: 10 columns a lane, the
//     table and payload values loaded together. A run of L in 2 .. 31 is
//     shared by the warps at its first h = min(L, ceil(d / 32)) positions,
//     warp k taking the 32-column slices k, k + h, ...; each lane loads,
//     32 at a time and before it adds any, the table value and the L
//     updates of each of its columns, so the run takes one round trip for
//     its loads instead of one per few updates. Rank-1 payload: a short
//     run is the warp's at its first position (rank1_warp_run); lane t
//     loads update t's h row index and coefficient while the warp loads
//     the table row, then the updates follow in order, a few h rows in
//     flight (kRank1InFlight), 10 columns a lane.
//   Blocks an SM: 3 under the table-dtype policy (at most 80 registers;
//   B3 at fastText width, a row-0 run of 9,262 beside 22,593 short runs,
//   ran 9 % slower with a fourth block), 4 under the fp32-sum policy (at
//   most 64: B6's and B7's runs are short and their time is round trips;
//   B7's short runs keep two h rows in flight, B2's four).
// In every path each column of a run is one thread's serial sum in sorted
// order, under its policy's rounding, so every path gives the same bits.
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
constexpr unsigned kFull = 0xffffffffu;
// rows_kernel's long-run blocks: kSlice columns an item (32 B of fp32),
// chunks of kChunk update rows (one a thread), a ring of kStages.
constexpr int kSlice = 8;
constexpr int kChunk = 256;
constexpr int kStages = 4;
constexpr int kGroup = 16;  // staged values an adder holds in registers
static_assert(kChunk == kThreads, "a long-run block copies a row a thread");
// rows_kernel keeps at least kRowsBlocksPerSm blocks an SM resident under
// the table-dtype policy (scatter_add_rows and scatter_add_rank1, whose
// row-0 chains of thousands of adds run slower beside more warps) and
// kF32BlocksPerSm under the fp32-sum policy (scatter_add_rows_f32 and
// scatter_add_rank1_hbm, whose runs are short and whose time is the short
// runs' round trips); at most kLongBlocksPerSm of them (per SM of the
// card) take long runs, so that however many long runs a call has, every
// SM keeps a slot for the short runs' warps.
constexpr int kRowsBlocksPerSm = 3;
constexpr int kF32BlocksPerSm = 4;
constexpr int kLongBlocksPerSm = 2;
static_assert(kLongBlocksPerSm < kRowsBlocksPerSm &&
                  kLongBlocksPerSm < kF32BlocksPerSm,
              "long-run blocks must leave the short runs a slot an SM");
// The h rows a rank-1 short run keeps in flight (rank1_warp_run): four
// under the table-dtype policy (B2, within 3 blocks' 80 registers), two
// under the fp32-sum policy (B7, within 4 blocks' 64: four rows at 3
// blocks an SM took 12 % longer; PERF.md §6).
template <bool kRoundEach>
constexpr int kRank1InFlight = kRoundEach ? 4 : 2;

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

// The payload of an update: where its row comes from. A payload names the
// row of update k by a Ref made from src = order[k], and gives the row's
// value in column j. Ref is what a lane holds for the warp and shuffles;
// Staged is what a long-run block keeps in shared memory beside each
// staged row (see long_run_item).

// The rows forms: update k is upd[order[k]], a contiguous row of d fp32.
struct RowsPayload {
  const float* upd;  // [N, d]
  using Ref = int32_t;  // the row of upd, or -1 for none
  struct Staged {};
  static constexpr bool kIndirect = false;  // Ref is src itself
  __device__ __forceinline__ Ref ref(int32_t src) const { return src; }
  static __device__ __forceinline__ bool valid(Ref r) { return r >= 0; }
  static __device__ __forceinline__ Ref shfl(Ref r, int lane) {
    return __shfl_sync(kFull, r, lane);
  }
  __device__ __forceinline__ const float* row(Ref r, int64_t d) const {
    return upd + static_cast<int64_t>(r) * d;
  }
  __device__ __forceinline__ float at(Ref r, int64_t d, int64_t j) const {
    return __ldg(row(r, d) + j);
  }
  // 16-byte copies need every 8-column slice of every row 16-byte aligned.
  __device__ __forceinline__ bool aligned16(int64_t d) const {
    return d % 4 == 0 && (reinterpret_cast<uintptr_t>(upd) & 15) == 0;
  }
  __device__ __forceinline__ void stage(Staged&, int, int, Ref) const {}
  __device__ __forceinline__ float staged(const Staged&, int, int,
                                          float x) const {
    return x;
  }
};

// The rank-1 forms: update k is coef[order[k]] * h[hidx[order[k]]], the
// product rounded to fp32 (__fmul_rn: never fused into the add).
struct Rank1Payload {
  const float* coef;    // [N]
  const float* h;       // [B, h_stride] fp32
  const int32_t* hidx;  // [N]
  int64_t h_stride;
  struct Ref {
    int32_t row;  // the row of h, or -1 for none
    float coef;
  };
  // The coefficients of a long-run block's staged rows.
  struct Staged {
    float coef[kStages][kChunk];
  };
  static constexpr bool kIndirect = true;  // Ref is loaded through src
  __device__ __forceinline__ Ref ref(int32_t src) const {
    return {__ldg(hidx + src), __ldg(coef + src)};
  }
  __device__ __forceinline__ Ref ref_or_none(int32_t src) const {
    return src >= 0 ? ref(src) : Ref{-1, 0.0f};
  }
  static __device__ __forceinline__ bool valid(Ref r) { return r.row >= 0; }
  static __device__ __forceinline__ Ref shfl(Ref r, int lane) {
    return {__shfl_sync(kFull, r.row, lane), __shfl_sync(kFull, r.coef, lane)};
  }
  __device__ __forceinline__ const float* row(Ref r, int64_t) const {
    return h + static_cast<int64_t>(r.row) * h_stride;
  }
  __device__ __forceinline__ float at(Ref r, int64_t d, int64_t j) const {
    return __fmul_rn(r.coef, __ldg(row(r, d) + j));
  }
  __device__ __forceinline__ bool aligned16(int64_t) const {
    return h_stride % 4 == 0 && (reinterpret_cast<uintptr_t>(h) & 15) == 0;
  }
  __device__ __forceinline__ void stage(Staged& st, int stage, int i,
                                        Ref r) const {
    st.coef[stage][i] = r.coef;
  }
  __device__ __forceinline__ float staged(const Staged& st, int stage, int i,
                                          float x) const {
    return __fmul_rn(st.coef[stage][i], x);
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

// A short run of rank-1 updates by one warp: the table row's values, then
// the run's len updates in sorted order under policy kRoundEach, kCols
// columns a lane per pass (one pass for d <= 320). Lane t < len holds
// update t's reference (`mine`), broadcast with shuffles. The h values of
// each full group of kInFlight updates are loaded before the first of them
// is added, so that kInFlight rows are in flight whatever the compiler
// unrolls; the last len % kInFlight updates follow one at a time. (Left to
// `#pragma unroll 4`, the bf16 form compiled to 63 registers and its runs
// of 2 to 31 took 4.8 times as long as fp32's; groups predicated update by
// update took 3.7 times as long in fp32: PERF.md §6.)
template <typename T, bool kRoundEach, int kInFlight>
__device__ __forceinline__ void rank1_warp_run(T* __restrict__ trow,
                                               int64_t d, int len,
                                               const Rank1Payload& pay,
                                               Rank1Payload::Ref mine) {
  const int lane = threadIdx.x & 31;
  for (int64_t c0 = 0; c0 < d; c0 += 32 * kCols) {
    float acc[kCols];
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      const int64_t j = c0 + lane + 32 * i;
      acc[i] = j < d ? load_f(trow, j) : 0.0f;
    }
    int t = 0;
    for (; t + kInFlight <= len; t += kInFlight) {
      float v[kInFlight][kCols];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const Rank1Payload::Ref m = Rank1Payload::shfl(mine, t + u);
#pragma unroll
        for (int i = 0; i < kCols; ++i) {
          const int64_t j = c0 + lane + 32 * i;
          v[u][i] = j < d ? pay.at(m, d, j) : 0.0f;
        }
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
#pragma unroll
        for (int i = 0; i < kCols; ++i) {
          acc[i] = add<T, kRoundEach>(acc[i], v[u][i]);
        }
      }
    }
    for (; t < len; ++t) {
      const Rank1Payload::Ref m = Rank1Payload::shfl(mine, t);
#pragma unroll
      for (int i = 0; i < kCols; ++i) {
        const int64_t j = c0 + lane + 32 * i;
        if (j < d) acc[i] = add<T, kRoundEach>(acc[i], pay.at(m, d, j));
      }
    }
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      const int64_t j = c0 + lane + 32 * i;
      if (j < d) store_f(trow, j, acc[i]);
    }
  }
}

// The run of sorted position w, for the warp at w, under any form (see
// Design): a long run is the long-run blocks'. A short run of L updates
// of a rows form is shared by the warps at its
// first min(L, ceil(d / 32)) positions, warp k taking the 32-column slices
// k, k + h, ...; each lane sums its column of each slice: the table value,
// then the run's updates in sorted order. A rank-1 short run is the warp's
// at its first position.
template <typename T, bool kRoundEach, typename Payload>
__device__ __forceinline__ void short_run_warp(
    T* __restrict__ table, int64_t stride, int64_t d,
    const int32_t* __restrict__ sorted_ids, const int32_t* __restrict__ order,
    int64_t n, const Payload& pay, int64_t w) {
  if (w >= n) return;  // uniform across the warp
  const int lane = threadIdx.x & 31;
  // One round trip: the ids and permutation entries of positions
  // w - 31 .. w (lo, w in lane 31) and w + 1 .. w + 32 (hi); -1 is no id.
  const int64_t plo = w - 31 + lane, phi = w + 1 + lane;
  const int32_t id_lo = plo >= 0 ? __ldg(sorted_ids + plo) : -1;
  const int32_t id_hi = phi < n ? __ldg(sorted_ids + phi) : -1;
  const int32_t src_lo = plo >= 0 ? __ldg(order + plo) : 0;
  const int32_t src_hi = phi < n ? __ldg(order + phi) : 0;
  const int32_t id = __shfl_sync(kFull, id_lo, 31);
  // The run's positions around w are a suffix of lo and a prefix of hi.
  const unsigned lo = __ballot_sync(kFull, id_lo == id);
  const unsigned hi = __ballot_sync(kFull, id_hi == id);
  if (lo == kFull || hi == kFull) return;  // a long run
  const int k = __clz(~lo) - 1;            // w's offset in its run
  const int len = k + __ffs(~hi);          // k + 1 + the ids after w
  if (len >= kLongRun) return;
  if constexpr (Payload::kIndirect) {
    // A rank-1 payload: the run is the warp's at its first position
    // (rank1_warp_run). Split among warps by slices, as below, each value
    // took two shuffles, a multiply and the bookkeeping of a 32-value
    // batch, and B2's runs of 2 to 31 took more than twice as long
    // (PERF.md §6). Lane t asks for update t's h row index and coefficient
    // before the warp asks for the table row, so the two round trips
    // overlap.
    if (k > 0) return;
    const int32_t first = __shfl_sync(kFull, src_lo, 31);
    const int32_t later = __shfl_sync(kFull, src_hi, (lane - 1) & 31);
    rank1_warp_run<T, kRoundEach, kRank1InFlight<kRoundEach>>(
        table + static_cast<int64_t>(id) * stride, d, len, pay,
        pay.ref(lane == 0 ? first : later));
    return;
  }
  const int slices = static_cast<int>((d + 31) / 32);
  const int h = len < slices ? len : slices;
  if (k >= h) return;
  T* trow = table + static_cast<int64_t>(id) * stride;
  if (len == 1) {
    // One update (most runs): kCols columns a lane per pass, its table
    // and payload values loaded together.
    const typename Payload::Ref r = pay.ref(__shfl_sync(kFull, src_lo, 31));
    for (int64_t c0 = 0; c0 < d; c0 += 32 * kCols) {
      float a[kCols], b[kCols];
#pragma unroll
      for (int i = 0; i < kCols; ++i) {
        const int64_t j = c0 + lane + 32 * i;
        a[i] = j < d ? load_f(trow, j) : 0.0f;
        b[i] = j < d ? pay.at(r, d, j) : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < kCols; ++i) {
        const int64_t j = c0 + lane + 32 * i;
        if (j < d) store_f(trow, j, add<T, kRoundEach>(a[i], b[i]));
      }
    }
    return;
  }
  // Lane t holds the payload row of the run's update t (t < len).
  const int32_t from_lo = __shfl_sync(kFull, src_lo, (31 - k + lane) & 31);
  const int32_t from_hi = __shfl_sync(kFull, src_hi, (lane - k - 1) & 31);
  const typename Payload::Ref run_ref =
      pay.ref(lane <= k ? from_lo : from_hi);
  // The lane's values in chain order: for each of the warp's slices the
  // table value, then the len updates; loaded 32 at a time, all before
  // any is added, then summed in order.
  const int per = len + 1;
  const int total = ((slices - 1 - k) / h + 1) * per;
  float acc = 0.0f;
  int li = 0, lt = 0, ci = 0, ct = 0;  // (slice, value) of load and sum
  for (int u0 = 0; u0 < total; u0 += 32) {
    float v[32];
#pragma unroll
    for (int u = 0; u < 32; ++u) {
      const int64_t col = 32 * (k + static_cast<int64_t>(h) * li) + lane;
      const typename Payload::Ref r = Payload::shfl(run_ref, (lt - 1) & 31);
      v[u] = 0.0f;
      if (u0 + u < total && col < d) {
        v[u] = lt == 0 ? load_f(trow, col) : pay.at(r, d, col);
      }
      if (++lt == per) {
        lt = 0;
        ++li;
      }
    }
#pragma unroll
    for (int u = 0; u < 32; ++u) {
      if (u0 + u < total) {
        acc = ct == 0 ? v[u] : add<T, kRoundEach>(acc, v[u]);
        if (ct == per - 1) {
          const int64_t col = 32 * (k + static_cast<int64_t>(h) * ci) + lane;
          if (col < d) store_f(trow, col, acc);
        }
        if (++ct == per) {
          ct = 0;
          ++ci;
        }
      }
    }
  }
}

// The rows forms' pre-pass: one warp a multiple p of kLongRun (= 32)
// below n. Each run of kLongRun or more updates holds a multiple of
// kLongRun among its positions, so slot p / kLongRun gets (first, end) of
// the run whose first multiple p is, if that run is long, else (-1, -1).
// Every slot is written: the workspace needs no clearing.
__global__ void __launch_bounds__(kThreads)
find_long_runs_kernel(const int32_t* __restrict__ sorted_ids, int64_t n,
                      int2* __restrict__ slots) {
  // A rows_kernel launched as its dependant may start now: only its
  // long-run blocks read the slots, and they wait for this grid to finish
  // (griddepcontrol.wait, a no-op in a kernel launched without one).
  asm volatile("griddepcontrol.launch_dependents;");
  const int64_t p = (static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock +
                     (threadIdx.x >> 5)) * kLongRun;
  if (p >= n) return;  // uniform across the warp
  const int lane = threadIdx.x & 31;
  // One round trip: the id at p, the 32 ids before it, the 32 after it,
  // and every 32nd id after it up to p + 1024 (-1 outside [0, n)).
  const int32_t id = __ldg(sorted_ids + p);
  const int64_t back = p - 1 - lane, near = p + 1 + lane,
                far = p + kLongRun * (lane + 1);
  const int32_t id_back = back >= 0 ? __ldg(sorted_ids + back) : -1;
  const int32_t id_near = near < n ? __ldg(sorted_ids + near) : -1;
  const int32_t id_far = far < n ? __ldg(sorted_ids + far) : -1;
  // The ids equal to `id` are a prefix of each set of probes.
  const unsigned before = __ballot_sync(kFull, id_back == id);
  const unsigned after = __ballot_sync(kFull, id_near == id);
  const unsigned ahead = __ballot_sync(kFull, id_far == id);
  int2 run = make_int2(-1, -1);
  // p is the run's first multiple unless p - 32 is in the run too.
  if (before != kFull) {
    const int64_t first = p - (__ffs(~before) - 1);
    int64_t end;
    if (after != kFull) {
      end = p + __ffs(~after);
    } else if (ahead == kFull) {  // past p + 1024: search on
      end = run_end(sorted_ids, n, p + kLongRun * 32, id, lane);
    } else {
      // The run holds p + 32c and ends by p + 32(c + 1): one more probe.
      const int64_t base = p + kLongRun * (__ffs(~ahead) - 1);
      const int64_t q = base + 1 + lane;
      const unsigned m =
          __ballot_sync(kFull, q < n && __ldg(sorted_ids + q) == id);
      end = base + __ffs(~m);
    }
    if (end - first >= kLongRun) {
      run = make_int2(static_cast<int32_t>(first), static_cast<int32_t>(end));
    }
  }
  if (lane == 0) slots[p / kLongRun] = run;
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

// The chain of policy kRoundEach over a table of T: every add rounded to
// T, or an fp32 sum rounded once, at the store.
template <typename T, bool kRoundEach>
struct ChainOf {
  using type = Chain<float>;
};
template <>
struct ChainOf<uint16_t, true> {
  using type = Chain<uint16_t>;
};

// One long-run item: columns [c0, c0 + kSlice) of the run at sorted
// positions [run.x, run.y), by the whole block (see Design). Each thread
// copies one update row of a chunk into the ring (and stages what the
// payload keeps beside it: a rank-1 update's coefficient); the threads of
// the slice's columns (in warp 0) each sum one column.
template <typename T, bool kRoundEach, typename Payload>
__device__ __forceinline__ void long_run_item(
    T* __restrict__ table, int64_t stride, int64_t d,
    const int32_t* __restrict__ sorted_ids, const int32_t* __restrict__ order,
    const Payload& pay, float (*ring)[kChunk][kSlice],
    typename Payload::Staged& staged, bool vec, int2 run, int64_t c0) {
  using Ref = typename Payload::Ref;
  const int tid = threadIdx.x;
  const int64_t first = run.x, end = run.y;
  const int cols = static_cast<int>(min64(kSlice, d - c0));
  const int chunks = static_cast<int>((end - first + kChunk - 1) / kChunk);
  // The permutation entry of row `tid` of chunk c, or -1 past the run.
  auto src_of = [&](int c) -> int32_t {
    const int64_t k = first + static_cast<int64_t>(c) * kChunk + tid;
    return k < end ? __ldg(order + k) : -1;
  };
  // Every thread commits one group a chunk, empty or not, so group c is
  // chunk c in every thread.
  auto issue = [&](int c, Ref r) {
    if (Payload::valid(r)) {
      float* dst = &ring[c % kStages][tid][0];
      const float* p = pay.row(r, d) + c0;
      if (vec) {
        for (int u = 0; u < cols; u += 4) cp_async16(dst + u, p + u);
      } else {
        for (int u = 0; u < cols; ++u) cp_async4(dst + u, p + u);
      }
      pay.stage(staged, c % kStages, tid, r);
    }
    cp_async_commit();
  };
  // The payload reference of the row the next issue copies, and for a
  // kIndirect payload (a rank-1 h row index and coefficient) the entry a
  // chunk further: the index chain is order, then hidx and coef, then the
  // h row, each fetched a chunk before the next link needs it.
  Ref next;
  int32_t src = -1;
  if constexpr (Payload::kIndirect) {
    int32_t s[kStages + 1];
#pragma unroll
    for (int c = 0; c <= kStages; ++c) s[c] = src_of(c);
    Ref r[kStages];
#pragma unroll
    for (int c = 0; c < kStages; ++c) r[c] = pay.ref_or_none(s[c]);
#pragma unroll
    for (int c = 0; c < kStages - 1; ++c) issue(c, r[c]);
    next = r[kStages - 1];
    src = s[kStages];
  } else {
    for (int c = 0; c < kStages - 1; ++c) issue(c, src_of(c));
    next = src_of(kStages - 1);
  }
  T* trow =
      table + static_cast<int64_t>(__ldg(sorted_ids + first)) * stride + c0;
  const bool adder = tid < cols;
  typename ChainOf<T, kRoundEach>::type sum(adder ? load_f(trow, tid) : 0.0f);
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<kStages - 2>();  // chunk c has landed (this thread's)
    // Chunk c is visible to the adders, and every adder is done with
    // chunk c - 1, whose stage the issue below refills.
    __syncthreads();
    issue(c + kStages - 1, next);
    if constexpr (Payload::kIndirect) {
      next = pay.ref_or_none(src);
      src = src_of(c + kStages + 1);
    } else {
      next = src_of(c + kStages);
    }
    if (adder) {
      const int st = c % kStages;
      const float* col = &ring[st][0][tid];
      const int64_t rows = min64(kChunk, end - first - int64_t{c} * kChunk);
      if (rows == kChunk) {
        // Each group of 16 staged values is read into registers (a rank-1
        // update formed there, the product off the add chain) while the
        // group before it is added, so the shared-memory reads stay off
        // the add chain.
        float v[kGroup];
#pragma unroll
        for (int j = 0; j < kGroup; ++j) {
          v[j] = pay.staged(staged, st, j, col[j * kSlice]);
        }
#pragma unroll
        for (int i = kGroup; i < kChunk; i += kGroup) {
          float next_v[kGroup];
#pragma unroll
          for (int j = 0; j < kGroup; ++j) {
            next_v[j] = pay.staged(staged, st, i + j, col[(i + j) * kSlice]);
          }
#pragma unroll
          for (int j = 0; j < kGroup; ++j) {
            sum.push(v[j]);
            v[j] = next_v[j];
          }
        }
#pragma unroll
        for (int j = 0; j < kGroup; ++j) sum.push(v[j]);
      } else {
#pragma unroll 4
        for (int i = 0; i < rows; ++i) {
          sum.push(pay.staged(staged, st, i, col[i * kSlice]));
        }
      }
    }
  }
  if (adder) store_f(trow, tid, sum.value());
  cp_async_wait<0>();
  __syncthreads();  // the ring is free for the next item
}

// The long runs' items w = item0, item0 + step, ... of rows_kernel: item
// w is slot w / slices (see find_long_runs_kernel), 8-column slice
// w % slices; the items whose slot holds a run go to long_run_item.
template <typename T, bool kRoundEach, typename Payload>
__device__ __forceinline__ void long_runs_block(
    T* __restrict__ table, int64_t stride, int64_t d,
    const int32_t* __restrict__ sorted_ids, const int32_t* __restrict__ order,
    const Payload& pay, const int2* __restrict__ slots, int64_t nslots,
    int64_t item0, int64_t step) {
  __shared__ __align__(16) float ring[kStages][kChunk][kSlice];
  __shared__ __align__(16) typename Payload::Staged staged;
  __shared__ int live[kThreads];  // the block's items that hold a run
  __shared__ int nlive;
  const int tid = threadIdx.x;
  const int64_t slices = (d + kSlice - 1) / kSlice;
  const int64_t items = nslots * slices;
  const bool vec = pay.aligned16(d);
  // The block's items come kThreads at a time: thread t reads the slot of
  // item base + t * step, and the items whose slot holds a run are listed
  // (in any order: no two items touch one column).
  for (int64_t base = item0; base < items; base += step * kThreads) {
    if (tid == 0) nlive = 0;
    __syncthreads();
    const int64_t mine = base + static_cast<int64_t>(tid) * step;
    if (mine < items && __ldg(&slots[mine / slices].x) >= 0) {
      live[atomicAdd(&nlive, 1)] = tid;
    }
    __syncthreads();
    const int count = nlive;
    for (int f = 0; f < count; ++f) {
      const int64_t w = base + static_cast<int64_t>(live[f]) * step;
      long_run_item<T, kRoundEach>(table, stride, d, sorted_ids, order, pay,
                                   ring, staged, vec,
                                   __ldg(&slots[w / slices]),
                                   (w % slices) * kSlice);
    }
    __syncthreads();  // every thread has read nlive before it is reset
  }
}

// Every form's scatter kernel, after find_long_runs_kernel: blocks [0,
// long_blocks) take the long runs' items, the others one sorted position a
// warp, so the long runs' add chains run beside the short runs. Three or
// four blocks an SM keep the short runs' warps in flight (at 94 registers
// the bf16 rows form held two, and its short runs ran slower: PERF.md §6).
template <typename T, bool kRoundEach, typename Payload>
__global__ void __launch_bounds__(kThreads,
                                  kRoundEach ? kRowsBlocksPerSm
                                             : kF32BlocksPerSm)
rows_kernel(T* __restrict__ table, int64_t stride, int64_t d,
            const int32_t* __restrict__ sorted_ids,
            const int32_t* __restrict__ order, int64_t n, Payload pay,
            const int2* __restrict__ slots, int64_t long_blocks) {
  if (blockIdx.x < long_blocks) {
    // The slots are find_long_runs_kernel's, which may still be running.
    asm volatile("griddepcontrol.wait;" ::: "memory");
    long_runs_block<T, kRoundEach>(table, stride, d, sorted_ids, order, pay,
                                   slots, (n + kLongRun - 1) / kLongRun,
                                   blockIdx.x, long_blocks);
    return;
  }
  short_run_warp<T, kRoundEach>(
      table, stride, d, sorted_ids, order, n, pay,
      (static_cast<int64_t>(blockIdx.x) - long_blocks) * kWarpsPerBlock +
          (threadIdx.x >> 5));
}

// int32 words of the rows_kernel forms' workspace for n updates: a
// (first, end) slot for each multiple of kLongRun below n.
int64_t rows_workspace_words(int64_t n) {
  return 2 * ((n + kLongRun - 1) / kLongRun);
}

// A form on rows_kernel. Two kernels when a long run can exist
// (n >= kLongRun): find_long_runs_kernel, then rows_kernel; rows_kernel
// alone otherwise.
template <typename T, bool kRoundEach, typename Payload>
int launch_rows(void* table, int64_t stride, int64_t d,
                const void* sorted_ids, const void* order, int64_t n,
                const Payload& pay, void* work, cudaStream_t s) {
  if (n > 0x7fffffff) return cudaErrorInvalidValue;  // int32 positions
  const int32_t* ids = static_cast<const int32_t*>(sorted_ids);
  int2* slots = static_cast<int2*>(work);
  const int64_t blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  int64_t long_blocks = 0;
  if (n >= kLongRun) {
    const int64_t probes = (n + kLongRun - 1) / kLongRun;  // one a warp
    find_long_runs_kernel<<<static_cast<unsigned>(
                                (probes + kWarpsPerBlock - 1) / kWarpsPerBlock),
                            kThreads, 0, s>>>(ids, n, slots);
    cudaError_t e = cudaGetLastError();
    int dev = 0, sms = 0;
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess) {
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (e != cudaSuccess) return static_cast<int>(e);
    // At most n / kLongRun long runs, each ceil(d / kSlice) items.
    long_blocks = min64((n / kLongRun) * ((d + kSlice - 1) / kSlice),
                        int64_t{kLongBlocksPerSm} * sms);
  }
  // A programmatic dependent launch where the short runs set the time
  // (the fp32-sum policy, B6 and B7, and the rank-1 payload, B2): the
  // short runs' warps start while the pre-pass runs, and the long-run
  // blocks wait for it. Not for scatter_add_rows (B3), whose row-0 chain
  // of thousands of adds is its longest path: there the short runs' loads
  // delay the pre-pass, and with it the chain (PERF.md §6).
  cudaLaunchAttribute early;
  early.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  early.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(long_blocks + blocks));
  cfg.blockDim = dim3(kThreads);
  cfg.stream = s;
  cfg.attrs = &early;
  cfg.numAttrs = (!kRoundEach || Payload::kIndirect) && long_blocks > 0 ? 1 : 0;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, rows_kernel<T, kRoundEach, Payload>, static_cast<T*>(table),
      stride, d, ids, static_cast<const int32_t*>(order), n, pay,
      static_cast<const int2*>(slots), long_blocks));
}

// A form on rows_kernel under policy kRoundEach, for the table's `dtype`.
template <bool kRoundEach, typename Payload>
int launch_rows_dtype(void* table, int64_t stride, int64_t d, int32_t dtype,
                      const void* sorted_ids, const void* order, int64_t n,
                      const Payload& pay, void* work, void* stream) {
  if (n < 0 || d <= 0 || stride < d) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kDtypeF32:
      return launch_rows<float, kRoundEach>(table, stride, d, sorted_ids,
                                            order, n, pay, work, s);
    case kDtypeBF16:
      return launch_rows<uint16_t, kRoundEach>(table, stride, d, sorted_ids,
                                               order, n, pay, work, s);
    default:
      return cudaErrorInvalidValue;
  }
}

RowsPayload rows_payload(const void* upd) {
  return RowsPayload{static_cast<const float*>(upd)};
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
// or allocates. `work` is int32 [glint_scatter_add_rows_workspace(n)],
// 8-byte aligned, contents ignored; the call overwrites it.

// fp32-sum policy. upd is [n, d] fp32, contiguous, in input order.
int glint_scatter_add_rows_f32(void* table, int64_t stride, int64_t d,
                               int32_t dtype, const void* sorted_ids,
                               const void* order, int64_t n, const void* upd,
                               void* work, void* stream) {
  return launch_rows_dtype<false>(table, stride, d, dtype, sorted_ids, order,
                                  n, rows_payload(upd), work, stream);
}

// fp32-sum policy. coef [n] fp32 and hidx [n] int32 in input order; h is
// [B, h_stride] fp32 with rows of at least d values.
int glint_scatter_add_rank1(void* table, int64_t stride, int64_t d,
                            int32_t dtype, const void* sorted_ids,
                            const void* order, int64_t n, const void* coef,
                            const void* h, const void* hidx, int64_t h_stride,
                            void* work, void* stream) {
  if (h_stride < d) return cudaErrorInvalidValue;
  return launch_rows_dtype<false>(table, stride, d, dtype, sorted_ids, order,
                                  n, rank1_payload(coef, h, hidx, h_stride),
                                  work, stream);
}

// int32 words of the workspace the rows_kernel forms need for n updates.
int64_t glint_scatter_add_rows_workspace(int64_t n) {
  return rows_workspace_words(n);
}

// Table-dtype policy. upd is [n, d] fp32, contiguous, in input order; each
// update row is rounded to the table's dtype before it is added.
int glint_scatter_add_rows(void* table, int64_t stride, int64_t d,
                           int32_t dtype, const void* sorted_ids,
                           const void* order, int64_t n, const void* upd,
                           void* work, void* stream) {
  return launch_rows_dtype<true>(table, stride, d, dtype, sorted_ids, order,
                                 n, rows_payload(upd), work, stream);
}

// Table-dtype policy, rank-1 payload; coef, h, hidx and h_stride as
// glint_scatter_add_rank1's, work as glint_scatter_add_rows's.
int glint_scatter_add_rank1_table(void* table, int64_t stride, int64_t d,
                                  int32_t dtype, const void* sorted_ids,
                                  const void* order, int64_t n,
                                  const void* coef, const void* h,
                                  const void* hidx, int64_t h_stride,
                                  void* work, void* stream) {
  if (h_stride < d) return cudaErrorInvalidValue;
  return launch_rows_dtype<true>(table, stride, d, dtype, sorted_ids, order,
                                 n, rank1_payload(coef, h, hidx, h_stride),
                                 work, stream);
}

const char* glint_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
