// host_ops: the native host pass of glint_word2vec_torch, its own copy of
// glint_word2vec_tpu/native/host_ops.cpp (entry points, draws and outputs
// unchanged, so the two packages' native passes agree bit for bit), plus
// the ANN build's spill placement (4. below, the port's own).
//
// Four host-side hot spots, each taken over from the interpreter:
//
//   1. alias_build        — O(V) Walker alias-table construction (the
//                           Python two-stack loop takes minutes at a 10M
//                           vocabulary; corpus/alias.py).
//   2. window_batch_epoch — an epoch's subsample and shrunk-window
//                           context/mask rows, thread-parallel across
//                           sentence chunks, the output the same for every
//                           thread count (corpus/batching.py).
//   3. corpus_*           — fit_file's ingestion: the vocabulary count and
//                           the flat encode of a text file
//                           (corpus/vocab.py).
//   4. ann_place_spills   — the ANN build's spilled rows placed one at a
//                           time into their first cluster with space
//                           (ops/ann.py; a stream-trained table spills
//                           most of its rows).
//
// A plain C interface, loaded with ctypes by native/__init__.py, which
// builds it with g++ through kernels/build.py on first use. Every buffer is
// a caller-allocated NumPy array; nothing here allocates Python objects or
// touches the interpreter lock, so callers may release it.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <string_view>
#include <thread>
#include <unordered_map>
#include <vector>

#if defined(__unix__) || defined(__APPLE__)
#define GLINT_HAVE_MMAP 1
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>
#endif

extern "C" {

// Walker/Vose alias table over `weights[0..n)`. Outputs:
//   prob[i]  in [0,1]  — acceptance probability for column i
//   alias[i] in [0,n)  — fallback index for column i
// Matches the Python reference implementation in corpus/alias.py (tested
// for distribution equality). Returns 0 on success, nonzero on bad input.
int alias_build(const double* weights, int64_t n, float* prob, int32_t* alias) {
    if (n <= 0) return 1;
    double total = 0.0;
    for (int64_t i = 0; i < n; ++i) {
        double w = weights[i];
        if (!(w >= 0.0) || w != w) return 2;  // negative or NaN
        total += w;
    }
    if (!(total > 0.0)) return 3;

    std::vector<double> scaled(n);
    const double k = static_cast<double>(n) / total;
    for (int64_t i = 0; i < n; ++i) scaled[i] = weights[i] * k;

    // Two-pointer partition: indices of small (<1) and large (>=1) columns.
    std::vector<int64_t> small, large;
    small.reserve(n);
    large.reserve(n);
    for (int64_t i = 0; i < n; ++i) {
        prob[i] = 1.0f;
        alias[i] = static_cast<int32_t>(i);
        (scaled[i] < 1.0 ? small : large).push_back(i);
    }
    while (!small.empty() && !large.empty()) {
        int64_t s = small.back();
        small.pop_back();
        int64_t l = large.back();
        large.pop_back();
        prob[s] = static_cast<float>(scaled[s]);
        alias[s] = static_cast<int32_t>(l);
        scaled[l] = (scaled[l] + scaled[s]) - 1.0;
        if (scaled[l] < 1.0) small.push_back(l); else large.push_back(l);
    }
    return 0;
}

// xorshift128+ PRNG — fast, well-distributed, deterministic per seed.
struct Rng {
    uint64_t s0, s1;
    explicit Rng(uint64_t seed) {
        // splitmix64 seeding
        auto next = [&seed]() {
            seed += 0x9E3779B97f4A7C15ULL;
            uint64_t z = seed;
            z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
            z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
            return z ^ (z >> 31);
        };
        s0 = next();
        s1 = next();
    }
    inline uint64_t next_u64() {
        uint64_t x = s0;
        const uint64_t y = s1;
        s0 = y;
        x ^= x << 23;
        s1 = x ^ y ^ (x >> 17) ^ (y >> 26);
        return s1 + y;
    }
    // uniform double in [0, 1)
    inline double next_double() {
        return (next_u64() >> 11) * (1.0 / 9007199254740992.0);
    }
    // uniform int in [0, m)
    inline int64_t next_below(int64_t m) {
        return static_cast<int64_t>(next_u64() % static_cast<uint64_t>(m));
    }
};

}  // extern "C"

// One epoch pass over a flattened corpus: frequency subsampling + shrunk-
// window context generation, emitting fixed-width rows. Parallelized
// across sentences with a deterministic two-phase scheme — per-sentence
// PRNG seeds make the output BYTE-IDENTICAL for every thread count
// (phase 1 counts kept rows per sentence chunk, a prefix sum fixes each
// chunk's output offset, phase 2 re-derives the same draws and fills).
//
// Inputs:
//   ids        — concatenated sentence word-indices, int32[total_len]
//   offsets    — sentence boundaries, int64[n_sentences+1]
//   keep_prob  — per-word keep probability, float32[vocab] (all-1 disables)
//   window     — reference windowSize; per position draw b in [0, window)
//                and take offsets [-b, b-1] \ {0} (mllib:384-388)
//   seed       — epoch seed (caller mixes epoch index)
//   threads    — worker count; <=0 picks hardware_concurrency
// Outputs (caller-allocated, capacity rows >= total_len):
//   centers    — int32[capacity]
//   contexts   — int32[capacity * ctx_width]   (ctx_width = 2*window - 3,
//                matching corpus.batching.context_width; zero-padded)
//   mask       — float32[capacity * ctx_width]
// Returns the number of rows written (= number of kept word positions), or
// -1 if capacity was insufficient.

namespace {

inline uint64_t sentence_seed(uint64_t seed, int64_t s) {
    // splitmix64 over (seed, sentence index): independent per-sentence
    // streams, stable across thread counts.
    uint64_t z = seed + 0x9E3779B97f4A7C15ULL * static_cast<uint64_t>(s + 1);
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
    z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
    return z ^ (z >> 31);
}

// Number of kept positions in sentence s (phase-1 counting: consumes the
// same subsample draws phase 2 will).
inline int64_t count_kept(const int32_t* ids, int64_t beg, int64_t end,
                          const float* keep_prob, uint64_t sseed) {
    Rng rng(sseed);
    int64_t kept = 0;
    for (int64_t i = beg; i < end; ++i) {
        const float kp = keep_prob[ids[i]];
        if (kp >= 1.0f || rng.next_double() <= kp) ++kept;
    }
    return kept;
}

// Fill rows for sentence s starting at output row `row`; returns rows
// written. Draw order matches count_kept: all subsample draws first,
// then one b draw per kept position.
inline int64_t fill_sentence(const int32_t* ids, int64_t beg, int64_t end,
                             const float* keep_prob, uint64_t sseed,
                             int64_t W, int64_t C, int64_t row,
                             int32_t* centers, int32_t* contexts,
                             float* mask, std::vector<int32_t>& kept) {
    Rng rng(sseed);
    kept.clear();
    for (int64_t i = beg; i < end; ++i) {
        const int32_t w = ids[i];
        const float kp = keep_prob[w];
        if (kp >= 1.0f || rng.next_double() <= kp) kept.push_back(w);
    }
    const int64_t L = static_cast<int64_t>(kept.size());
    for (int64_t i = 0; i < L; ++i) {
        const int64_t b = (W > 0) ? rng.next_below(W) : 0;  // [0, W)
        centers[row] = kept[static_cast<size_t>(i)];
        int32_t* ctx = contexts + row * C;
        float* m = mask + row * C;
        std::memset(ctx, 0, sizeof(int32_t) * C);
        std::memset(m, 0, sizeof(float) * C);
        // context positions [max(0,i-b), min(i+b,L)) excluding i;
        // lane layout matches corpus.batching.window_offsets:
        // lanes [0, W-1) hold offsets -(W-1)..-1, lanes [W-1, C) hold
        // offsets 1..W-2.
        const int64_t lo = (i - b) > 0 ? (i - b) : 0;
        const int64_t hi = (i + b) < L ? (i + b) : L;
        for (int64_t j = lo; j < hi; ++j) {
            if (j == i) continue;
            const int64_t off = j - i;  // in [-(W-1), W-2], != 0
            const int64_t lane = off < 0 ? off + (W - 1) : (W - 1) + off - 1;
            ctx[lane] = kept[static_cast<size_t>(j)];
            m[lane] = 1.0f;
        }
        ++row;
    }
    return L;
}

}  // namespace

extern "C" {

int64_t window_batch_epoch(
    const int32_t* ids, const int64_t* offsets, int64_t n_sentences,
    const float* keep_prob, int32_t window, uint64_t seed,
    int32_t* centers, int32_t* contexts, float* mask,
    int64_t capacity, int64_t* words_done_out, int32_t threads) {
    const int64_t W = window;
    const int64_t C = (2 * W - 3) > 1 ? (2 * W - 3) : 1;
    int64_t T = threads > 0
                    ? threads
                    : static_cast<int64_t>(std::thread::hardware_concurrency());
    if (T < 1) T = 1;
    if (T > n_sentences) T = n_sentences > 0 ? n_sentences : 1;

    // Contiguous sentence chunks balanced by word count, not sentence
    // count (sentence lengths vary).
    const int64_t total_words = n_sentences > 0 ? offsets[n_sentences] : 0;
    std::vector<int64_t> chunk_begin(T + 1, n_sentences);
    chunk_begin[0] = 0;
    for (int64_t t = 1; t < T; ++t) {
        const int64_t target = total_words * t / T;
        chunk_begin[t] = std::lower_bound(offsets, offsets + n_sentences + 1,
                                          target) -
                         offsets;
        if (chunk_begin[t] > n_sentences) chunk_begin[t] = n_sentences;
        if (chunk_begin[t] < chunk_begin[t - 1])
            chunk_begin[t] = chunk_begin[t - 1];
    }
    chunk_begin[T] = n_sentences;

    // Runs fn(0..T-1): T-1 spawned workers, the last chunk on the caller
    // thread. If pthread creation fails mid-loop (thread rlimit, EAGAIN),
    // the unspawned chunks simply run inline — never std::terminate via
    // a joinable-thread destructor.
    auto run_parallel = [&](auto&& fn) {
        std::vector<std::thread> pool;
        pool.reserve(T > 0 ? T - 1 : 0);
        int64_t spawned = 0;
        try {
            for (int64_t t = 0; t + 1 < T; ++t) {
                pool.emplace_back(fn, t);
                ++spawned;
            }
        } catch (...) {
            // degrade below: chunks [spawned, T) run on this thread
        }
        for (int64_t t = spawned; t < T; ++t) fn(t);
        for (auto& th : pool) th.join();
    };

    // Phase 1: kept-row count per chunk.
    std::vector<int64_t> chunk_rows(T, 0);
    auto count_chunk = [&](int64_t t) {
        int64_t rows = 0;
        for (int64_t s = chunk_begin[t]; s < chunk_begin[t + 1]; ++s)
            rows += count_kept(ids, offsets[s], offsets[s + 1], keep_prob,
                               sentence_seed(seed, s));
        chunk_rows[t] = rows;
    };
    run_parallel(count_chunk);
    std::vector<int64_t> chunk_start(T + 1, 0);
    for (int64_t t = 0; t < T; ++t)
        chunk_start[t + 1] = chunk_start[t] + chunk_rows[t];
    if (chunk_start[T] > capacity) return -1;

    // Phase 2: fill — each chunk writes its own disjoint row range.
    auto fill_chunk = [&](int64_t t) {
        std::vector<int32_t> kept;
        int64_t row = chunk_start[t];
        for (int64_t s = chunk_begin[t]; s < chunk_begin[t + 1]; ++s)
            row += fill_sentence(ids, offsets[s], offsets[s + 1], keep_prob,
                                 sentence_seed(seed, s), W, C, row, centers,
                                 contexts, mask, kept);
    };
    run_parallel(fill_chunk);

    if (words_done_out) *words_done_out = total_words;
    return chunk_start[T];
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Native corpus scanner: the fit_file() ingestion passes (vocab count +
// flat int32 encode) that were the end-to-end wall-clock dominator in pure
// Python (per-token dict lookups measure ~1M words/s; the 50M-word
// fit_file_bench attempt spent ~27 min in host prep). Reference analogue:
// learnVocab's flatMap->reduceByKey (mllib:258-279) and the words->indices
// map (mllib:335-343), which the reference runs on the JVM across a Spark
// cluster; one host feeding a TPU chip needs the same passes at native
// speed on one core.
//
// Tokenization matches Python's text pipeline (iter_text_file /
// encode_file: universal-newline line iteration + str.split()) for every
// valid-UTF-8 corpus: separators are the full str.split() whitespace set
// (ASCII \t-\r, \x1c-\x1f, space, plus Unicode NEL/NBSP/U+1680/
// U+2000-200A/U+2028/U+2029/U+202F/U+205F/U+3000), and a sentence ends at
// '\n' or '\r' ('\r\n' yields one empty extra line, which is dropped —
// exactly universal-newline behavior). Blocks are re-aligned so UTF-8
// sequences never straddle a read boundary. Anything the byte-level pass
// cannot reproduce exactly — invalid UTF-8 (Python decodes with
// errors='replace', merging tokens that differ only in invalid bytes) or
// a requested Unicode-aware lowercase — is NOT handled here: corpus_open
// fails (or the wrapper declines) and the caller falls back to the Python
// path, so the two paths can never silently diverge.
//
// Single-read design: the one counting pass also records the token stream
// as provisional first-seen ids (4 bytes per corpus word, transient), so
// corpus_encode is a hash-free linear remap instead of a second file read
// + 1 hash lookup per word (measured 1.7s/5M words; the remap is ~0.1s).

namespace {

// Single-byte (ASCII) whitespace, the str.split() subset below 0x80.
// Shared by sep_len AND the parallel chunk-boundary search: boundaries
// may only land on bytes BOTH agree are separators, or a token could be
// silently split across chunks.
inline bool is_ascii_ws(unsigned char c) {
    return c == ' ' || (c >= 0x09 && c <= 0x0d) || (c >= 0x1c && c <= 0x1f);
}

// Byte length of the whitespace separator starting at p (sequences are
// block-complete by construction), or 0 if p starts a token byte.
// *line_end_out: '\n' / '\r' — universal-newline sentence boundaries.
inline size_t sep_len(const unsigned char* p, size_t rem,
                      bool* line_end_out) {
    const unsigned char c = p[0];
    *line_end_out = (c == '\n' || c == '\r');
    if (*line_end_out) return 1;
    if (is_ascii_ws(c)) return 1;
    if (c < 0x80) return 0;
    if (c == 0xC2 && rem >= 2 && (p[1] == 0x85 || p[1] == 0xA0))
        return 2;  // U+0085 NEL, U+00A0 NBSP
    if (c == 0xE1 && rem >= 3 && p[1] == 0x9A && p[2] == 0x80)
        return 3;  // U+1680
    if (c == 0xE2 && rem >= 3) {
        if (p[1] == 0x80 && ((p[2] >= 0x80 && p[2] <= 0x8A) ||
                             p[2] == 0xA8 || p[2] == 0xA9 || p[2] == 0xAF))
            return 3;  // U+2000-200A, U+2028, U+2029, U+202F
        if (p[1] == 0x81 && p[2] == 0x9F) return 3;  // U+205F
    }
    if (c == 0xE3 && rem >= 3 && p[1] == 0x80 && p[2] == 0x80)
        return 3;  // U+3000
    return 0;
}

// Strict UTF-8 validity (RFC 3629: no overlongs, no surrogates, <= U+10FFFF).
bool valid_utf8(const char* s, size_t n) {
    const unsigned char* p = reinterpret_cast<const unsigned char*>(s);
    size_t i = 0;
    while (i < n) {
        const unsigned char c = p[i];
        if (c < 0x80) { ++i; continue; }
        size_t len;
        unsigned char lo = 0x80, hi = 0xBF;
        if (c >= 0xC2 && c <= 0xDF) len = 2;
        else if (c == 0xE0) { len = 3; lo = 0xA0; }
        else if (c >= 0xE1 && c <= 0xEC) len = 3;
        else if (c == 0xED) { len = 3; hi = 0x9F; }
        else if (c >= 0xEE && c <= 0xEF) len = 3;
        else if (c == 0xF0) { len = 4; lo = 0x90; }
        else if (c >= 0xF1 && c <= 0xF3) len = 4;
        else if (c == 0xF4) { len = 4; hi = 0x8F; }
        else return false;
        if (i + len > n) return false;
        if (p[i + 1] < lo || p[i + 1] > hi) return false;
        for (size_t k = 2; k < len; ++k)
            if (p[i + k] < 0x80 || p[i + k] > 0xBF) return false;
        i += len;
    }
    return true;
}

// Bytes at the end of [p, p+n) belonging to a possibly-incomplete UTF-8
// sequence, to roll over into the next read block (0..3).
size_t utf8_tail(const char* s, size_t n) {
    if (n == 0) return 0;
    const unsigned char* p = reinterpret_cast<const unsigned char*>(s);
    size_t i = n, back = 0;
    while (i > 0 && back < 3 && (p[i - 1] & 0xC0) == 0x80) { --i; ++back; }
    if (i == 0) return 0;  // all continuation bytes: invalid, caught later
    const unsigned char lead = p[i - 1];
    const size_t len = lead < 0x80 ? 1
                       : lead >= 0xF0 ? 4
                       : lead >= 0xE0 ? 3
                       : lead >= 0xC0 ? 2 : 1;
    const size_t have = n - (i - 1);
    return len > have ? have : 0;
}

struct Ent {
    int64_t count;
    int64_t first;  // first-occurrence order key: the count-desc tiebreak
};

struct Corpus {
    std::string path;
    // Unified post-count vocab store, indexed by gid (assigned in a
    // deterministic first-occurrence order): words[gid] are string_views
    // into `tab` keys (streaming path) or the mmap (parallel path) —
    // both stable for the handle's lifetime.
    std::vector<std::string_view> words;
    std::vector<Ent> ents;
    std::unordered_map<std::string, int64_t> tab;  // streaming byte owner
    char* map_base = nullptr;  // parallel-path byte owner
    size_t map_len = 0;
    // Token stream as gids + raw line lengths, recorded during the
    // counting pass; freed by corpus_encode (one-shot).
    std::vector<int32_t> prov;
    std::vector<int64_t> prov_lens;
    bool prov_consumed = false;
    // Sorted vocab cache for the min_count last queried.
    int64_t cached_min = -1;
    std::vector<int64_t> sorted_gids;
    // Encode results.
    std::vector<int32_t> enc_ids;
    std::vector<int64_t> enc_lens;

    // Every delete path (including the invalid-UTF-8 bail in corpus_open)
    // must release the mapping, so it lives in the destructor.
    ~Corpus() {
#ifdef GLINT_HAVE_MMAP
        if (map_base) munmap(map_base, map_len);
#endif
    }
};

// Streams `path` in ~1 MiB UTF-8-aligned blocks, calling token(ptr, len)
// for each token (never spanning calls; partial tokens carry across block
// boundaries) and line_end() at every '\n'/'\r'. Returns false on open or
// read error, or when token() returns false (abort request).
template <typename TokenFn, typename LineFn>
bool scan_file(const std::string& path, TokenFn&& token, LineFn&& line_end) {
    FILE* f = std::fopen(path.c_str(), "rb");
    if (!f) return false;
    constexpr size_t BLK = 1 << 20;
    std::vector<char> buf(BLK + 4);
    std::string carry;
    size_t pre = 0;  // rolled-over incomplete UTF-8 tail from last block
    auto emit = [&](const char* p, size_t n) -> bool {
        if (carry.empty()) return token(p, n);
        carry.append(p, n);
        bool ok = token(carry.data(), carry.size());
        carry.clear();
        return ok;
    };
    for (;;) {
        const size_t got = std::fread(buf.data() + pre, 1, BLK, f);
        if (got == 0) break;
        size_t avail = pre + got;
        const size_t keep = utf8_tail(buf.data(), avail);
        avail -= keep;
        size_t i = 0;
        while (i < avail) {
            bool is_line;
            const size_t sl = sep_len(
                reinterpret_cast<unsigned char*>(buf.data()) + i, avail - i,
                &is_line);
            if (sl) {
                if (!carry.empty()) {
                    if (!token(carry.data(), carry.size())) {
                        std::fclose(f);
                        return false;
                    }
                    carry.clear();
                }
                if (is_line) line_end();
                i += sl;
                continue;
            }
            size_t j = i;
            bool dummy;
            while (j < avail &&
                   sep_len(reinterpret_cast<unsigned char*>(buf.data()) + j,
                           avail - j, &dummy) == 0)
                ++j;
            if (j < avail) {
                if (!emit(buf.data() + i, j - i)) {
                    std::fclose(f);
                    return false;
                }
            } else {
                carry.append(buf.data() + i, j - i);  // may continue
            }
            i = j;
        }
        std::memmove(buf.data(), buf.data() + avail, keep);
        pre = keep;
    }
    const bool read_error = std::ferror(f) != 0;
    std::fclose(f);
    if (read_error) return false;
    if (pre) carry.append(buf.data(), pre);  // incomplete tail at EOF
    if (!carry.empty() && !token(carry.data(), carry.size())) return false;
    line_end();  // final line without trailing newline
    return true;
}

void ensure_sorted(Corpus* c, int64_t min_count) {
    if (c->cached_min == min_count) return;
    c->sorted_gids.clear();
    c->sorted_gids.reserve(c->ents.size());
    for (int64_t g = 0; g < static_cast<int64_t>(c->ents.size()); ++g) {
        if (c->ents[static_cast<size_t>(g)].count >= min_count)
            c->sorted_gids.push_back(g);
    }
    std::sort(c->sorted_gids.begin(), c->sorted_gids.end(),
              [c](int64_t a, int64_t b) {
                  const Ent& ea = c->ents[static_cast<size_t>(a)];
                  const Ent& eb = c->ents[static_cast<size_t>(b)];
                  if (ea.count != eb.count) return ea.count > eb.count;
                  return ea.first < eb.first;
              });
    c->cached_min = min_count;
}

inline bool token_utf8_ok(const char* p, size_t n) {
    bool ascii = true;
    for (size_t k = 0; k < n; ++k)
        if (static_cast<unsigned char>(p[k]) >= 0x80) {
            ascii = false;
            break;
        }
    return ascii || valid_utf8(p, n);
}

}  // namespace

namespace {

// Streaming (fread-based) counting pass: fills the unified vocab store
// sequentially. Used for small files, threads==1, or when mmap is
// unavailable. Returns false on I/O error or invalid UTF-8.
bool count_streaming(Corpus* c) {
    c->tab.reserve(1 << 20);
    int64_t line_start = 0;
    return scan_file(
        c->path,
        [&](const char* p, size_t n) -> bool {
            if (!token_utf8_ok(p, n)) return false;
            auto [it, inserted] = c->tab.try_emplace(
                std::string(p, n),
                static_cast<int64_t>(c->words.size()));
            const int64_t gid = it->second;
            if (inserted) {
                c->words.emplace_back(it->first);
                c->ents.push_back(Ent{1, gid});
            } else {
                ++c->ents[static_cast<size_t>(gid)].count;
            }
            c->prov.push_back(static_cast<int32_t>(gid));
            return true;
        },
        [&] {
            c->prov_lens.push_back(
                static_cast<int64_t>(c->prov.size()) - line_start);
            line_start = static_cast<int64_t>(c->prov.size());
        });
}

#ifdef GLINT_HAVE_MMAP

// Parallel counting pass over an mmap'd file: contiguous byte chunks
// split at ASCII whitespace (so neither tokens nor multi-byte Unicode
// separators straddle a boundary), each scanned into a chunk-local
// vocab, then a deterministic sequential merge assigns gids in global
// first-occurrence order — the output (words/ents/prov/prov_lens) is
// byte-identical to the streaming pass for every thread count.
struct ChunkScan {
    std::unordered_map<std::string_view, int32_t> lmap;
    std::vector<std::string_view> lwords;
    std::vector<int64_t> lcounts;
    std::vector<int64_t> lfirst;   // chunk-local token index of 1st occur.
    std::vector<int32_t> lprov;    // local ids per token
    std::vector<int64_t> lbreaks;  // local token count at each line end
    bool bad = false;
};

void scan_chunk(const char* base, size_t beg, size_t end, ChunkScan* out) {
    size_t i = beg;
    while (i < end) {
        bool is_line;
        const size_t sl =
            sep_len(reinterpret_cast<const unsigned char*>(base) + i,
                    end - i, &is_line);
        if (sl) {
            if (is_line)
                out->lbreaks.push_back(
                    static_cast<int64_t>(out->lprov.size()));
            i += sl;
            continue;
        }
        size_t j = i;
        bool dummy;
        while (j < end &&
               sep_len(reinterpret_cast<const unsigned char*>(base) + j,
                       end - j, &dummy) == 0)
            ++j;
        if (!token_utf8_ok(base + i, j - i)) {
            out->bad = true;
            return;
        }
        std::string_view w(base + i, j - i);
        auto [it, inserted] = out->lmap.try_emplace(
            w, static_cast<int32_t>(out->lwords.size()));
        const int32_t lid = it->second;
        if (inserted) {
            out->lwords.push_back(w);
            out->lcounts.push_back(1);
            out->lfirst.push_back(
                static_cast<int64_t>(out->lprov.size()));
        } else {
            ++out->lcounts[static_cast<size_t>(lid)];
        }
        out->lprov.push_back(lid);
        i = j;
    }
}

// Returns true on success; false = caller should fall back to streaming
// (mmap failure) — invalid UTF-8 instead reports *invalid=true.
bool count_parallel(Corpus* c, int64_t threads, bool* invalid) {
    int fd = ::open(c->path.c_str(), O_RDONLY);
    if (fd < 0) return false;
    struct stat st;
    if (fstat(fd, &st) != 0 || st.st_size <= 0) {
        ::close(fd);
        return false;
    }
    const size_t n = static_cast<size_t>(st.st_size);
    void* m = mmap(nullptr, n, PROT_READ, MAP_PRIVATE, fd, 0);
    ::close(fd);
    if (m == MAP_FAILED) return false;
    c->map_base = static_cast<char*>(m);
    c->map_len = n;
    const char* base = c->map_base;

    // >=8 MiB per chunk: below that, thread + merge overhead dominates.
    // GLINT_NATIVE_CHUNK_BYTES overrides (tests use a tiny floor so the
    // multi-chunk merge is exercised on small fixtures).
    size_t chunk_floor = 8u << 20;
    if (const char* e = std::getenv("GLINT_NATIVE_CHUNK_BYTES")) {
        char* endp = nullptr;
        const unsigned long long v = std::strtoull(e, &endp, 10);
        if (endp && *endp == '\0' && v > 0) chunk_floor = v;
    }
    int64_t T = threads;
    const int64_t by_size = static_cast<int64_t>(n / chunk_floor) + 1;
    if (T > by_size) T = by_size;
    if (T < 1) T = 1;

    std::vector<size_t> bound(T + 1, n);
    bound[0] = 0;
    for (int64_t t = 1; t < T; ++t) {
        size_t p = n * static_cast<size_t>(t) / static_cast<size_t>(T);
        if (p < bound[t - 1]) p = bound[t - 1];
        while (p < n && !is_ascii_ws(static_cast<unsigned char>(base[p])))
            ++p;
        bound[t] = p;
    }

    std::vector<ChunkScan> chunks(static_cast<size_t>(T));
    {
        std::vector<std::thread> pool;
        pool.reserve(static_cast<size_t>(T > 0 ? T - 1 : 0));
        int64_t spawned = 0;
        try {
            for (int64_t t = 0; t + 1 < T; ++t) {
                pool.emplace_back(scan_chunk, base, bound[t], bound[t + 1],
                                  &chunks[static_cast<size_t>(t)]);
                ++spawned;
            }
        } catch (...) {
        }
        for (int64_t t = spawned; t < T; ++t)
            scan_chunk(base, bound[t], bound[t + 1],
                       &chunks[static_cast<size_t>(t)]);
        for (auto& th : pool) th.join();
    }
    for (const auto& ch : chunks)
        if (ch.bad) {
            *invalid = true;
            return true;  // handled: caller reports invalid UTF-8
        }

    // Chunk token offsets.
    std::vector<int64_t> tok_off(T + 1, 0);
    for (int64_t t = 0; t < T; ++t)
        tok_off[t + 1] =
            tok_off[t] +
            static_cast<int64_t>(chunks[static_cast<size_t>(t)].lprov.size());

    // Deterministic merge: chunks in order, words within a chunk in
    // first-occurrence order -> gids follow global first occurrence.
    std::unordered_map<std::string_view, int64_t> gmap;
    std::vector<std::vector<int32_t>> luts(static_cast<size_t>(T));
    for (int64_t t = 0; t < T; ++t) {
        auto& ch = chunks[static_cast<size_t>(t)];
        auto& lut = luts[static_cast<size_t>(t)];
        lut.resize(ch.lwords.size());
        for (size_t l = 0; l < ch.lwords.size(); ++l) {
            auto [it, inserted] = gmap.try_emplace(
                ch.lwords[l], static_cast<int64_t>(c->words.size()));
            const int64_t gid = it->second;
            if (inserted) {
                c->words.push_back(ch.lwords[l]);
                c->ents.push_back(Ent{ch.lcounts[l],
                                      tok_off[t] + ch.lfirst[l]});
            } else {
                c->ents[static_cast<size_t>(gid)].count += ch.lcounts[l];
            }
            lut[l] = static_cast<int32_t>(gid);
        }
        ch.lmap.clear();
    }

    // Global prov stream: parallel per-chunk remap into disjoint ranges.
    // Each chunk releases its local stream + lut the moment it is
    // remapped, so peak memory stays ~one token stream plus the largest
    // in-flight chunk set, not 2x the corpus.
    c->prov.resize(static_cast<size_t>(tok_off[T]));
    auto remap_chunk = [&](int64_t t) {
        auto& ch = chunks[static_cast<size_t>(t)];
        auto& lut = luts[static_cast<size_t>(t)];
        int32_t* out = c->prov.data() + tok_off[t];
        for (size_t i = 0; i < ch.lprov.size(); ++i)
            out[i] = lut[static_cast<size_t>(ch.lprov[i])];
        std::vector<int32_t>().swap(ch.lprov);
        std::vector<int32_t>().swap(lut);
    };
    {
        std::vector<std::thread> pool;
        pool.reserve(static_cast<size_t>(T > 0 ? T - 1 : 0));
        int64_t spawned = 0;
        try {
            for (int64_t t = 0; t + 1 < T; ++t) {
                pool.emplace_back(remap_chunk, t);
                ++spawned;
            }
        } catch (...) {
        }
        for (int64_t t = spawned; t < T; ++t) remap_chunk(t);
        for (auto& th : pool) th.join();
    }

    // Line lengths: merged break positions + the EOF line end.
    int64_t prev = 0;
    for (int64_t t = 0; t < T; ++t) {
        for (int64_t lb : chunks[static_cast<size_t>(t)].lbreaks) {
            c->prov_lens.push_back(tok_off[t] + lb - prev);
            prev = tok_off[t] + lb;
        }
    }
    c->prov_lens.push_back(tok_off[T] - prev);
    return true;
}

#endif  // GLINT_HAVE_MMAP

}  // namespace

extern "C" {

// Opens `path` and runs the counting pass — thread-parallel over mmap'd
// byte chunks when `threads` allows (output identical to the sequential
// pass for every thread count), streaming otherwise. Returns a handle
// (free with corpus_free), or nullptr if the file can't be read OR
// contains invalid UTF-8 (the caller then uses the Python path, whose
// errors='replace' decode semantics a byte-level pass cannot reproduce).
// threads: <=0 picks hardware_concurrency; 1 forces the streaming pass.
void* corpus_open(const char* path, int32_t threads) {
    auto* c = new Corpus;
    c->path = path;
    int64_t T = threads > 0
                    ? threads
                    : static_cast<int64_t>(
                          std::thread::hardware_concurrency());
    if (T < 1) T = 1;
    bool ok = false;
#ifdef GLINT_HAVE_MMAP
    if (T > 1) {
        bool invalid = false;
        if (count_parallel(c, T, &invalid)) {
            if (invalid) {
                delete c;
                return nullptr;
            }
            return c;
        }
        // mmap unavailable (pipe, empty file, ...): stream instead.
    }
#endif
    ok = count_streaming(c);
    if (!ok) {
        delete c;
        return nullptr;
    }
    return c;
}

int64_t corpus_vocab_size(void* h, int64_t min_count) {
    auto* c = static_cast<Corpus*>(h);
    ensure_sorted(c, min_count);
    return static_cast<int64_t>(c->sorted_gids.size());
}

int64_t corpus_vocab_chars(void* h, int64_t min_count) {
    auto* c = static_cast<Corpus*>(h);
    ensure_sorted(c, min_count);
    int64_t total = 0;
    for (int64_t g : c->sorted_gids)
        total += static_cast<int64_t>(c->words[static_cast<size_t>(g)].size());
    return total;
}

// Fills caller-allocated buffers with the vocab sorted by (count desc,
// first-seen asc): `chars` = concatenated UTF-8 word bytes, `offs`
// (int64[n+1]) word boundaries within it, `counts` (int64[n]).
int corpus_vocab_fill(void* h, int64_t min_count, char* chars, int64_t* offs,
                      int64_t* counts) {
    auto* c = static_cast<Corpus*>(h);
    ensure_sorted(c, min_count);
    int64_t pos = 0, i = 0;
    offs[0] = 0;
    for (int64_t g : c->sorted_gids) {
        const std::string_view w = c->words[static_cast<size_t>(g)];
        std::memcpy(chars + pos, w.data(), w.size());
        pos += static_cast<int64_t>(w.size());
        counts[i] = c->ents[static_cast<size_t>(g)].count;
        offs[++i] = pos;
    }
    return 0;
}

// "Encode" = hash-free linear remap of the recorded provisional-id stream:
// ids become frequency ranks for the given min_count, OOV dropped,
// sentences = lines chunked at max_sentence_length, empty sentences
// dropped. Returns the total id count (query sentence count via
// *n_sentences_out), or -1 on bad input.
//
// ONE-SHOT per handle: the provisional stream (4 B/corpus word) is freed
// here — its last use — so the handle never holds the provisional stream,
// the encode output, and the hashmap at once (fit_file's host-memory
// promise is ~4 B/kept word; keeping all three would triple the peak on
// web-scale corpora). A second call returns -1.
int64_t corpus_encode(void* h, int64_t min_count, int64_t max_sentence_length,
                      int64_t* n_sentences_out) {
    auto* c = static_cast<Corpus*>(h);
    if (max_sentence_length <= 0) return -1;
    if (c->prov_consumed) return -1;
    ensure_sorted(c, min_count);
    // remap[gid] -> frequency rank, or -1 (dropped by min_count).
    std::vector<int32_t> remap(c->words.size(), -1);
    for (size_t i = 0; i < c->sorted_gids.size(); ++i)
        remap[static_cast<size_t>(c->sorted_gids[i])] =
            static_cast<int32_t>(i);
    c->enc_ids.clear();
    c->enc_lens.clear();
    c->enc_ids.reserve(c->prov.size());
    int64_t pos = 0;
    for (int64_t raw_len : c->prov_lens) {
        int64_t kept = 0;
        for (int64_t j = 0; j < raw_len; ++j) {
            int32_t r = remap[static_cast<size_t>(c->prov[pos + j])];
            if (r >= 0) {
                c->enc_ids.push_back(r);
                ++kept;
            }
        }
        pos += raw_len;
        while (kept > 0) {
            int64_t take = std::min(kept, max_sentence_length);
            c->enc_lens.push_back(take);
            kept -= take;
        }
    }
    c->prov_consumed = true;
    std::vector<int32_t>().swap(c->prov);
    std::vector<int64_t>().swap(c->prov_lens);
    if (n_sentences_out)
        *n_sentences_out = static_cast<int64_t>(c->enc_lens.size());
    return static_cast<int64_t>(c->enc_ids.size());
}

// Copies the corpus_encode results into caller-allocated `ids`
// (int32[n_ids]) and sentence offsets `soffs` (int64[n_sentences+1]),
// then frees the internal buffers (one-shot, like corpus_encode): after
// this call the caller's numpy arrays are the only copy.
int corpus_encode_fill(void* h, int32_t* ids, int64_t* soffs) {
    auto* c = static_cast<Corpus*>(h);
    if (!c->enc_ids.empty())
        std::memcpy(ids, c->enc_ids.data(),
                    c->enc_ids.size() * sizeof(int32_t));
    soffs[0] = 0;
    int64_t pos = 0;
    for (size_t i = 0; i < c->enc_lens.size(); ++i) {
        pos += c->enc_lens[i];
        soffs[i + 1] = pos;
    }
    std::vector<int32_t>().swap(c->enc_ids);
    std::vector<int64_t>().swap(c->enc_lens);
    return 0;
}

void corpus_free(void* h) { delete static_cast<Corpus*>(h); }

// Place spilled rows [start, stop) of the ANN build in order: row i takes
// the first cluster of its candidates (cand + (i - start) * K, best
// first) whose fill is below L, into slot fill[c]. Layout arrays are the
// caller's: members and invn (C, L) row-major, fill (C,), cluster_of and
// slot_of indexed by row id. Returns the first row whose K candidates are
// all full (the caller supplies its whole preference order), or stop.
int64_t ann_place_spills(int64_t start, int64_t stop, int64_t K,
                         const int32_t* cand, const int64_t* rid,
                         const int64_t* pos, const float* inv, int64_t L,
                         int64_t* fill, int32_t* members, float* invn,
                         int32_t* cluster_of, int32_t* slot_of) {
    for (int64_t i = start; i < stop; ++i) {
        const int32_t* row = cand + (i - start) * K;
        int64_t k = 0;
        for (; k < K; ++k) {
            const int64_t c = row[k];
            if (fill[c] < L) {
                const int64_t s = fill[c]++;
                members[c * L + s] = static_cast<int32_t>(rid[i]);
                invn[c * L + s] = inv[pos[i]];
                cluster_of[rid[i]] = static_cast<int32_t>(c);
                slot_of[rid[i]] = static_cast<int32_t>(s);
                break;
            }
        }
        if (k == K) return i;
    }
    return stop;
}

}  // extern "C"
