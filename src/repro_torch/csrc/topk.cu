// Row-wise top-k for Hopper (sm_90a) under jax.lax.top_k's rule: the k
// largest entries of each row, ordered (value desc, index asc), with
// int64 indices. It serves every top-k of the port: the sparse top-k and
// the fuse top-k over (B, n_docs) rows, the Stage-II budget, Stage-I
// sort-by-distance, the centroid neighbour graph and the recsys guide,
// fuse and brute-force top-ks over one 1M-long row.
//
// Replaces topk_pallas (src/repro/kernels/topk/kernel.py, _topk_kernel).
// The TPU kernel streamed a row through VMEM in tiles and carried a
// (k,)-sized running best across the sequential tile axis of its grid.
// A CUDA grid has no sequential axis, so each row is cut into C chunks
// that are selected in parallel and then merged:
//
//   keys: each float maps to an order-preserving uint32 (sign set: all
//   bits flipped; else the sign bit set). The map is a bijection and its
//   order is the total order lax.top_k uses: -0.0 ranks below +0.0, and
//   ties are exact bit equality. NaN is out of contract. An entry's
//   composite (~key << 32 | index) is unique, and ascending composites
//   are (value desc, index asc).
//
//   phase A, one CTA per (row, chunk): the chunk is copied from device
//   memory into shared memory once, by bulk asynchronous copies
//   (cp.async.bulk, one mbarrier per 16 KB stage; the unaligned head and
//   tail words of an odd row stride by plain loads), and a radix
//   histogram of key bits 31..21 runs on each stage as it lands. It gives
//   the bin of the chunk's k'-th key, k' = min(k, chunk length). One
//   filter pass over shared memory then keeps every key of a higher bin
//   and collects that bin's few slots; the rest of the select (bits
//   20..10, 9..0) runs on the collected slots only. A bin of only exact
//   zeros (the fused and sparse rows) needs no refining: the nonzeros
//   above are kept and the lowest-indexed zeros found by a short walk in
//   index order. Exactly k' entries are kept. With C == 1 they are sorted
//   and written out (one launch); with C > 1 their keys and indices go to
//   a (B, C, k'') scratch (k'' = k' rounded up to 4, padded with key 0).
//
//   phase B (C > 1), one CTA per row: the row's top k composites lie in
//   the union of its chunks' top k' (composites are unique), so the same
//   select over the row's C * k'' scratch keys (staged in shared memory
//   by bulk copies) keeps its k; ties at the cut go by least stored index.
//   The k kept are sorted by a bucketed rank sort and written out.
//
// The passes are bound by instructions per entry, so a chunk's keys are
// read from shared memory at most twice after the copy, exact zeros are
// counted in a register per thread rather than by shared atomics on one
// bin, and the few kept entries are appended by shared atomics.
//
// What bounds it on the H100: bytes. Its least work reads each row once
// and writes k values and indices: at (256, 2^20) rows and k 1000 that is
// 1.07 GB, 0.32 ms at 3.35 TB/s. Phase A reads each row once; the
// scratch adds 8 bytes written and 4 read per kept entry (47 chunks of
// 22K at (256, 2^20), 0.14 GB). With many rows a chunk holds at most 22K
// floats (kPrefWords), so that two CTAs share an SM and one's copy
// overlaps the other's passes; with few rows chunks of up to 44K fill
// the card, so a B = 1 row of 1M entries runs on tens of SMs, not one.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMinBlocks = 2;                 // at most 64 registers
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 2048;
constexpr int kHistBins = 2048;
constexpr int kHistBytes = kHistBins * 4;
constexpr int kStageBytes = 16384;            // one bulk copy, one mbarrier
constexpr int kStageUnits = kStageBytes / 16;
constexpr int kMaxStages = 12;
constexpr int kMaxWords = 45056;   // a chunk's words (176 KB)
// with many rows, a chunk's words at most: two CTAs then share an SM
constexpr int kPrefWords = 22528;
// with few rows, a row's scratch keys at most, while more chunks would
// only fill the card
constexpr int kMergeKeys = 32768;
constexpr int kMaxMergeWords = kMaxStages * kStageBytes / 4;  // 49152
constexpr int kMergeCandCap = 8192;
// dynamic shared memory a block may take: the H100's 227 KB less what
// the kernels declare statically
constexpr int kSmemBytes = 232448 - 1024;
constexpr int kCandCap = 2048;     // candidate slots of the k-th key's bin
constexpr uint32_t kZeroKey = 0x80000000u;     // the key of +0.0
constexpr int kHavePass1 = -1, kNoPass1 = -2;  // radix_cut's `first`

__device__ __forceinline__ uint32_t fkey(uint32_t b) {
  // sign set: flip all bits; else set the sign bit (a shift and a LOP3)
  return b ^ ((uint32_t)((int32_t)b >> 31) | 0x80000000u);
}

__device__ __forceinline__ float fval(uint32_t key) {
  return __uint_as_float((key & 0x80000000u) ? (key ^ 0x80000000u) : ~key);
}

// ascending composite order = (key desc, index asc)
__device__ __forceinline__ unsigned long long composite(uint32_t key,
                                                        uint32_t idx) {
  return ((unsigned long long)(~key) << 32) | idx;
}

// ---- bulk copies into shared memory, completed on mbarriers

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx"
               "::bytes [%0], [%1], %2, [%3];\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(bytes),
                  "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar) {
  uint32_t done = 0;
  while (!done) {
    asm volatile("{\n .reg .pred p;\n"
                 " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
                 " selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(smem_addr(bar)) : "memory");
  }
}

// Words [0, len) of `src` land at dst[pad + i], with pad chosen so that
// src's 16-byte-aligned middle lands 16-byte aligned. Units are the
// float4-sized groups dst[4u .. 4u + 3], u < nu; the middle's units
// arrive in stages (stage s: units mid_u0 + s * kStageUnits ...), the
// head and tail units are loaded by plain loads and visible after the
// block-wide sync inside.
struct Staged {
  int pad, mid_u0, mid_units, nu, stages;
};

__device__ Staged stage_begin(uint32_t* dst, const uint32_t* src, int len,
                              uint64_t* bars) {
  Staged s;
  int head = (int)(((16u - (uint32_t)(reinterpret_cast<uintptr_t>(src)
                                      & 15u)) & 15u) >> 2);
  if (head > len) head = len;
  const int mid = ((len - head) >> 2) << 2;
  s.pad = (4 - head) & 3;
  s.mid_u0 = (s.pad + head) >> 2;
  s.mid_units = mid >> 2;
  s.nu = (s.pad + len + 3) >> 2;
  s.stages = (mid * 4 + kStageBytes - 1) / kStageBytes;
  const int tid = threadIdx.x;
  if (tid < head) dst[s.pad + tid] = src[tid];
  const int tail0 = head + mid;
  if (tid < len - tail0) dst[s.pad + tail0 + tid] = src[tail0 + tid];
  if (tid == 0) {
    for (int i = 0; i < s.stages; ++i) mbar_init(&bars[i]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    const int bytes = mid * 4;
    for (int i = 0; i < s.stages; ++i) {
      const int off = i * kStageBytes;
      const int nb = bytes - off < kStageBytes ? bytes - off : kStageBytes;
      bulk_load(reinterpret_cast<char*>(dst + s.pad + head) + off,
                reinterpret_cast<const char*>(src + head) + off,
                (uint32_t)nb, &bars[i]);
    }
  }
  return s;
}

// ---- radix select over units of four keys
//
// A source is read through load(u, key, ok), the four keys of unit u and
// their validity, loadf(u, key) where all four are valid, and
// keyat(slot), the key at slot 4u + e.

// Histogram of ((key >> shift) & mask) over the valid keys whose bits
// above pshift equal prefix (all keys when pshift is 32); exact zeros
// are counted in `zeros` instead (flush_zeros adds them).
template <class Load>
__device__ __forceinline__ void hist_units(Load& load, int u0, int u1,
                                           uint32_t* hist, int shift,
                                           uint32_t mask, int pshift,
                                           uint32_t prefix,
                                           uint32_t& zeros) {
  for (int u = u0 + (int)threadIdx.x; u < u1; u += kThreads) {
    uint32_t key[4];
    bool ok[4];
    load(u, key, ok);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (!ok[e]) continue;
      if (pshift < 32 && (key[e] >> pshift) != prefix) continue;
      if (key[e] == kZeroKey) {
        ++zeros;
        continue;
      }
      atomicAdd(&hist[(key[e] >> shift) & mask], 1u);
    }
  }
}

// hist_units over units whose four keys are all valid: loadf(u, key).
template <class LoadF>
__device__ __forceinline__ void hist_full(LoadF& loadf, int u0, int u1,
                                          uint32_t* hist, uint32_t& zeros) {
#pragma unroll 2
  for (int u = u0 + (int)threadIdx.x; u < u1; u += kThreads) {
    uint32_t key[4];
    loadf(u, key);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (key[e] == kZeroKey) ++zeros;
      else atomicAdd(&hist[key[e] >> 21], 1u);
    }
  }
}

__device__ __forceinline__ void clear_hist(uint32_t* hist) {
  for (int i = threadIdx.x; i < kHistBins; i += kThreads) hist[i] = 0;
}

__device__ __forceinline__ void flush_zeros(uint32_t* hist, uint32_t zeros,
                                            int shift, uint32_t mask,
                                            int pshift, uint32_t prefix) {
  if (zeros && (pshift >= 32 || (kZeroKey >> pshift) == prefix))
    atomicAdd(&hist[(kZeroKey >> shift) & mask], zeros);
}

struct Shared {
  uint64_t bars[kMaxStages];
  int bin;
  uint32_t above, zeros, ncand, nout, tie_base, lo, hi;
  uint32_t ws[kWarps];
};

// The largest bin d with sum_{j >= d} hist[j] >= need -> sh.bin, and
// sum_{j > d} hist[j] -> sh.above. Needs 1 <= need <= the histogram's
// total; each thread sums nbins / kThreads bins, a block scan finds the
// one thread whose bins hold d. The block syncs after.
__device__ void select_bin(const uint32_t* hist, int nbins, uint32_t need,
                           Shared& sh) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int per = nbins / kThreads;
  const int hi = nbins - per * t;                  // thread 0: the top bins
  const int lo = hi - per;
  uint32_t s = 0;
  for (int j = lo; j < hi; ++j) s += hist[j];
  uint32_t incl = s;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  if (lane == 31) sh.ws[warp] = incl;
  __syncthreads();
  uint32_t acc = incl - s;
  for (int w = 0; w < warp; ++w) acc += sh.ws[w];
  if (acc < need && need <= acc + s) {
    for (int j = hi - 1; j >= lo; --j) {
      const uint32_t h = hist[j];
      if (acc + h >= need) {
        sh.bin = j;
        sh.above = acc;
        break;
      }
      acc += h;
    }
  }
  __syncthreads();
}

// The cut that keeps the kk largest valid keys of a source: every key >
// *thr and the first *room of the *nties keys equal to *thr. Radix passes
// over key bits 31..21, 20..10 and 9..0, each skipped once a bin is
// taken whole (then *room = 0). `first`: kHavePass1 when `hist` holds
// the first pass on entry, kNoPass1 to run it, or the bits 31..21 that
// every valid key shares (the first pass is then skipped).
template <class Load>
__device__ void radix_cut(Load& load, int nu, uint32_t* hist, uint32_t kk,
                          int first, Shared& sh, uint32_t* thr,
                          uint32_t* room, uint32_t* nties) {
  uint32_t zeros = 0;
  *nties = 0;
  uint32_t d1, need1;
  if (first >= 0) {                 // every key's bits 31..21 are `first`
    d1 = (uint32_t)first;
    need1 = kk;
  } else {
    if (first == kNoPass1) {
      __syncthreads();
      clear_hist(hist);
      __syncthreads();
      hist_units(load, 0, nu, hist, 21, 2047u, 32, 0u, zeros);
      flush_zeros(hist, zeros, 21, 2047u, 32, 0u);
      __syncthreads();
    }
    select_bin(hist, 2048, kk, sh);
    d1 = (uint32_t)sh.bin;
    need1 = kk - sh.above;
    if (d1 > 0 && hist[d1] == need1) {
      *thr = (d1 << 21) - 1u;
      *room = 0;
      return;
    }
  }
  __syncthreads();
  zeros = 0;
  clear_hist(hist);
  __syncthreads();
  hist_units(load, 0, nu, hist, 10, 2047u, 21, d1, zeros);
  flush_zeros(hist, zeros, 10, 2047u, 21, d1);
  __syncthreads();
  select_bin(hist, 2048, need1, sh);
  const uint32_t p21 = (d1 << 11) | (uint32_t)sh.bin;
  const uint32_t need2 = need1 - sh.above;
  if (p21 > 0 && hist[sh.bin] == need2) {
    *thr = (p21 << 10) - 1u;
    *room = 0;
    return;
  }
  __syncthreads();
  zeros = 0;
  clear_hist(hist);
  __syncthreads();
  hist_units(load, 0, nu, hist, 0, 1023u, 10, p21, zeros);
  flush_zeros(hist, zeros, 0, 1023u, 10, p21);
  __syncthreads();
  select_bin(hist, 1024, need2, sh);
  *thr = (p21 << 10) | (uint32_t)sh.bin;
  *room = need2 - sh.above;
  *nties = hist[sh.bin];
}

// Keeps the kk largest valid keys of a source: calls put(pos, key, slot)
// once for each, pos in [0, kk), in no particular order. The ties at the
// cut are the ones of least order(slot) (the row index: the slot itself
// in phase A, the stored global index in phase B).
//
// On entry `hist` holds the first pass (key bits 31..21) and sh.zeros the
// count of exact +0.0 keys. Then:
//   the k-th key's bin taken whole: one filter pass;
//   the k-th key's bin holds only exact zeros (a fused or sparse row):
//     a filter pass keeps the nonzeros above, and the zero ties;
//   the k-th key's bin holds at most cand_cap keys: a filter pass keeps
//     the higher bins and collects that bin's slots, over which the rest
//     of the select runs;
//   else: two radix passes over the source find the cut, a filter pass.
// Ties beyond what the cut takes are chosen by order(slot): all of them
// when they all fit; a tile walk in slot order when order is the slot
// (`ordered`) and the bin is large; else a radix select over ~order.
template <bool kOrdered, class Load, class LoadF, class KeyAt, class Order,
          class Put>
__device__ void keep_top(Load& load, LoadF& loadf, int uf_lo, int uf_hi,
                         KeyAt& keyat, Order& order, int nu, uint32_t* hist,
                         uint32_t* cand, uint32_t cand_cap, uint32_t kk,
                         Shared& sh, Put& put) {
  const int lane = threadIdx.x & 31;
  select_bin(hist, 2048, kk, sh);
  const uint32_t d1 = (uint32_t)sh.bin;
  const uint32_t need1 = kk - sh.above;
  const uint32_t in_bin = hist[d1];
  // cut: keep key > thr, and `room` of the keys == thr; collect: gather
  // bin d1's slots in the filter pass
  uint32_t thr, room = 0;
  bool collect = false;
  if (d1 > 0 && in_bin == need1) {
    thr = (d1 << 21) - 1u;
  } else if (d1 == (kZeroKey >> 21) && in_bin == sh.zeros) {
    thr = kZeroKey;
    room = need1;
    if (room == in_bin) {                            // every zero is kept
      thr = kZeroKey - 1u;
      room = 0;
    }
  } else if (in_bin <= cand_cap) {
    thr = d1 == 2047u ? 0xffffffffu : ((d1 + 1u) << 21) - 1u;
    collect = true;
  } else {
    uint32_t nt;
    radix_cut(load, nu, hist, kk, kHavePass1, sh, &thr, &room, &nt);
    if (room > 0 && room == nt && thr > 0) {         // every tie is kept
      --thr;
      room = 0;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    sh.nout = 0;
    sh.ncand = 0;
  }
  __syncthreads();
  // filter pass: keys above thr out, bin d1's slots collected; the units
  // [uf_lo, uf_hi) are whole, the few others are checked
  auto filter = [&](int u, const uint32_t (&key)[4], const bool (&ok)[4]) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (!ok[e]) continue;
      if (key[e] > thr) put(atomicAdd(&sh.nout, 1u), key[e], 4 * u + e);
      else if (collect && (key[e] >> 21) == d1)
        cand[atomicAdd(&sh.ncand, 1u)] = 4 * u + e;
    }
  };
  const bool all[4] = {true, true, true, true};
#pragma unroll 2
  for (int u = uf_lo + (int)threadIdx.x; u < uf_hi; u += kThreads) {
    uint32_t key[4];
    loadf(u, key);
    filter(u, key, all);
  }
  for (int u = (int)threadIdx.x; u < nu; u += kThreads) {
    if (u >= uf_lo && u < uf_hi) continue;
    uint32_t key[4];
    bool ok[4];
    load(u, key, ok);
    filter(u, key, ok);
  }
  __syncthreads();
  const uint32_t ncand = sh.ncand;
  if (collect) {
    // the cut inside bin d1, over its collected slots
    auto cload = [&](int u, uint32_t (&key)[4], bool (&ok)[4]) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        ok[e] = (uint32_t)(4 * u + e) < ncand;
        key[e] = ok[e] ? keyat((int)cand[4 * u + e]) : 0u;
      }
    };
    const int ncu = (int)(ncand + 3) / 4;
    uint32_t cthr, croom, cnt;
    radix_cut(cload, ncu, hist, need1, (int)d1, sh, &cthr, &croom, &cnt);
    const bool all_ties = croom > 0 && croom == cnt;
    for (int i = threadIdx.x; i < (int)ncand; i += kThreads) {
      const int slot = (int)cand[i];
      const uint32_t key = keyat(slot);
      if (key > cthr || (all_ties && key == cthr))
        put(atomicAdd(&sh.nout, 1u), key, slot);
    }
    if (all_ties) croom = 0;
    thr = cthr;
    room = croom;
    // ties among the collected slots: the `room` of least order
    if (room > 0) {
      auto tload = [&](int u, uint32_t (&key)[4], bool (&ok)[4]) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool in = (uint32_t)(4 * u + e) < ncand;
          const int slot = in ? (int)cand[4 * u + e] : 0;
          ok[e] = in && keyat(slot) == cthr;
          key[e] = ok[e] ? ~order(slot) : 0u;
        }
      };
      uint32_t othr, oroom, ont;
      radix_cut(tload, ncu, hist, room, kNoPass1, sh, &othr, &oroom, &ont);
      __syncthreads();
      for (int i = threadIdx.x; i < (int)ncand; i += kThreads) {
        const int slot = (int)cand[i];
        if (keyat(slot) != cthr) continue;
        const uint32_t o = ~order(slot);
        if (o > othr || (o == othr && oroom > 0))
          put(atomicAdd(&sh.nout, 1u), cthr, slot);
      }
    }
  } else if (room > 0) {
    if (kOrdered) {
      // the first `room` ties in slot order: tiles of kThreads units,
      // a block scan of each thread's count, until `room` are placed
      const uint32_t n_above = kk - room;
      if (threadIdx.x == 0) sh.tie_base = 0;
      __syncthreads();
      for (int b = 0; b < nu; b += kThreads) {
        const int u = b + (int)threadIdx.x;
        uint32_t key[4];
        bool ok[4] = {false, false, false, false};
        if (u < nu) load(u, key, ok);
        uint32_t mine = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e) mine += (ok[e] && key[e] == thr) ? 1u : 0u;
        uint32_t incl = mine;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const uint32_t v = __shfl_up_sync(0xffffffffu, incl, off);
          if (lane >= off) incl += v;
        }
        if (lane == 31) sh.ws[threadIdx.x >> 5] = incl;
        __syncthreads();
        uint32_t rank = sh.tie_base + incl - mine;
        for (int w = 0; w < (int)(threadIdx.x >> 5); ++w) rank += sh.ws[w];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (ok[e] && key[e] == thr) {
            if (rank < room) put(n_above + rank, thr, 4 * u + e);
            ++rank;
          }
        }
        __syncthreads();
        if (threadIdx.x == 0) {
          uint32_t tot = 0;
          for (int w = 0; w < kWarps; ++w) tot += sh.ws[w];
          sh.tie_base += tot;
        }
        __syncthreads();
        if (sh.tie_base >= room) break;
      }
    } else {
      // the `room` ties of least order: a radix select over ~order
      auto tload = [&](int u, uint32_t (&key)[4], bool (&ok)[4]) {
        load(u, key, ok);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ok[e] = ok[e] && key[e] == thr;
          key[e] = ok[e] ? ~order(4 * u + e) : 0u;
        }
      };
      uint32_t othr, oroom, ont;
      radix_cut(tload, nu, hist, room, kNoPass1, sh, &othr, &oroom, &ont);
      __syncthreads();
      for (int b = (int)threadIdx.x; b < nu; b += kThreads) {
        uint32_t key[4];
        bool ok[4];
        load(b, key, ok);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (!ok[e] || key[e] != thr) continue;
          const uint32_t o = ~order(4 * b + e);
          if (o > othr || (o == othr && oroom > 0))
            put(atomicAdd(&sh.nout, 1u), thr, 4 * b + e);
        }
      }
    }
  }
  __syncthreads();
}

// Writes the n = k (<= kMaxK) composites of buf, sorted ascending, as row r's
// values and indices. A bucketed rank sort: the composites' high words
// (~key) are cut into 2048 buckets over their range; a histogram, a
// block scan and a scatter group them by bucket in tmp; each composite's
// position is its bucket's offset plus the count of smaller composites
// in its bucket. Each thread holds at most kMaxK / kThreads of them.
__device__ void sort_and_write(const unsigned long long* buf,
                               unsigned long long* tmp, uint32_t* cnt,
                               int n, long long r, float* vals, int64_t* idx,
                               Shared& sh) {
  // n == k: row r's outputs are vals[r * n ...], idx[r * n ...]
  constexpr int kPer = kMaxK / kThreads;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  if (t == 0) {
    sh.lo = 0xffffffffu;
    sh.hi = 0u;
  }
  clear_hist(cnt);
  __syncthreads();
  unsigned long long c[kPer];
  uint32_t lo = 0xffffffffu, hi = 0u;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = t + j * kThreads;
    c[j] = i < n ? buf[i] : 0ull;
    const uint32_t h = (uint32_t)(c[j] >> 32);
    if (i < n) {
      lo = min(lo, h);
      hi = max(hi, h);
    }
  }
  atomicMin(&sh.lo, lo);
  atomicMax(&sh.hi, hi);
  __syncthreads();
  lo = sh.lo;
  const uint32_t span = sh.hi - lo;
  const int sh_bits = span < (uint32_t)kHistBins ? 0 : (32 - __clz(span)) - 11;
  uint32_t bin[kPer], rank[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    bin[j] = (uint32_t)((c[j] >> 32) - lo) >> sh_bits;
    if (t + j * kThreads < n) rank[j] = atomicAdd(&cnt[bin[j]], 1u);
  }
  __syncthreads();
  // exclusive scan of the bucket sizes, in place: cnt[b] = offset of b
  constexpr int kBins = kHistBins / kThreads;
  uint32_t sz[kBins], sum = 0;
#pragma unroll
  for (int q = 0; q < kBins; ++q) {
    sz[q] = cnt[kBins * t + q];
    sum += sz[q];
  }
  uint32_t incl = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  if (lane == 31) sh.ws[warp] = incl;
  __syncthreads();
  uint32_t base = incl - sum;
  for (int w = 0; w < warp; ++w) base += sh.ws[w];
#pragma unroll
  for (int q = 0; q < kBins; ++q) {
    cnt[kBins * t + q] = base;
    base += sz[q];
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    if (t + j * kThreads < n) tmp[cnt[bin[j]] + rank[j]] = c[j];
  }
  __syncthreads();
  float* vo = vals + r * n;
  int64_t* io = idx + r * n;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    if (t + j * kThreads >= n) continue;
    const uint32_t b0 = cnt[bin[j]];
    const uint32_t b1 = bin[j] + 1 < (uint32_t)kHistBins ? cnt[bin[j] + 1]
                                                         : (uint32_t)n;
    uint32_t pos = b0;
    for (uint32_t q = b0; q < b1; ++q) pos += tmp[q] < c[j] ? 1u : 0u;
    io[pos] = (int64_t)(uint32_t)(c[j] & 0xffffffffu);
    vo[pos] = fval(~(uint32_t)(c[j] >> 32));
  }
}

__host__ __device__ __forceinline__ int buf_bytes(int n) {
  return (n * 8 + 15) / 16 * 16;
}

constexpr int kFixedBytes = kHistBytes + kCandCap * 4;   // hist | cand

// Phase B's words between buf and cand: the staged keys, at least the
// 2 k words the sort's scratch takes after them.
__host__ __device__ __forceinline__ long long merge_key_words(long long n,
                                                              int k,
                                                              bool staged) {
  const long long need = 2LL * k;
  return staged && n > need ? n : need;
}

// Phase A. Grid (B, C); dynamic shared memory: hist | cand | buf and the
// sort's tmp (C == 1) | the chunk (L + 8 words).
__global__ void __launch_bounds__(kThreads, kMinBlocks)
topk_chunk_kernel(const float* __restrict__ x, long long row_stride, int D,
                  int k, int L, int kstride, float* __restrict__ vals,
                  int64_t* __restrict__ idx, uint32_t* __restrict__ skeys,
                  uint32_t* __restrict__ sidx) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Shared sh;
  const int C = gridDim.y;
  const long long r = blockIdx.x;
  const int c = blockIdx.y;
  const int start = c * L;
  const int len = min(L, D - start);
  const int kc = min(k, len);
  uint32_t* hist = reinterpret_cast<uint32_t*>(smem);
  uint32_t* cand = reinterpret_cast<uint32_t*>(smem + kHistBytes);
  unsigned long long* buf =
      reinterpret_cast<unsigned long long*>(smem + kFixedBytes);
  unsigned long long* tmp = reinterpret_cast<unsigned long long*>(
      smem + kFixedBytes + buf_bytes(kc));
  uint32_t* xs = reinterpret_cast<uint32_t*>(
      smem + kFixedBytes + (C == 1 ? 2 * buf_bytes(kc) : 0));
  const uint32_t* src =
      reinterpret_cast<const uint32_t*>(x + r * row_stride + start);

  clear_hist(hist);
  if (threadIdx.x == 0) sh.zeros = 0;
  const Staged st = stage_begin(xs, src, len, sh.bars);
  const uint4* xs4 = reinterpret_cast<const uint4*>(xs);
  const int lo = st.pad;
  const uint32_t ulen = (uint32_t)len;
  auto load = [&](int u, uint32_t (&key)[4], bool (&ok)[4]) {
    const uint4 v = xs4[u];
    key[0] = fkey(v.x);
    key[1] = fkey(v.y);
    key[2] = fkey(v.z);
    key[3] = fkey(v.w);
#pragma unroll
    for (int e = 0; e < 4; ++e) ok[e] = (uint32_t)(4 * u + e - lo) < ulen;
  };
  auto loadf = [&](int u, uint32_t (&key)[4]) {
    const uint4 v = xs4[u];
    key[0] = fkey(v.x);
    key[1] = fkey(v.y);
    key[2] = fkey(v.z);
    key[3] = fkey(v.w);
  };
  auto keyat = [&](int slot) { return fkey(xs[slot]); };
  auto order = [&](int slot) { return (uint32_t)slot; };
  // pass 1 (bits 31..21): the head and tail units, then each stage as
  // its bulk copy lands
  uint32_t zeros = 0;
  const int mid_end = st.mid_u0 + st.mid_units;
  hist_units(load, 0, st.mid_u0, hist, 21, 2047u, 32, 0u, zeros);
  hist_units(load, mid_end, st.nu, hist, 21, 2047u, 32, 0u, zeros);
  for (int s = 0; s < st.stages; ++s) {
    mbar_wait(&sh.bars[s]);
    const int u0 = st.mid_u0 + s * kStageUnits;
    hist_full(loadf, u0, min(u0 + kStageUnits, mid_end), hist, zeros);
  }
  flush_zeros(hist, zeros, 21, 2047u, 32, 0u);
  if (zeros) atomicAdd(&sh.zeros, zeros);
  __syncthreads();

  const int base_index = start - st.pad;
  if (C == 1) {
    auto put = [&](uint32_t pos, uint32_t key, int slot) {
      buf[pos] = composite(key, (uint32_t)(base_index + slot));
    };
    keep_top<true>(load, loadf, st.mid_u0, mid_end, keyat, order, st.nu,
                   hist, cand, kCandCap, (uint32_t)kc, sh, put);
    sort_and_write(buf, tmp, hist, kc, r, vals, idx, sh);
  } else {
    const long long base = (r * C + c) * (long long)kstride;
    auto put = [&](uint32_t pos, uint32_t key, int slot) {
      skeys[base + pos] = key;
      sidx[base + pos] = (uint32_t)(base_index + slot);
    };
    keep_top<true>(load, loadf, st.mid_u0, mid_end, keyat, order, st.nu,
                   hist, cand, kCandCap, (uint32_t)kc, sh, put);
    for (int p = kc + (int)threadIdx.x; p < kstride; p += kThreads)
      skeys[base + p] = 0u;                // below every key: never kept
  }
}

// Phase B. Grid (B); dynamic shared memory: hist | buf | the row's C *
// kstride scratch keys when `staged` (else read in place) | cand
// (cand_cap slots: what shared memory has left, at least kCandCap).
__global__ void __launch_bounds__(kThreads, kMinBlocks)
topk_merge_kernel(const uint32_t* __restrict__ skeys,
                  const uint32_t* __restrict__ sidx, int C, int k,
                  int kstride, int staged, int cand_cap,
                  float* __restrict__ vals,
                  int64_t* __restrict__ idx) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Shared sh;
  const long long r = blockIdx.x;
  const int n = C * kstride;                       // a multiple of 4
  const uint32_t* gk = skeys + r * n;
  const uint32_t* gi = sidx + r * n;
  uint32_t* hist = reinterpret_cast<uint32_t*>(smem);
  unsigned long long* buf =
      reinterpret_cast<unsigned long long*>(smem + kHistBytes);
  uint32_t* ks = reinterpret_cast<uint32_t*>(smem + kHistBytes
                                             + buf_bytes(k));
  // the sort's scratch: the keys' region, once they are selected
  unsigned long long* tmp = reinterpret_cast<unsigned long long*>(ks);
  uint32_t* cand = ks + merge_key_words(n, k, staged);
  // a list shorter than kstride is padded with key 0, below every key
  // (phase A), so every slot is read as valid
  const uint32_t* keys = staged ? ks : gk;
  const uint4* k4 = reinterpret_cast<const uint4*>(keys);
  auto load = [&](int u, uint32_t (&key)[4], bool (&ok)[4]) {
    const uint4 v = k4[u];
    key[0] = v.x;
    key[1] = v.y;
    key[2] = v.z;
    key[3] = v.w;
#pragma unroll
    for (int e = 0; e < 4; ++e) ok[e] = true;
  };
  auto loadf = [&](int u, uint32_t (&key)[4]) {
    const uint4 v = k4[u];
    key[0] = v.x;
    key[1] = v.y;
    key[2] = v.z;
    key[3] = v.w;
  };
  auto keyat = [&](int slot) { return keys[slot]; };
  auto order = [&](int slot) { return gi[slot]; };
  const int nu = n / 4;
  clear_hist(hist);
  if (threadIdx.x == 0) sh.zeros = 0;
  uint32_t zeros = 0;
  if (staged) {
    const Staged st = stage_begin(ks, gk, n, sh.bars);   // aligned: pad 0
    for (int s = 0; s < st.stages; ++s) {
      mbar_wait(&sh.bars[s]);
      const int u0 = s * kStageUnits;
      hist_full(loadf, u0, min(u0 + kStageUnits, nu), hist, zeros);
    }
  } else {
    __syncthreads();
    hist_full(loadf, 0, nu, hist, zeros);
  }
  flush_zeros(hist, zeros, 21, 2047u, 32, 0u);
  if (zeros) atomicAdd(&sh.zeros, zeros);
  __syncthreads();

  auto put = [&](uint32_t pos, uint32_t key, int slot) {
    buf[pos] = composite(key, gi[slot]);
  };
  keep_top<false>(load, loadf, 0, nu, keyat, order, nu, hist, cand,
                  (uint32_t)cand_cap, (uint32_t)k, sh, put);
  sort_and_write(buf, tmp, hist, k, r, vals, idx, sh);
}

int ceil_div(long long a, long long b) { return (int)((a + b - 1) / b); }
int imin(int a, int b) { return a < b ? a : b; }
int imax(int a, int b) { return a > b ? a : b; }

}  // namespace

extern "C" {

int topk_max_k() { return kMaxK; }

// Chooses the chunking of (B, D) rows for top-k on a card of `sms` SMs:
// out[0] = C chunks of out[1] = L entries (the last may be shorter),
// out[2] = kstride, the scratch stride of a chunk's list (0 when C == 1).
// When chunks of at most kPrefWords entries give at least 2 * sms CTAs,
// C is their count (many rows: the card is bound by bytes, and two CTAs
// share an SM). Else C is raised towards sms / B CTAs a row, while a
// row's lists stay within kMergeKeys keys and a chunk keeps at least 4 k
// and 2048 entries, and never below what fits a chunk in shared memory.
int topk_plan(int B, int D, int k, int sms, int* out) {
  if (B <= 0 || D <= 0 || k <= 0 || k > D || k > kMaxK || sms <= 0)
    return (int)cudaErrorInvalidValue;
  const int c_hard = ceil_div(D, kMaxWords);
  const int c_pref = ceil_div(D, kPrefWords);
  int c;
  if ((long long)B * c_pref >= 2LL * sms) {
    c = c_pref;
  } else {
    const int kr = (k + 3) / 4 * 4;
    c = ceil_div(sms, B);
    c = imin(c, imax(1, kMergeKeys / kr));
    c = imin(c, imax(1, D / imax(2048, 4 * k)));
    c = imax(c, c_hard);
  }
  int L = (ceil_div(D, c) + 3) / 4 * 4;
  if (L > kMaxWords) L = kMaxWords;
  c = ceil_div(D, L);
  if (c == 1) L = D;
  out[0] = c;
  out[1] = L;
  out[2] = c == 1 ? 0 : (imin(k, L) + 3) / 4 * 4;
  return 0;
}

size_t topk_chunk_smem_bytes(int C, int L, int k) {
  return (size_t)kFixedBytes + (C == 1 ? 2 * buf_bytes(imin(k, L)) : 0)
         + (size_t)(L + 8) * 4;
}

// Phase B's candidate capacity: what a block's shared memory has left.
int merge_cand_cap(int C, int kstride, int k) {
  const long long n = (long long)C * kstride;
  const long long left = kSmemBytes - kHistBytes - buf_bytes(k)
                         - 4LL * merge_key_words(n, k, n <= kMaxMergeWords);
  return (int)(left / 4 < kMergeCandCap ? left / 4 : kMergeCandCap);
}

size_t topk_merge_smem_bytes(int C, int kstride, int k) {
  const long long n = (long long)C * kstride;
  return (size_t)kHistBytes + buf_bytes(k)
         + 4 * (size_t)merge_key_words(n, k, n <= kMaxMergeWords)
         + (size_t)merge_cand_cap(C, kstride, k) * 4;
}

// Lets both kernels take the most shared memory a launch can ask for;
// once per process.
static cudaError_t allow_smem() {
  static cudaError_t err = [] {
    const int most = (int)topk_chunk_smem_bytes(1, kMaxWords, kMaxK);
    cudaError_t e = cudaFuncSetAttribute(
        topk_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(topk_merge_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                kSmemBytes);
  }();
  return err;
}

// x: B rows of D float32 entries, row r at x + r * row_stride (elements;
// entries of a row contiguous); vals (B, k) f32 and idx (B, k) int64,
// contiguous; (C, L, kstride) from topk_plan; scratch: 2 * B * C *
// kstride uint32 words when C > 1 (the lists' keys, then their indices).
// 1 <= k <= min(D, kMaxK), D < 2^31. One launch when C == 1, two else.
int topk_launch(const float* x, long long row_stride, int B, int D, int k,
                int C, int L, int kstride, float* vals, int64_t* idx,
                uint32_t* scratch, void* stream) {
  if (B == 0 || k == 0) return 0;
  if (k < 0 || k > D || k > kMaxK || C < 1 || L < 1 || L > kMaxWords
      || (long long)(C - 1) * L >= D || (long long)C * L < D
      || (C > 1 && (kstride < imin(k, L) || kstride % 4 != 0
                    || (reinterpret_cast<uintptr_t>(scratch) & 15) != 0))
      || C > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = allow_smem();
  if (err != cudaSuccess) return (int)err;
  const size_t smem_a = topk_chunk_smem_bytes(C, L, k);
  const size_t words = (size_t)B * C * kstride;
  topk_chunk_kernel<<<dim3((unsigned)B, (unsigned)C), kThreads, smem_a, s>>>(
      x, row_stride, D, k, L, kstride, vals, idx, scratch,
      C > 1 ? scratch + words : nullptr);
  err = cudaGetLastError();
  if (err != cudaSuccess || C == 1) return (int)err;
  const size_t smem_b = topk_merge_smem_bytes(C, kstride, k);
  const int staged = (long long)C * kstride <= kMaxMergeWords ? 1 : 0;
  topk_merge_kernel<<<(unsigned)B, kThreads, smem_b, s>>>(
      scratch, scratch + words, C, k, kstride, staged,
      merge_cand_cap(C, kstride, k), vals, idx);
  return (int)cudaGetLastError();
}

}  // extern "C"
