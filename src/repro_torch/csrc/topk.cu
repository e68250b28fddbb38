// Row-wise top-k for Hopper (sm_90a) under jax.lax.top_k's rule: the k
// largest entries of each row, ordered (value desc, index asc), with
// int64 indices. It serves every top-k of the port: the sparse top-k and
// the fuse top-k over (B, n_docs) rows, the Stage-II budget, Stage-I
// sort-by-distance and the centroid neighbour graph.
//
// Replaces topk_pallas (src/repro/kernels/topk/kernel.py, _topk_kernel).
// The TPU kernel streamed a row through VMEM in tiles and carried a
// (k,)-sized running best across the sequential tile axis of its grid,
// merging each tile with lax.top_k. A CUDA grid has no sequential axis,
// so this is a radix select instead, one CTA per row:
//
//   keys: each float maps to an order-preserving uint32 (sign set: all
//   bits flipped; else the sign bit set). The map is a bijection and its
//   order is the total order lax.top_k uses: -0.0 ranks below +0.0, and
//   ties are exact bit equality. NaN is out of contract.
//
//   pass 1: a 2048-bin histogram of key bits 31..21 over the row, in
//   shared memory, finds the bin d1 that holds the k-th largest key.
//
//   path S (the entries at or above d1 fit the 8192-entry buffer): a
//   second pass appends them, as (~key << 32 | index) composites, into
//   shared memory; a bitonic sort orders them (value desc, index asc) and
//   the first k are the result. Two reads of the row.
//
//   path L (a bin too full, as in a row that is mostly exact zeros, with
//   fewer than k valid entries): passes 2 and 3 refine bits 20..10 and
//   9..0 among the entries of the chosen prefix, which gives the k-th key
//   exactly and how many of its ties belong in the result; a last pass
//   walks the row in index order, keeps every entry above the k-th key
//   and the lowest-indexed ties (a block-wide prefix count per tile), and
//   the same sort orders the k kept. Four reads of the row.
//
// The row is read through a row stride, so a strided view such as
// fused[:, :n_docs] is read in place; float4 loads cover its aligned
// middle. Exact zeros, the bulk of the fused and sparse-score rows, are
// counted in a register per thread rather than by shared atomics on one
// bin.
//
// What bounds it on the H100: bytes. Its least work reads each row once
// and writes k values and indices: at (256, 2^20) rows and k 1000 that is
// 1.07 GB, 0.32 ms at 3.35 TB/s. Path S reads each row twice, path L four
// times; one CTA of 512 threads per row keeps up to 396 rows in flight.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kBuf = 8192;             // composites in shared memory (64 KB)
constexpr int kMaxK = 2048;
constexpr int kHistBins = 2048;
constexpr uint32_t kZeroKey = 0x80000000u;     // the key of +0.0
constexpr unsigned long long kPad = ~0ull;     // sorts after every entry

__device__ __forceinline__ uint32_t fkey(float f) {
  const uint32_t b = __float_as_uint(f);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float fval(uint32_t key) {
  return __uint_as_float((key & 0x80000000u) ? (key ^ 0x80000000u) : ~key);
}

// ascending composite order = (key desc, index asc)
__device__ __forceinline__ unsigned long long composite(uint32_t key,
                                                        uint32_t idx) {
  return ((unsigned long long)(~key) << 32) | idx;
}

// Calls f(value, index, ok) for every element of the row, by every thread
// the same number of times (so f may use warp votes); ok is false on the
// padding calls.
template <class F>
__device__ __forceinline__ void scan_row(const float* __restrict__ row,
                                         int D, F&& f) {
  const int tid = threadIdx.x;
  int head = (int)(((16u - (uint32_t)(reinterpret_cast<uintptr_t>(row)
                                      & 15u)) & 15u) >> 2);
  if (head > D) head = D;
  {
    const bool ok = tid < head;
    f(ok ? row[tid] : 0.0f, tid, ok);
  }
  const int n4 = (D - head) >> 2;
  const float4* r4 = reinterpret_cast<const float4*>(row + head);
  const int n4r = (n4 + kThreads - 1) / kThreads * kThreads;
  for (int i = tid; i < n4r; i += kThreads) {
    const bool ok = i < n4;
    const float4 v = ok ? __ldg(r4 + i) : make_float4(0.f, 0.f, 0.f, 0.f);
    const int base = head + 4 * i;
    f(v.x, base, ok);
    f(v.y, base + 1, ok);
    f(v.z, base + 2, ok);
    f(v.w, base + 3, ok);
  }
  {
    const int i = head + 4 * n4 + tid;
    const bool ok = i < D;
    f(ok ? row[i] : 0.0f, i, ok);
  }
}

// The largest bin d with sum_{j >= d} hist[j] >= need; *above gets
// sum_{j > d} hist[j]. Needs 1 <= need <= the histogram's total and
// nbins a multiple of 32. Warp 0 works; the block syncs after.
__device__ void select_bin(const uint32_t* hist, int nbins, uint32_t need,
                           int* bin, uint32_t* above) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const int per = nbins / 32;
    const int hi = nbins - per * lane;           // lane 0: the top bins
    const int lo = hi - per;
    uint32_t s = 0;
    for (int j = lo; j < hi; ++j) s += hist[j];
    uint32_t incl = s;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const uint32_t t = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += t;
    }
    const uint32_t excl = incl - s;
    if (excl < need && need <= incl) {
      uint32_t acc = excl;
      for (int j = hi - 1; j >= lo; --j) {
        const uint32_t h = hist[j];
        if (acc + h >= need) {
          *bin = j;
          *above = acc;
          break;
        }
        acc += h;
      }
    }
  }
  __syncthreads();
}

__device__ void bitonic_sort(unsigned long long* a, int n) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      __syncthreads();
      for (int t = threadIdx.x; t < n / 2; t += kThreads) {
        const int i = 2 * t - (t & (stride - 1));
        const int j = i + stride;
        const bool up = (i & size) == 0;
        const unsigned long long x = a[i], y = a[j];
        if ((x > y) == up) {
          a[i] = y;
          a[j] = x;
        }
      }
    }
  }
  __syncthreads();
}

__device__ __forceinline__ int next_pow2(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// Appends `c` where `take`, warp-aggregated, at buf[*count ...].
__device__ __forceinline__ void append(bool take, unsigned long long c,
                                       unsigned long long* buf,
                                       uint32_t* count) {
  const unsigned m = __ballot_sync(0xffffffffu, take);
  if (m == 0) return;
  const int lane = threadIdx.x & 31;
  const int leader = __ffs(m) - 1;
  uint32_t base = 0;
  if (lane == leader) base = atomicAdd(count, (uint32_t)__popc(m));
  base = __shfl_sync(0xffffffffu, base, leader);
  if (take) buf[base + __popc(m & ((1u << lane) - 1u))] = c;
}

// Histogram of ((key >> shift) & mask) over the keys whose bits above
// `prefix_shift` equal `prefix` (all keys when prefix_shift is 32).
__device__ void histogram(const float* row, int D, uint32_t* hist,
                          int nbins, int shift, uint32_t mask,
                          int prefix_shift, uint32_t prefix) {
  for (int i = threadIdx.x; i < nbins; i += kThreads) hist[i] = 0;
  __syncthreads();
  uint32_t zeros = 0;
  scan_row(row, D, [&](float v, int, bool ok) {
    if (!ok) return;
    const uint32_t key = fkey(v);
    if (prefix_shift < 32 && (key >> prefix_shift) != prefix) return;
    if (key == kZeroKey) {
      ++zeros;
      return;
    }
    atomicAdd(&hist[(key >> shift) & mask], 1u);
  });
  if (zeros) atomicAdd(&hist[(kZeroKey >> shift) & mask], zeros);
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads, 2)
topk_kernel(const float* __restrict__ x, long long row_stride, int D, int k,
            float* __restrict__ vals, int64_t* __restrict__ idx) {
  extern __shared__ unsigned long long buf[];                  // kBuf
  __shared__ uint32_t hist[kHistBins];
  __shared__ int s_bin;
  __shared__ uint32_t s_above, s_count, s_ties;
  __shared__ uint32_t s_wsum[kWarps];

  const int r = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* row = x + (long long)r * row_stride;

  // pass 1: key bits 31..21
  histogram(row, D, hist, 2048, 21, 2047u, 32, 0u);
  if (tid == 0) s_count = 0;
  select_bin(hist, 2048, (uint32_t)k, &s_bin, &s_above);
  const uint32_t d1 = (uint32_t)s_bin;
  const uint32_t above1 = s_above;
  const uint32_t in_bin = hist[d1];
  int n;                           // composites in buf, the k best first
  if (above1 + in_bin <= (uint32_t)kBuf) {
    // path S: every entry at or above bin d1
    scan_row(row, D, [&](float v, int i, bool ok) {
      const uint32_t key = fkey(v);
      append(ok && (key >> 21) >= d1, composite(key, (uint32_t)i), buf,
             &s_count);
    });
    __syncthreads();
    n = (int)s_count;
  } else {
    // path L: refine the k-th key over the whole row, then keep in order
    const uint32_t need1 = (uint32_t)k - above1;
    __syncthreads();
    histogram(row, D, hist, 2048, 10, 2047u, 21, d1);
    select_bin(hist, 2048, need1, &s_bin, &s_above);
    const uint32_t p21 = (d1 << 11) | (uint32_t)s_bin;
    const uint32_t need2 = need1 - s_above;
    __syncthreads();
    histogram(row, D, hist, 1024, 0, 1023u, 10, p21);
    select_bin(hist, 1024, need2, &s_bin, &s_above);
    const uint32_t kth = (p21 << 10) | (uint32_t)s_bin;
    const uint32_t room = need2 - s_above;          // ties to keep, >= 1
    const uint32_t n_above = (uint32_t)k - room;
    if (tid == 0) s_ties = 0;
    __syncthreads();
    // tiles of kThreads * 4 consecutive entries, thread t on 4t .. 4t+3
    for (int base = 0; base < D; base += kThreads * 4) {
      uint32_t keys[4];
      uint32_t nt = 0;
      for (int j = 0; j < 4; ++j) {
        const int i = base + 4 * tid + j;
        keys[j] = i < D ? fkey(row[i]) : 0u;
        nt += (i < D && keys[j] == kth) ? 1u : 0u;
      }
      for (int j = 0; j < 4; ++j) {
        const int i = base + 4 * tid + j;
        append(i < D && keys[j] > kth, composite(keys[j], (uint32_t)i), buf,
               &s_count);
      }
      // block-wide exclusive prefix count of the ties, in index order
      uint32_t incl = nt;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const uint32_t t = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += t;
      }
      if (lane == 31) s_wsum[warp] = incl;
      __syncthreads();
      uint32_t before = s_ties;
      for (int w = 0; w < warp; ++w) before += s_wsum[w];
      uint32_t rank = before + incl - nt;
      for (int j = 0; j < 4; ++j) {
        const int i = base + 4 * tid + j;
        if (i < D && keys[j] == kth) {
          if (rank < room) buf[n_above + rank] = composite(kth, (uint32_t)i);
          ++rank;
        }
      }
      __syncthreads();
      if (tid == 0) {
        uint32_t tot = 0;
        for (int w = 0; w < kWarps; ++w) tot += s_wsum[w];
        s_ties += tot;
      }
      __syncthreads();
      if (s_count == n_above && s_ties >= room) break;      // all found
    }
    n = k;
  }
  const int np = next_pow2(n);
  for (int i = n + tid; i < np; i += kThreads) buf[i] = kPad;
  bitonic_sort(buf, np);
  float* vo = vals + (long long)r * k;
  int64_t* io = idx + (long long)r * k;
  for (int i = tid; i < k; i += kThreads) {
    const unsigned long long c = buf[i];
    io[i] = (int64_t)(uint32_t)(c & 0xffffffffu);
    vo[i] = fval(~(uint32_t)(c >> 32));
  }
}

}  // namespace

extern "C" {

int topk_max_k() { return kMaxK; }

size_t topk_smem_bytes() { return (size_t)kBuf * sizeof(unsigned long long); }

// x: B rows of D float32 entries, row r at x + r * row_stride (elements;
// entries of a row contiguous); vals (B, k) f32 and idx (B, k) int64,
// contiguous. 1 <= k <= min(D, kMaxK), D < 2^31.
int topk_launch(const float* x, long long row_stride, int B, int D, int k,
                float* vals, int64_t* idx, void* stream) {
  if (B == 0 || k == 0) return 0;
  if (k < 0 || k > D || k > kMaxK) return (int)cudaErrorInvalidValue;
  const size_t smem = topk_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  topk_kernel<<<(unsigned)B, kThreads, smem, (cudaStream_t)stream>>>(
      x, row_stride, D, k, vals, idx);
  return (int)cudaGetLastError();
}

}  // extern "C"
