// Selected-cluster scoring kernel for Hopper (sm_90a): the "dot" tail of
// CluSD serving (paper Step 3, the partial dense retrieval) and the label
// pass's full-dense chunks.
//
// Replaces cluster_score_pallas (src/repro/kernels/cluster_score/
// kernel.py, _score_kernel):
//   scores[b, s, c] = blocks[sel[b, s], c, :] . q[b, :]
// over float32 blocks (U, cap, dim) on the card and each slot's position
// sel (B, S) among them; a slot whose position is outside [0, U) scores
// NaN. The TPU kernel let the DMA engine gather block sel[b, s] into VMEM
// through a scalar-prefetch index map and ran one MXU matvec per slot, so
// a block was read once for every slot that picked it. Here the design is
// block-major: each selected block is streamed from device memory once
// for each tile of the queries that pick it.
//
// Grouping pre-pass (three small kernels, sized from B, S and U alone,
// with no host sync, so a call can be captured in a CUDA graph):
//   hist     counts the slots of each block (atomics) and writes the NaN
//            rows of out-of-range slots;
//   plan     one CTA: an exclusive scan of the counts gives each block's
//            run of slot positions, and cuts each run into work items
//            (block, first position, queries, first row): a run of fewer
//            than kGemmMinQueries slots is one "bytes" tile, a longer one
//            is split into near-equal tiles of at most kGemmQueries
//            ("GEMM" tiles), GEMM items first;
//   scatter  puts each slot at its block's next free position (atomics,
//            so slots sit in any order within a run).
// The wrapper passes the scratch (counts zeroed, the rest empty); the
// kernels allocate nothing.
//
// Scoring kernel: one CTA of 256 threads per work item; the CTA takes
// one of two paths from its tile's own query count:
//   bytes (1 to kGemmMinQueries - 1 queries: the serving shapes, where a
//     block is picked by one or two queries of a batch). What bounds it
//     is bytes: each block is read once, about 4.1 GB for the v1 tail's
//     5173 unique blocks of (256, 768), 1.2 ms at 3.35 TB/s. 256 rows of
//     the block stream through a ring of kStages shared-memory stages of
//     32 k each (cp.async, 16 bytes a thread, XOR-swizzled so that the
//     reads below hit 32 banks) beside the tile's queries' 32 k; two CTAs
//     per SM keep up to four 32 KB stages in flight per SM. A thread owns
//     rows r and r + 128 and every other query of the tile, and the CTA
//     takes the instance whose loop covers just its tile's queries: the
//     arithmetic is so light that loop overhead, not FMA, is what would
//     keep the loads from overlapping it.
//   GEMM (kGemmMinQueries to kGemmQueries queries: the label chunk, where
//     512 queries pick each of 64 blocks, and the distributed path's
//     clamped slots). What bounds it is operations: 2 * B * U * cap * dim
//     fp32 FLOP, 0.19 ms for the label chunk at 67 TFLOP/s. A register-
//     tiled SGEMM tile of 128 queries x 128 rows, k in steps of 8, both
//     operands transposed into double-buffered shared memory from
//     registers loaded one step ahead; each thread keeps an 8 x 8 tile of
//     sums in registers (64 FMA for 4 16-byte shared loads).
// No tensor cores: IEEE fp32 FMA (no TF32).
//
// One accumulation order for every score, in both paths and at every
// tile size: a single FMA chain from +0 over k ascending (fmaf(block,
// query, acc)), padded with zeros to a multiple of 32 k. So a (query,
// block) pair scores bitwise the same whichever queries it is grouped
// with, which keeps a sharded router's hosts, which group their own
// subsets of slots, bitwise equal to a single engine.

#include <cub/block/block_scan.cuh>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPlanThreads = 1024;
// grouping
constexpr int kGemmMinQueries = 32;   // tiles this large take the GEMM path
constexpr int kGemmQueries = 128;     // queries in a GEMM tile, at most
constexpr int kGemmRows = 128;        // block rows in a GEMM item
constexpr int kBytesRows = 256;       // block rows in a bytes item
constexpr int kPadK = 32;             // every chain is padded to this
// bytes path: a stage holds kBytesRows x kBK of the block (32 KB) and up
// to kGemmMinQueries x kBK of the queries; thread t owns rows t % 128 and
// t % 128 + 128 and every other query from t / 128 on
constexpr int kBK = kPadK;
constexpr int kStages = 3;
constexpr int kBlockFloats = kBytesRows * kBK;
constexpr int kStageFloats = kBlockFloats + kGemmMinQueries * kBK;
// GEMM path: As, Bs [2][kGK][kGStride], k-major
constexpr int kGK = 8;
constexpr int kGStride = kGemmQueries + 4;
constexpr int kGemmFloats = 2 * 2 * kGK * kGStride;
constexpr int kSmemFloats =
    kStages * kStageFloats > kGemmFloats ? kStages * kStageFloats
                                         : kGemmFloats;
static_assert(kGemmRows == kGemmQueries, "one stride for As and Bs");
static_assert(kBK % kPadK == 0 && kPadK % kGK == 0, "chains padded alike");
static_assert(kGemmQueries <= kThreads, "one slot per thread");
static_assert(kGK == 8 && 2 * kGemmQueries == kThreads,
              "the GEMM loader: one row, half a k step, a thread");
static_assert(kBK == 32 && kBytesRows == 256 && kThreads == 256,
              "the bytes path's thread map");

__host__ __device__ constexpr int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy 4 floats at src (n of them valid: n <= 0 zero-fills) to dst. V4:
// one 16-byte cp.async (dim % 4 == 0 and 16-byte aligned rows, so n >= 4
// or n <= 0); else four 4-byte ones. An invalid source is not read.
template <bool V4>
__device__ __forceinline__ void copy4(float* dst, const float* src,
                                      const float* safe, int n) {
  if constexpr (V4) {
    const int bytes = n > 0 ? 16 : 0;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(n > 0 ? src : safe), "r"(bytes));
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int bytes = e < n ? 4 : 0;
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                       smem_addr(dst + e)),
                   "l"(e < n ? src + e : safe), "r"(bytes));
    }
  }
}

template <bool V4>
__device__ __forceinline__ float4 load4(const float* src, int n) {
  if constexpr (V4) {
    if (n > 0) return __ldg(reinterpret_cast<const float4*>(src));
    return make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = e < n ? __ldg(src + e) : 0.f;
    return make_float4(v[0], v[1], v[2], v[3]);
  }
}

__device__ __forceinline__ float fma4(float4 x, float4 y, float acc) {
  acc = __fmaf_rn(x.x, y.x, acc);
  acc = __fmaf_rn(x.y, y.y, acc);
  acc = __fmaf_rn(x.z, y.z, acc);
  return __fmaf_rn(x.w, y.w, acc);
}

// ---- the grouping pre-pass ------------------------------------------------

__global__ void hist_kernel(const int32_t* __restrict__ sel, int n_slots,
                            int U, int cap, int* __restrict__ counts,
                            float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_slots) return;
  const int u = sel[i];
  if (u >= 0 && u < U) {
    atomicAdd(counts + u, 1);
  } else {
    float* o = out + (size_t)i * cap;
    for (int c = 0; c < cap; ++c) o[c] = __int_as_float(0x7fc00000);
  }
}

__global__ void __launch_bounds__(kPlanThreads)
plan_kernel(const int* __restrict__ counts, int U, int cap,
            int* __restrict__ cursor, int4* __restrict__ items,
            int* __restrict__ n_items) {
  using Scan = cub::BlockScan<int, kPlanThreads>;
  __shared__ typename Scan::TempStorage tmp;
  const int t = threadIdx.x;
  const int per = ceil_div(U, kPlanThreads);
  const int lo = min(U, t * per);
  const int hi = min(U, lo + per);
  const int rg = ceil_div(cap, kGemmRows);
  const int rb = ceil_div(cap, kBytesRows);
  int n_slots = 0, n_gemm = 0, n_bytes = 0;
  for (int u = lo; u < hi; ++u) {
    const int n = counts[u];
    n_slots += n;
    if (n >= kGemmMinQueries) {
      n_gemm += ceil_div(n, kGemmQueries) * rg;
    } else if (n > 0) {
      n_bytes += rb;
    }
  }
  int slot0, gemm0, bytes0, tot_slots, tot_gemm, tot_bytes;
  Scan(tmp).ExclusiveSum(n_slots, slot0, tot_slots);
  __syncthreads();
  Scan(tmp).ExclusiveSum(n_gemm, gemm0, tot_gemm);
  __syncthreads();
  Scan(tmp).ExclusiveSum(n_bytes, bytes0, tot_bytes);
  bytes0 += tot_gemm;                        // GEMM items first
  for (int u = lo; u < hi; ++u) {
    const int n = counts[u];
    cursor[u] = slot0;
    if (n >= kGemmMinQueries) {
      const int m = ceil_div(n, kGemmQueries);
      for (int i = 0; i < m; ++i) {          // near-equal tiles
        const int a = slot0 + (int)((long long)i * n / m);
        const int b = slot0 + (int)((long long)(i + 1) * n / m);
        for (int r = 0; r < rg; ++r) {
          items[gemm0++] = make_int4(u, a, b - a, r * kGemmRows);
        }
      }
    } else if (n > 0) {
      for (int r = 0; r < rb; ++r) {
        items[bytes0++] = make_int4(u, slot0, n, r * kBytesRows);
      }
    }
    slot0 += n;
  }
  if (t == 0) n_items[0] = tot_gemm + tot_bytes;
}

__global__ void scatter_kernel(const int32_t* __restrict__ sel, int n_slots,
                               int U, int* __restrict__ cursor,
                               int* __restrict__ order) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_slots) return;
  const int u = sel[i];
  if (u >= 0 && u < U) order[atomicAdd(cursor + u, 1)] = i;
}

// ---- the bytes path ---------------------------------------------------------

// QP: the most queries a thread takes (its half of the tile's, rounded up
// to a power of two; the CTA picks the instance from its tile's count)
template <bool V4, int QP>
__device__ __forceinline__ void bytes_tile(
    const float* __restrict__ q, const float* __restrict__ blocks, int4 it,
    float* __restrict__ out, int S, int cap, int dim, float* smem,
    const int* s_slot) {
  const int u = it.x, nq = it.z, row0 = it.w;
  const int t = threadIdx.x;
  const int rows = min(kBytesRows, cap - row0);
  const float* blk = blocks + ((size_t)u * cap + row0) * dim;
  const int KT = ceil_div(dim, kBK);
  // loader: chunk column ch of rows lr + 32 i (i < 8), XOR-swizzled so
  // that a quarter-warp's reads below hit 8 distinct 16-byte columns
  const int lr = t >> 3, ch = t & 7;
  const int s_off = lr * kBK + ((ch ^ (lr & 7)) << 2);
  const float* g_src = blk + (size_t)lr * dim + ch * 4;
  const size_t g_step = (size_t)32 * dim;
  const int n_rows = rows - lr;              // rows lr + 32 i < rows
  const bool q_load = t < nq * (kBK / 4);
  const float* q_src = q + (size_t)(q_load ? s_slot[lr] / S : 0) * dim
      + ch * 4;
  auto load_stage = [&](int slot, int kt) {
    float* Ts = smem + slot * kStageFloats;
    const int k0 = kt * kBK;
    const int n = dim - k0 - ch * 4;
#pragma unroll
    for (int i = 0; i < kBytesRows / 32; ++i) {
      if (32 * i < n_rows) {
        copy4<V4>(Ts + s_off + i * 32 * kBK, g_src + i * g_step + k0,
                  g_src + i * g_step, n);
      }
    }
    if (q_load) copy4<V4>(Ts + kBlockFloats + lr * kBK + ch * 4, q_src + k0,
                          q_src, n);
  };

  const int g = t >> 7, r0 = t & 127, m = r0 & 7;
  const int nqg = (nq - g + 1) >> 1;         // its queries: j = 2 jj + g
  float acc[2][QP];
#pragma unroll
  for (int jj = 0; jj < QP; ++jj) {
    acc[0][jj] = 0.f;
    acc[1][jj] = 0.f;
  }
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < KT) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (kt + kStages - 1 < KT) {
      load_stage((kt + kStages - 1) % kStages, kt + kStages - 1);
    }
    cp_async_commit();
    if (nqg > 0) {                           // uniform in a warp
      const float* Ta = smem + (kt % kStages) * kStageFloats + r0 * kBK;
      const float* Qg = smem + (kt % kStages) * kStageFloats + kBlockFloats
          + g * kBK;
#pragma unroll
      for (int k4 = 0; k4 < kBK / 4; ++k4) {
        const int off = (k4 ^ m) << 2;
        const float4 xa = *reinterpret_cast<const float4*>(Ta + off);
        const float4 xb = *reinterpret_cast<const float4*>(
            Ta + 128 * kBK + off);
#pragma unroll
        for (int jj = 0; jj < QP; ++jj) {
          if (jj == 0 || jj < nqg) {
            const float4 y = *reinterpret_cast<const float4*>(
                Qg + jj * 2 * kBK + k4 * 4);
            acc[0][jj] = fma4(xa, y, acc[0][jj]);
            acc[1][jj] = fma4(xb, y, acc[1][jj]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int jj = 0; jj < QP; ++jj) {
    if (jj < nqg) {
      float* o = out + (size_t)s_slot[2 * jj + g] * cap + row0;
      if (r0 < rows) o[r0] = acc[0][jj];
      if (r0 + 128 < rows) o[r0 + 128] = acc[1][jj];
    }
  }
}

// ---- the GEMM path ----------------------------------------------------------

template <bool V4>
__device__ __forceinline__ void gemm_tile(
    const float* __restrict__ q, const float* __restrict__ blocks, int4 it,
    float* __restrict__ out, int S, int cap, int dim, float* smem,
    const int* s_slot) {
  const int u = it.x, nq = it.z, row0 = it.w;
  const int t = threadIdx.x;
  float* As = smem;                          // [2][kGK][kGStride]
  float* Bs = smem + 2 * kGK * kGStride;
  const int rows = min(kGemmRows, cap - row0);
  // loader: row lr of each operand, k chunk lc of the step
  const int lr = t >> 1, lc = t & 1;
  const bool a_ok = lr < nq, b_ok = lr < rows;
  const float* a_src = q + (size_t)(a_ok ? s_slot[lr] / S : 0) * dim
      + lc * 4;
  const float* b_src = blocks
      + ((size_t)u * cap + row0 + (b_ok ? lr : 0)) * dim + lc * 4;
  float4 ga, gb;
  auto gload = [&](int kt) {
    const int k = kt * kGK;
    const int n = dim - k - lc * 4;
    ga = load4<V4>(a_src + k, a_ok ? n : 0);
    gb = load4<V4>(b_src + k, b_ok ? n : 0);
  };
  auto sstore = [&](int buf) {
    float* A = As + buf * kGK * kGStride + lc * 4 * kGStride + lr;
    float* B = Bs + buf * kGK * kGStride + lc * 4 * kGStride + lr;
    A[0 * kGStride] = ga.x;
    A[1 * kGStride] = ga.y;
    A[2 * kGStride] = ga.z;
    A[3 * kGStride] = ga.w;
    B[0 * kGStride] = gb.x;
    B[1 * kGStride] = gb.y;
    B[2 * kGStride] = gb.z;
    B[3 * kGStride] = gb.w;
  };

  const int tx = t & 15, ty = t >> 4;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }
  const int KT = ceil_div(dim, kPadK) * (kPadK / kGK);
  gload(0);
  sstore(0);
  __syncthreads();
  for (int kt = 0; kt < KT; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < KT) gload(kt + 1);
    const float* A = As + cur * kGK * kGStride;
    const float* B = Bs + cur * kGK * kGStride;
#pragma unroll
    for (int kk = 0; kk < kGK; ++kk) {
      float a[8], b[8];
      *reinterpret_cast<float4*>(a) =
          *reinterpret_cast<const float4*>(A + kk * kGStride + ty * 4);
      *reinterpret_cast<float4*>(a + 4) =
          *reinterpret_cast<const float4*>(A + kk * kGStride + 64 + ty * 4);
      *reinterpret_cast<float4*>(b) =
          *reinterpret_cast<const float4*>(B + kk * kGStride + tx * 4);
      *reinterpret_cast<float4*>(b + 4) =
          *reinterpret_cast<const float4*>(B + kk * kGStride + 64 + tx * 4);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[i][j] = __fmaf_rn(b[j], a[i], acc[i][j]);
        }
      }
    }
    if (kt + 1 < KT) sstore(cur ^ 1);
    __syncthreads();
  }
  const bool cap4 = (cap & 3) == 0
      && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int j = (i < 4 ? 0 : 64) + ty * 4 + (i & 3);
    if (j >= nq) continue;
    float* o = out + (size_t)s_slot[j] * cap + row0;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c = half * 64 + tx * 4;
      const float* v = acc[i] + half * 4;
      if (cap4 && c + 3 < rows) {
        *reinterpret_cast<float4*>(o + c) = make_float4(v[0], v[1], v[2],
                                                        v[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (c + e < rows) o[c + e] = v[e];
        }
      }
    }
  }
}

template <bool V4>
__global__ void __launch_bounds__(kThreads, 2)
score_kernel(const float* __restrict__ q, const float* __restrict__ blocks,
             const int* __restrict__ order, const int4* __restrict__ items,
             const int* __restrict__ n_items, float* __restrict__ out,
             int S, int cap, int dim) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_slot[kGemmQueries];
  if ((int)blockIdx.x >= __ldg(n_items)) return;
  const int4 it = items[blockIdx.x];
  const int t = threadIdx.x;
  if (t < it.z) s_slot[t] = order[it.y + t];
  __syncthreads();
  const int qh = (it.z + 1) >> 1;            // a bytes thread's queries
  if (it.z >= kGemmMinQueries) {
    gemm_tile<V4>(q, blocks, it, out, S, cap, dim, smem, s_slot);
  } else if (qh <= 1) {
    bytes_tile<V4, 1>(q, blocks, it, out, S, cap, dim, smem, s_slot);
  } else if (qh <= 2) {
    bytes_tile<V4, 2>(q, blocks, it, out, S, cap, dim, smem, s_slot);
  } else if (qh <= 4) {
    bytes_tile<V4, 4>(q, blocks, it, out, S, cap, dim, smem, s_slot);
  } else if (qh <= 8) {
    bytes_tile<V4, 8>(q, blocks, it, out, S, cap, dim, smem, s_slot);
  } else {
    bytes_tile<V4, kGemmMinQueries / 2>(q, blocks, it, out, S, cap, dim,
                                        smem, s_slot);
  }
}

// the work items' bound, from B, S, U and cap alone (GEMM tiles hold at
// least kGemmMinQueries slots each; bytes tiles are one per block)
long long items_bound(int B, int S, int U, int cap) {
  const long long slots = (long long)B * S;
  return slots / kGemmMinQueries * ceil_div(cap, kGemmRows)
      + (slots < U ? slots : (long long)U) * ceil_div(cap, kBytesRows);
}

struct Scratch {
  int4* items;
  int* order;
  int* cursor;
  int* n_items;
};

// scratch layout (int32 words): items (4 per item, first: 16-byte
// aligned), order (B * S), cursor (U), n_items (4)
Scratch carve(int* scratch, int B, int S, int U, int cap) {
  Scratch s;
  const long long nb = items_bound(B, S, U, cap);
  s.items = reinterpret_cast<int4*>(scratch);
  s.order = scratch + 4 * nb;
  s.cursor = s.order + (long long)B * S;
  s.n_items = s.cursor + U;
  return s;
}

int group(const int32_t* sel, float* out, int B, int S, int U, int cap,
          int* counts, const Scratch& s, cudaStream_t stream) {
  const int n_slots = B * S;
  const int grid = ceil_div(n_slots, kThreads);
  hist_kernel<<<grid, kThreads, 0, stream>>>(sel, n_slots, U, cap, counts,
                                              out);
  plan_kernel<<<1, kPlanThreads, 0, stream>>>(counts, U, cap, s.cursor,
                                               s.items, s.n_items);
  scatter_kernel<<<grid, kThreads, 0, stream>>>(sel, n_slots, U, s.cursor,
                                                 s.order);
  return (int)cudaGetLastError();
}

template <bool V4>
cudaError_t set_smem() {
  cudaError_t err = cudaFuncSetAttribute(
      score_kernel<V4>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemFloats * (int)sizeof(float));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(score_kernel<V4>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

long long scratch_words(int B, int S, int U, int cap) {
  return 4 * items_bound(B, S, U, cap) + (long long)B * S + U + 4;
}

// int32 offsets and a 1-D grid hold every count
bool too_large(int B, int S, int U, int cap) {
  return scratch_words(B, S, U, cap) > 0x7fffffffLL;
}

}  // namespace

extern "C" {

size_t cluster_score_smem_bytes(int dim) {
  (void)dim;               // the stages stream k: no smem grows with dim
  return (size_t)kSmemFloats * sizeof(float);
}

long long cluster_score_items_bound(int B, int S, int U, int cap) {
  return items_bound(B, S, U, cap);
}

// int32 words of scratch beside the U zeroed counts
long long cluster_score_scratch_words(int B, int S, int U, int cap) {
  return scratch_words(B, S, U, cap);
}

// The grouping pre-pass alone (what the scoring kernel reads): counts
// (U, zeroed by the caller) and the scratch of
// cluster_score_scratch_words; NaN rows of out-of-range slots go to out.
int cluster_score_group(const int32_t* sel, float* out, int B, int S, int U,
                        int cap, int* counts, int* scratch, void* stream) {
  if (B == 0 || S == 0 || cap == 0 || U == 0) return 0;
  if (too_large(B, S, U, cap)) return (int)cudaErrorInvalidConfiguration;
  return group(sel, out, B, S, U, cap, counts, carve(scratch, B, S, U, cap),
               (cudaStream_t)stream);
}

// q: (B, dim) f32; blocks: (U, cap, dim) f32; sel: (B, S) i32; out: (B, S,
// cap) f32; all contiguous on one device. counts: U int32 zeros; scratch:
// cluster_score_scratch_words int32.
int cluster_score_launch(const float* q, const float* blocks,
                         const int32_t* sel, float* out, int B, int S,
                         int U, int cap, int dim, int* counts, int* scratch,
                         void* stream) {
  if (B == 0 || S == 0 || cap == 0 || U == 0) return 0;
  if (too_large(B, S, U, cap)) return (int)cudaErrorInvalidConfiguration;
  const cudaStream_t st = (cudaStream_t)stream;
  const Scratch s = carve(scratch, B, S, U, cap);
  const int rc = group(sel, out, B, S, U, cap, counts, s, st);
  if (rc != 0) return rc;
  const bool vec4 = (dim % 4 == 0)
      && (reinterpret_cast<uintptr_t>(q) % 16 == 0)
      && (reinterpret_cast<uintptr_t>(blocks) % 16 == 0);
  const size_t smem = (size_t)kSmemFloats * sizeof(float);
  const unsigned grid = (unsigned)items_bound(B, S, U, cap);
  cudaError_t err;
  if (vec4) {
    err = set_smem<true>();
    if (err != cudaSuccess) return (int)err;
    score_kernel<true><<<grid, kThreads, smem, st>>>(
        q, blocks, s.order, s.items, s.n_items, out, S, cap, dim);
  } else {
    err = set_smem<false>();
    if (err != cudaSuccess) return (int)err;
    score_kernel<false><<<grid, kThreads, smem, st>>>(
        q, blocks, s.order, s.items, s.n_items, out, S, cap, dim);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
