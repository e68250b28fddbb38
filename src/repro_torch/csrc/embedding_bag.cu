// Sum-pooled embedding bag for Hopper (sm_90a): out[b] = sum over h of
// table[idx[b, h]], h ascending, for a (V, d) float32 or bfloat16 table
// and (B, hot) int32 indices. The recsys path's bags: the wide branch
// (B 512 or 262,144, hot 40, d 1), the user tower (B 1, hot 20, d 32),
// the CluSD guide (B 1,048,576, hot 2, d 1) and the candidate tower
// (B 1,048,576, hot 2, d 32), each over one fused table that holds every
// field's rows at a row offset per field.
//
// Replaces embedding_bag_pallas (src/repro/kernels/embedding_bag/
// kernel.py, _bag_kernel). The TPU kernel DMA'd one table row per (b, h)
// grid step through a scalar-prefetch index_map and added it into the
// output block across the sequential hot axis. A CUDA grid has no
// sequential axis, so the hot loop runs inside a thread:
//
//   `lpb` lanes (a power of two up to 32) share a bag row: its d
//   columns, or its d / 4 float4 columns when d % 4 == 0 and the table
//   is float32 and 16-byte aligned. Each lane keeps one fp32 accumulator
//   per column, starts it at 0.0f, adds its bag's rows in ascending h
//   with __fadd_rn and casts to the table's dtype on store. For a
//   float32 table that is the plain version's order and the JAX
//   package's Python sum of lookups, bit for bit.
//
//   Many bags (the guide, the candidate tower, the bulk wide bag): a bag
//   row's lpb lanes walk its positions one after another; the grid's
//   warps keep the loads in flight. Few bags (up to 2048: the user tower,
//   the 512-row wide bag): a grid that small cannot hide the row loads'
//   latency, so a whole warp takes a bag. Its 32 / lpb slices load the
//   rows of different positions together, and every slice then adds them
//   in ascending h, taking each by a shuffle: the same order, in a third
//   to a half of the time.
//
//   Every index is checked against [0, V) where it is read. An index
//   outside is never dereferenced (row 0 is read in its place): the
//   kernel writes it into the call's error word, an 8-byte device word
//   that the wrapper zeroes on the call's stream before the launch and
//   reads back once that stream has finished. Each call has its own
//   word, so calls on other threads or streams never see its error. The
//   range check costs no extra pass over the indices (one 8-byte fill
//   per call). Carried through the
//   one-pass loop it does cost that loop nvcc's 4-way unrolling (the
//   row loads go out in pairs), which the warp per bag more than makes
//   up where latency counts. A tiled variant (indices staged in shared
//   memory, several bags a lane), chunked and ordered loads, a check
//   after the loop and NaN-poisoned loads were tried on the card and
//   lost elsewhere (PERF.md).
//
// What bounds it on the H100: bytes. It does one add per element read;
// each read is a table row picked by the data, so the least traffic is
// the distinct rows it touches (heavy-tailed ids hit in L2), plus the
// indices, plus the output. A random 4-byte row still costs a whole
// 32-byte sector, so at d 1 the sectors the ids touch are the floor. The
// guide's 2M uniform rows over 80 MB run at the card's rate for random
// sector reads, about 3x that floor, whatever is in flight (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// Warp per bag up to kWarpPerBagMaxBags bags (measured crossover on the
// H100, PERF.md); kRounds row loads a lane in flight there: the user
// tower's 20 positions in one chunk of 4 slices x 5.
constexpr int kRounds = 5;
constexpr long long kWarpPerBagMaxBags = 2048;

// The element a lane reads (V) and its fp32 accumulator.
__device__ __forceinline__ float zero_acc(float) { return 0.0f; }
__device__ __forceinline__ float zero_acc(__nv_bfloat16) { return 0.0f; }
__device__ __forceinline__ float4 zero_acc(float4) {
  return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}
__device__ __forceinline__ float add(float a, float x) {
  return __fadd_rn(a, x);
}
__device__ __forceinline__ float add(float a, __nv_bfloat16 x) {
  return __fadd_rn(a, __bfloat162float(x));
}
__device__ __forceinline__ float4 add(float4 a, float4 x) {
  return make_float4(__fadd_rn(a.x, x.x), __fadd_rn(a.y, x.y),
                     __fadd_rn(a.z, x.z), __fadd_rn(a.w, x.w));
}
template <typename V> struct Acc { using type = float; };
template <> struct Acc<float4> { using type = float4; };
template <typename V>
__device__ __forceinline__ V cast_out(typename Acc<V>::type a) { return a; }
template <>
__device__ __forceinline__ __nv_bfloat16 cast_out<__nv_bfloat16>(float a) {
  return __float2bfloat16_rn(a);
}

// An index in [0, rows) as it is; any other picks row 0 (never read into
// a result the caller sees: the wrapper raises) and is kept in `bad`.
__device__ __forceinline__ int32_t checked(int32_t id, long long rows,
                                           bool& any_bad, int32_t& bad) {
  const bool ok = id >= 0 && id < rows;
  any_bad |= !ok;
  bad = ok ? bad : id;
  return ok ? id : 0;
}

// Many bags: lane `lane` of bag b owns columns lane, lane + lpb, ...; it
// reads the bag's indices from global memory and adds its rows in
// ascending h.
template <typename V>
__global__ void __launch_bounds__(kThreads)
bag_kernel(const V* __restrict__ table, const int32_t* __restrict__ idx,
           V* __restrict__ out, long long B, int hot, int cols,
           long long rows, int lpb_log2, unsigned long long* err) {
  using A = typename Acc<V>::type;
  const long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long b = g >> lpb_log2;
  if (b >= B) return;
  const int lpb = 1 << lpb_log2;
  const int lane = (int)(g & (lpb - 1));
  const int32_t* ib = idx + b * hot;
  bool any_bad = false;
  int32_t bad = 0;
  for (int c = lane; c < cols; c += lpb) {
    A acc = zero_acc(V());
    for (int h = 0; h < hot; ++h) {
      const int32_t id = checked(ib[h], rows, any_bad, bad);
      acc = add(acc, table[(size_t)id * cols + c]);
    }
    out[b * cols + c] = cast_out<V>(acc);
  }
  if (any_bad)     // the wrapper raises on it
    *(volatile unsigned long long*)err = (1ull << 32) | (uint32_t)bad;
}

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float4 widen(float4 x) { return x; }
__device__ __forceinline__ float shfl(float v, int src) {
  return __shfl_sync(0xffffffffu, v, src);
}
__device__ __forceinline__ float4 shfl(float4 v, int src) {
  return make_float4(__shfl_sync(0xffffffffu, v.x, src),
                     __shfl_sync(0xffffffffu, v.y, src),
                     __shfl_sync(0xffffffffu, v.z, src),
                     __shfl_sync(0xffffffffu, v.w, src));
}

// Few bags: a warp per bag. Its lanes are S = 32 / lpc slices of lpc
// lanes; slice s loads the rows of positions s, s + S, ..., kRounds of
// them at a time, all in flight together, and every slice then adds the
// chunk's rows in ascending h, taking each from its slice by a shuffle.
// Slice 0 stores.
template <typename V>
__global__ void __launch_bounds__(kThreads)
bag_warp_kernel(const V* __restrict__ table, const int32_t* __restrict__ idx,
                V* __restrict__ out, long long B, int hot, int cols,
                long long rows, int lpc_log2, unsigned long long* err) {
  using A = typename Acc<V>::type;
  const long long b = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  if (b >= B) return;                    // whole warps
  const int lane = threadIdx.x & 31;
  const int lpc = 1 << lpc_log2;
  const int S = 32 >> lpc_log2;
  const int cl = lane & (lpc - 1), slice = lane >> lpc_log2;
  const int32_t* ib = idx + b * hot;
  bool any_bad = false;
  int32_t bad = 0;
  for (int c0 = 0; c0 < cols; c0 += lpc) {
    const int c = c0 + cl;
    A acc = zero_acc(V());
    for (int h0 = 0; h0 < hot; h0 += kRounds * S) {
      A x[kRounds];
#pragma unroll
      for (int q = 0; q < kRounds; ++q) {
        const int h = h0 + q * S + slice;
        const bool use = h < hot && c < cols;
        const int32_t id = checked(use ? ib[h] : 0, rows, any_bad, bad);
        x[q] = use ? widen(table[(size_t)id * cols + c]) : zero_acc(V());
      }
#pragma unroll
      for (int q = 0; q < kRounds; ++q)
        for (int t = 0; t < S && h0 + q * S + t < hot; ++t)
          acc = add(acc, shfl(x[q], (t << lpc_log2) + cl));
    }
    if (slice == 0 && c < cols) out[b * cols + c] = cast_out<V>(acc);
  }
  if (any_bad)     // the wrapper raises on it
    *(volatile unsigned long long*)err = (1ull << 32) | (uint32_t)bad;
}

int lanes_log2(int cols) {
  int l = 0;
  while (l < 5 && (1 << l) < cols) ++l;
  return l;
}

template <typename V>
int launch_bags(const void* table, const int32_t* idx, void* out,
                long long B, int hot, int cols, long long rows,
                unsigned long long* err, cudaStream_t stream) {
  const int l = lanes_log2(cols);
  const long long blocks = ((B << l) + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (B <= kWarpPerBagMaxBags && l < 5) {
    bag_warp_kernel<V><<<(unsigned)((B * 32 + kThreads - 1) / kThreads),
                         kThreads, 0, stream>>>(
        static_cast<const V*>(table), idx, static_cast<V*>(out), B, hot,
        cols, rows, l, err);
    return (int)cudaGetLastError();
  }
  bag_kernel<V><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const V*>(table), idx, static_cast<V*>(out), B, hot, cols,
      rows, l, err);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// table (V, d) with V = rows, out (B, d): float32 (dtype 0) or bfloat16
// (dtype 1); idx (B, hot) int32; err the call's zeroed 8-byte error word,
// left 0 or set to (1 << 32) | the bad index as uint32. All contiguous
// on one device; B >= 0, hot >= 0, d >= 1, rows >= 0.
int embedding_bag_launch(const void* table, const int32_t* idx, void* out,
                         long long B, int hot, int d, long long rows,
                         int dtype, void* err, void* stream) {
  if (B == 0) return 0;
  if (B < 0 || hot < 0 || d < 1 || rows < 0 || err == nullptr
      || (rows == 0 && hot > 0))
    return (int)cudaErrorInvalidValue;
  auto* e = static_cast<unsigned long long*>(err);
  auto s = (cudaStream_t)stream;
  if (dtype == 0) {
    if (d % 4 == 0 && reinterpret_cast<uintptr_t>(table) % 16 == 0
        && reinterpret_cast<uintptr_t>(out) % 16 == 0)
      return launch_bags<float4>(table, idx, out, B, hot, d / 4, rows, e, s);
    return launch_bags<float>(table, idx, out, B, hot, d, rows, e, s);
  }
  if (dtype == 1)
    return launch_bags<__nv_bfloat16>(table, idx, out, B, hot, d, rows, e,
                                      s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
