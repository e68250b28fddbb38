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
//   each thread owns some columns of one bag row. It keeps one fp32
//   accumulator per column, starts it at 0.0f, adds the hot rows in
//   ascending h with __fadd_rn, and casts to the table's dtype on store.
//   For a float32 table that is the plain version's order and the JAX
//   package's Python sum of lookups, bit for bit. Nothing materialises
//   the (B, hot, d) gather.
//
//   A bag row gets `lpb` lanes (a power of two up to 32), enough to cover
//   its d columns, or its d / 4 float4 columns when d % 4 == 0 and the
//   table is float32 and 16-byte aligned. Rows of d >= 32 (>= 128 with
//   float4) take a whole warp that strides along d; small rows share a
//   warp: at d 1 each lane is a bag, so no lanes sit idle on the 1M
//   one-float guide rows.
//
// What bounds it on the H100: bytes. It does one add per element read;
// each read is a table row picked by the data, so the least traffic is
// the distinct rows it touches (heavy-tailed ids hit in L2), plus the
// indices, plus the output.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// One lane: columns lane, lane + lpb, ... of bag row b.
template <typename T>
__global__ void __launch_bounds__(kThreads)
bag_kernel(const T* __restrict__ table, const int32_t* __restrict__ idx,
           T* __restrict__ out, long long B, int hot, int d, int lpb_log2) {
  const long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long b = g >> lpb_log2;
  if (b >= B) return;
  const int lpb = 1 << lpb_log2;
  const int lane = (int)(g & (lpb - 1));
  const int32_t* ib = idx + b * hot;
  for (int c = lane; c < d; c += lpb) {
    float acc = 0.0f;
    for (int h = 0; h < hot; ++h) {
      acc = __fadd_rn(acc, to_f32(table[(size_t)ib[h] * d + c]));
    }
    store(out + b * d + c, acc);
  }
}

// float32 rows read as float4: column c4 covers columns 4 c4 .. 4 c4 + 3.
__global__ void __launch_bounds__(kThreads)
bag_kernel_f4(const float4* __restrict__ table,
              const int32_t* __restrict__ idx, float4* __restrict__ out,
              long long B, int hot, int d4, int lpb_log2) {
  const long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long b = g >> lpb_log2;
  if (b >= B) return;
  const int lpb = 1 << lpb_log2;
  const int lane = (int)(g & (lpb - 1));
  const int32_t* ib = idx + b * hot;
  for (int c = lane; c < d4; c += lpb) {
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int h = 0; h < hot; ++h) {
      const float4 v = table[(size_t)ib[h] * d4 + c];
      acc.x = __fadd_rn(acc.x, v.x);
      acc.y = __fadd_rn(acc.y, v.y);
      acc.z = __fadd_rn(acc.z, v.z);
      acc.w = __fadd_rn(acc.w, v.w);
    }
    out[b * d4 + c] = acc;
  }
}

int lanes_log2(int cols) {
  int l = 0;
  while (l < 5 && (1 << l) < cols) ++l;
  return l;
}

template <typename K, typename... Args>
int launch(K kernel, long long B, int lpb_log2, void* stream,
           Args... args) {
  const long long threads = B << lpb_log2;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      args..., lpb_log2);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// table (V, d), out (B, d): float32 (dtype 0) or bfloat16 (dtype 1);
// idx (B, hot) int32 with every entry in [0, V) (checked by the caller).
// All contiguous on one device; B >= 0, hot >= 0, d >= 1.
int embedding_bag_launch(const void* table, const int32_t* idx, void* out,
                         long long B, int hot, int d, int dtype,
                         void* stream) {
  if (B == 0) return 0;
  if (B < 0 || hot < 0 || d < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    if (d % 4 == 0 && reinterpret_cast<uintptr_t>(table) % 16 == 0
        && reinterpret_cast<uintptr_t>(out) % 16 == 0) {
      const int l = lanes_log2(d / 4);
      return launch(bag_kernel_f4, B, l, stream,
                    static_cast<const float4*>(table), idx,
                    static_cast<float4*>(out), B, hot, d / 4);
    }
    const int l = lanes_log2(d);
    return launch(bag_kernel<float>, B, l, stream,
                  static_cast<const float*>(table), idx,
                  static_cast<float*>(out), B, hot, d);
  }
  if (dtype == 1) {
    const int l = lanes_log2(d);
    return launch(bag_kernel<__nv_bfloat16>, B, l, stream,
                  static_cast<const __nv_bfloat16*>(table), idx,
                  static_cast<__nv_bfloat16*>(out), B, hot, d);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
