// Selected-cluster scoring kernel for Hopper (sm_90a): the v1 "dot" tail
// of CluSD serving (paper Step 3, the partial dense retrieval).
//
// Replaces cluster_score_pallas (src/repro/kernels/cluster_score/
// kernel.py, _score_kernel):
//   scores[b, s, c] = blocks[sel[b, s], c, :] . q[b, :]
// over the batch's deduplicated float32 blocks (U, cap, dim) on the card
// and each slot's position sel (B, S) among them. The TPU kernel let the
// DMA engine gather block sel[b, s] into VMEM through a scalar-prefetch
// index map and ran one MXU matvec per slot; here a CTA reads its block
// from global memory itself, so the (B, S, cap, dim) gather is never
// materialised (6.4 GB at B 256, S 32, cap 256, dim 768).
//
// Design (simple first): one CTA of 256 threads per (b, s). q[b] is
// staged in shared memory (dim floats, 3 KB at dim 768). Each warp takes
// rows c = warp, warp + 8, ... of the block; its lanes read the row with
// coalesced 16-byte float4 loads along dim and accumulate in fp32 with
// FMA (no tensor cores, no TF32); a warp-shuffle reduction finishes the
// row. A slot whose position is out of [0, U) scores NaN.
//
// What bounds it on the H100: bytes. The unique blocks are read once at
// best, (U*cap*dim + B*dim + B*S*cap) * 4 bytes, about 4.1 GB at U 5173:
// 1.2 ms at 3.35 TB/s; the 3.2 GFLOP are 0.05 ms at 67 TFLOP/s. This
// (b, s)-major order re-reads a block once per slot that selects it, so
// with no reuse in the 50 MB L2 it moves the full 6.4 GB: grouping the
// queries that share a block, TMA and wgmma are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
cluster_score_kernel(const float* __restrict__ q,
                     const float* __restrict__ blocks,
                     const int32_t* __restrict__ sel,
                     float* __restrict__ out,
                     int S, int U, int cap, int dim, int vec4) {
  extern __shared__ float q_s[];                       // dim floats
  const int bs = blockIdx.x;                           // b * S + s
  const int b = bs / S;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const float* qb = q + (size_t)b * dim;
  if (vec4) {
    const float4* src = reinterpret_cast<const float4*>(qb);
    float4* dst = reinterpret_cast<float4*>(q_s);
    for (int i = tid; i < dim / 4; i += kThreads) dst[i] = src[i];
  } else {
    for (int i = tid; i < dim; i += kThreads) q_s[i] = qb[i];
  }
  __syncthreads();

  const int u = sel[bs];
  float* o = out + (size_t)bs * cap;
  if (u < 0 || u >= U) {                               // uniform per CTA
    for (int c = tid; c < cap; c += kThreads) {
      o[c] = __int_as_float(0x7fc00000);
    }
    return;
  }
  const float* blk = blocks + (size_t)u * cap * dim;
  for (int c = warp; c < cap; c += kWarps) {
    const float* row = blk + (size_t)c * dim;
    float acc = 0.0f;
    if (vec4) {
      const float4* r4 = reinterpret_cast<const float4*>(row);
      const float4* q4 = reinterpret_cast<const float4*>(q_s);
#pragma unroll 4
      for (int i = lane; i < dim / 4; i += 32) {
        const float4 x = __ldg(r4 + i);
        const float4 y = q4[i];
        acc = fmaf(x.x, y.x, acc);
        acc = fmaf(x.y, y.y, acc);
        acc = fmaf(x.z, y.z, acc);
        acc = fmaf(x.w, y.w, acc);
      }
    } else {
      for (int i = lane; i < dim; i += 32) {
        acc = fmaf(__ldg(row + i), q_s[i], acc);
      }
    }
    acc = warp_sum(acc);
    if (lane == 0) o[c] = acc;
  }
}

}  // namespace

extern "C" {

size_t cluster_score_smem_bytes(int dim) {
  return (size_t)dim * sizeof(float);
}

// q: (B, dim) f32; blocks: (U, cap, dim) f32; sel: (B, S) i32 with
// 0 <= sel < U; out: (B, S, cap) f32. All contiguous on one device.
int cluster_score_launch(const float* q, const float* blocks,
                         const int32_t* sel, float* out, int B, int S,
                         int U, int cap, int dim, void* stream) {
  if (B == 0 || S == 0 || cap == 0) return 0;
  const size_t smem = cluster_score_smem_bytes(dim);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        cluster_score_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int vec4 = (dim % 4 == 0)
      && (reinterpret_cast<uintptr_t>(q) % 16 == 0)
      && (reinterpret_cast<uintptr_t>(blocks) % 16 == 0);
  const long long grid = (long long)B * S;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cluster_score_kernel<<<(unsigned)grid, kThreads, smem,
                         (cudaStream_t)stream>>>(q, blocks, sel, out, S, U,
                                                 cap, dim, vec4);
  return (int)cudaGetLastError();
}

}  // extern "C"
