// Stage-I overlap features for Hopper (sm_90a): for each query, P[c, j]
// = how many of its sparse top-k results fall in cluster c and rank bin
// j, and Q[c, j] = the mean (normalised) sparse score of those results
// (paper section 2.2).
//
// Replaces bin_overlap_pallas (src/repro/kernels/bin_overlap/kernel.py,
// _overlap_kernel). The TPU kernel kept the (N, v) accumulators in VMEM
// and folded the k results in as one-hot (N, k) matrix products per bin,
// because a scatter does not lower there. On the card a scatter does,
// but atomics would add a slot's scores in no fixed order. So:
//
//   one CTA per query zero-fills its N*v rows of P and Q with coalesced
//   float4 stores; it sorts its k (slot, rank) pairs in shared memory by
//   slot, then rank (a bitonic sort of 64-bit composites); then the first
//   entry of each run of equal slots sums the run's scores in ascending
//   rank order, from 0.0, in one thread, and writes P (the run's length)
//   and Q = sum / max(P, 1).
//
// That is the order of the CPU's sequential scatter_add_ and of XLA's
// CPU segment_sum, so P and Q are bitwise the plain version's and the
// JAX reference's. There are no atomics. Slots outside [0, N*v) are
// dropped, as segment_sum drops them.
//
// What bounds it on the H100: bytes, nearly all of them the zero-filled
// P and Q (2 * B * N * v * 4 bytes: 117 MB at B 256, N 8192, v 7, 0.035
// ms at 3.35 TB/s); the k results per query are 12 KB of reads.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxK = 2048;
constexpr unsigned long long kPad = ~0ull;

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

__global__ void __launch_bounds__(kThreads)
bin_overlap_kernel(const int32_t* __restrict__ cluster_of,
                   const int32_t* __restrict__ bin_ids, int bin_row_stride,
                   const float* __restrict__ scores, float* __restrict__ P,
                   float* __restrict__ Q, int k, int v, int n_slots,
                   int np, int vec4) {
  extern __shared__ unsigned long long comp[];        // np composites
  float* sc = reinterpret_cast<float*>(comp + np);    // k scores
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  float* Pb = P + (size_t)b * n_slots;
  float* Qb = Q + (size_t)b * n_slots;
  if (vec4) {
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    float4* P4 = reinterpret_cast<float4*>(Pb);
    float4* Q4 = reinterpret_cast<float4*>(Qb);
    for (int i = tid; i < n_slots / 4; i += kThreads) {
      P4[i] = z;
      Q4[i] = z;
    }
  } else {
    for (int i = tid; i < n_slots; i += kThreads) {
      Pb[i] = 0.0f;
      Qb[i] = 0.0f;
    }
  }
  const int32_t* cb = cluster_of + (size_t)b * k;
  const int32_t* bb = bin_ids + (size_t)b * bin_row_stride;
  const float* sb = scores + (size_t)b * k;
  for (int i = tid; i < np; i += kThreads) {
    unsigned long long c = kPad;
    if (i < k) {
      sc[i] = sb[i];
      const long long slot = (long long)cb[i] * v + bb[i];
      if (slot >= 0 && slot < n_slots) {
        c = ((unsigned long long)slot << 32) | (uint32_t)i;
      }
    }
    comp[i] = c;
  }
  // the sort's barriers also order the zero-fill before the writes below
  bitonic_sort(comp, np);
  for (int i = tid; i < k; i += kThreads) {
    const unsigned long long c = comp[i];
    if (c == kPad) continue;
    const uint32_t slot = (uint32_t)(c >> 32);
    if (i > 0 && (uint32_t)(comp[i - 1] >> 32) == slot) continue;
    float sum = 0.0f;
    int n = 0;
    for (int j = i; j < k; ++j) {
      const unsigned long long cj = comp[j];
      if (cj == kPad || (uint32_t)(cj >> 32) != slot) break;
      sum = __fadd_rn(sum, sc[(uint32_t)(cj & 0xffffffffu)]);
      ++n;
    }
    const float cnt = (float)n;
    Pb[slot] = cnt;
    Qb[slot] = __fdiv_rn(sum, fmaxf(cnt, 1.0f));
  }
}

int next_pow2(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

}  // namespace

extern "C" {

int bin_overlap_max_k() { return kMaxK; }

// cluster_of (B, k) i32; bin_ids (k,) i32 (bin_row_stride 0) or (B, k)
// (bin_row_stride k); scores (B, k) f32; P, Q (B, n_clusters * v) f32.
// All contiguous on one device; 1 <= k <= kMaxK.
int bin_overlap_launch(const int32_t* cluster_of, const int32_t* bin_ids,
                       int bin_row_stride, const float* scores, float* P,
                       float* Q, int B, int k, int n_clusters, int v,
                       void* stream) {
  if (B == 0) return 0;
  if (k < 1 || k > kMaxK || v < 1 || n_clusters < 1)
    return (int)cudaErrorInvalidValue;
  const long long n_slots = (long long)n_clusters * v;
  if (n_slots >= 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int np = next_pow2(k);
  const size_t smem = (size_t)np * sizeof(unsigned long long)
                      + (size_t)k * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        bin_overlap_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int vec4 = (n_slots % 4 == 0)
      && (reinterpret_cast<uintptr_t>(P) % 16 == 0)
      && (reinterpret_cast<uintptr_t>(Q) % 16 == 0);
  bin_overlap_kernel<<<(unsigned)B, kThreads, smem, (cudaStream_t)stream>>>(
      cluster_of, bin_ids, bin_row_stride, scores, P, Q, k, v,
      (int)n_slots, np, vec4);
  return (int)cudaGetLastError();
}

}  // extern "C"
