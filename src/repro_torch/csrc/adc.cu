// ADC (asymmetric distance computation) kernels for PQ code scoring on
// Hopper (sm_90a): the LUT build and the code-block scorer of the v2
// serving path.
//
// adc_tables replaces adc_tables_pallas (src/repro/kernels/adc/kernel.py,
// _tables_kernel): lut[b, j, k] = codebooks[j, k, :] . q_rot[b, j*dsub:
// (j+1)*dsub]. Bound on the H100: bytes — it writes B*nsub*K floats (25
// MB at B=256, nsub=96, K=256) and does 2*dsub flops per float written.
// Grid (nsub, ceil(B / TB)): a block takes subspace j for a tile of TB
// queries, so codebook j is read once per tile (6.3 MB from L2 at B=256,
// TB=32, not once per query) and a few hundred blocks fill the card.
// The tile's sub-vectors sit in shared memory (read as broadcasts);
// thread k holds codebook row k in registers and writes out[b, j, k] for
// each query of the tile, so a warp stores 128 contiguous bytes. dsub 4,
// 8 and 16 (dim / nsub of the smoke and full configs) are compiled as
// constants (the dot unrolled, four queries in flight); other lengths
// read the L1-cached codebook. Each dot is
// q[0]*c[0], then + q[d]*c[d] for ascending d, with separate multiply and
// add (no FMA): bitwise the plain version (ref.py).
//
// adc_score_blocks replaces adc_score_blocks_pallas (same file,
// _score_kernel): score[b, s, c] = sum_{j ascending} lut[b, j,
// codes[sel[b, s], c, j]]. The TPU kernel turned the gather into a
// one-hot MXU product because a gather does not lower there; here the
// gather is native. One block per query: the query's (nsub, K) LUT is
// staged once in shared memory (96 KB at nsub=96, so dynamic shared
// memory above the 48 KB default) and serves all S selected slots, up to
// 512 / cap of them at once (2 at cap 256), and two such blocks share an
// SM, so one block's LUT copy overlaps the other's gathers. A (cap, nsub)
// code block is row-major, so thread c reads its own code row straight
// into registers: 16-byte loads where nsub % 16 == 0 and the base is
// aligned (6 uint4 at nsub 96, all issued before the first lookup), else
// bytes; nothing is staged or transposed through shared memory.
// Thread c adds lut[j][code] for ascending j into one fp32 register with
// __fadd_rn (no FMA): the result is bitwise the plain version's. Bounds
// on the H100: the bytes (the unique code blocks that sel reaches, the
// LUTs, the (B, S, cap) output) and the shared-memory gathers, B*S*cap*
// nsub lookups at 32 per SM per clock without bank conflicts. Uniform
// random codes put about 3.5 lanes of a warp on one bank, and then the
// gathers bind (PERF.md): a copy of the codes staged through shared
// memory (cp.async), and more warps per SM, were tried and were not
// faster.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTablesTile = 32;   // queries per block

// kDsub > 0: the sub-vector length at compile time, codebook row k in
// registers and the dot unrolled; kDsub == 0: any dsub, read from the
// L1-cached codebook.
template <int kDsub>
__global__ void adc_tables_kernel(const float* __restrict__ q,
                                  const float* __restrict__ books,
                                  float* __restrict__ out,
                                  int B, int nsub, int K, int dsub_rt) {
  const int dsub = kDsub > 0 ? kDsub : dsub_rt;
  extern __shared__ float qs[];                  // kTablesTile * dsub
  const int j = blockIdx.x;
  const int b0 = blockIdx.y * kTablesTile;
  const int tb = min(kTablesTile, B - b0);
  const size_t dim = (size_t)nsub * dsub;
  for (int i = threadIdx.x; i < tb * dsub; i += blockDim.x) {
    const int bb = i / dsub;
    qs[i] = q[(b0 + bb) * dim + (size_t)j * dsub + (i - bb * dsub)];
  }
  __syncthreads();
  const size_t ostride = (size_t)nsub * K;       // out[b + 1] - out[b]
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const float* c = books + ((size_t)j * K + k) * dsub;
    float* o = out + (size_t)b0 * ostride + (size_t)j * K + k;
    if (kDsub > 0) {
      float cr[kDsub > 0 ? kDsub : 1];
#pragma unroll
      for (int d = 0; d < kDsub; ++d) cr[d] = c[d];
#pragma unroll 4
      for (int bb = 0; bb < tb; ++bb) {
        const float* qb = qs + bb * kDsub;
        float acc = __fmul_rn(qb[0], cr[0]);
#pragma unroll
        for (int d = 1; d < kDsub; ++d)
          acc = __fadd_rn(acc, __fmul_rn(qb[d], cr[d]));
        o[bb * ostride] = acc;
      }
    } else {
      for (int bb = 0; bb < tb; ++bb) {
        const float* qb = qs + bb * dsub;
        float acc = __fmul_rn(qb[0], c[0]);
        for (int d = 1; d < dsub; ++d) {
          acc = __fadd_rn(acc, __fmul_rn(qb[d], c[d]));
        }
        o[bb * ostride] = acc;
      }
    }
  }
}

template <int kDsub>
cudaError_t launch_tables(const float* q, const float* books, float* out,
                          int B, int nsub, int K, int dsub,
                          cudaStream_t stream) {
  const int threads = K < 256 ? ((K + 31) / 32) * 32 : 256;
  const size_t smem = (size_t)kTablesTile * dsub * sizeof(float);
  dim3 grid(nsub, (B + kTablesTile - 1) / kTablesTile);
  adc_tables_kernel<kDsub><<<grid, threads, smem, stream>>>(
      q, books, out, B, nsub, K, dsub);
  return cudaGetLastError();
}

constexpr int kScoreThreads = 512;   // a block's threads: slots x rows

// Four subspaces j..j+3 of one code row: the word's bytes are their codes,
// lut_j is row j of the staged (nsub, 256) LUT. Added in ascending j.
__device__ __forceinline__ float add4(float acc, const float* lut_j,
                                      uint32_t w) {
  acc = __fadd_rn(acc, lut_j[w & 0xffu]);
  acc = __fadd_rn(acc, lut_j[256 + ((w >> 8) & 0xffu)]);
  acc = __fadd_rn(acc, lut_j[512 + ((w >> 16) & 0xffu)]);
  acc = __fadd_rn(acc, lut_j[768 + (w >> 24)]);
  return acc;
}

// Thread c reads its own code row straight into registers. kVec16 (nsub %
// 16 == 0, 16-byte aligned codes, K == 256): uint4 loads, 128 subspaces at
// a time, all of those loads issued before the first lookup. Otherwise
// one byte at a time, any nsub, K and base.
template <bool kVec16>
__global__ void __launch_bounds__(kScoreThreads, 2)
adc_score_kernel(const float* __restrict__ lut,
                 const uint8_t* __restrict__ codes,
                 const int32_t* __restrict__ sel, float* __restrict__ out,
                 int S, int U, int cap, int nsub, int K, int row_threads) {
  extern __shared__ float lut_s[];                       // nsub * K floats
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;

  const int n_lut = nsub * K;
  const float* lut_b = lut + (size_t)b * n_lut;
  if ((n_lut & 3) == 0 && (reinterpret_cast<uintptr_t>(lut) & 15) == 0) {
    const float4* src = reinterpret_cast<const float4*>(lut_b);
    float4* dst = reinterpret_cast<float4*>(lut_s);
    for (int i = tid; i < n_lut / 4; i += nt) dst[i] = src[i];
  } else {
    for (int i = tid; i < n_lut; i += nt) lut_s[i] = lut_b[i];
  }
  __syncthreads();

  const int groups = nt / row_threads;                   // slots at once
  const int g = tid / row_threads;
  const int c0 = tid - g * row_threads;
  for (int s = g; s < S; s += groups) {
    const int u = sel[(size_t)b * S + s];
    const bool ok = (u >= 0) && (u < U);   // uniform across the slot group
    float* o = out + ((size_t)b * S + s) * cap;
    for (int c = c0; c < cap; c += row_threads) {
      if (!ok) {
        o[c] = __int_as_float(0x7fc00000);   // NaN: slot index out of range
        continue;
      }
      const uint8_t* row = codes + ((size_t)u * cap + c) * nsub;
      float acc = 0.0f;
      if constexpr (kVec16) {
        const uint4* r4 = reinterpret_cast<const uint4*>(row);
        for (int j0 = 0; j0 < nsub; j0 += 128) {
          uint4 v[8];
#pragma unroll
          for (int q = 0; q < 8; ++q)
            if (j0 + 16 * q < nsub) v[q] = __ldg(r4 + j0 / 16 + q);
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            if (j0 + 16 * q < nsub) {
              const float* l = lut_s + (j0 + 16 * q) * 256;
              acc = add4(acc, l, v[q].x);
              acc = add4(acc, l + 1024, v[q].y);
              acc = add4(acc, l + 2048, v[q].z);
              acc = add4(acc, l + 3072, v[q].w);
            }
          }
        }
      } else {
        for (int j = 0; j < nsub; ++j)
          acc = __fadd_rn(acc, lut_s[j * K + __ldg(row + j)]);
      }
      o[c] = acc;
    }
  }
}

template <bool kVec16>
cudaError_t launch_score(const float* lut, const uint8_t* codes,
                         const int32_t* sel, float* out, int B, int S, int U,
                         int cap, int nsub, int K, cudaStream_t stream) {
  const size_t smem = (size_t)nsub * K * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      adc_score_kernel<kVec16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  int row_threads = ((cap + 31) / 32) * 32;
  if (row_threads > kScoreThreads) row_threads = kScoreThreads;
  int groups = kScoreThreads / row_threads;
  if (groups > S) groups = S;
  adc_score_kernel<kVec16><<<B, groups * row_threads, smem, stream>>>(
      lut, codes, sel, out, S, U, cap, nsub, K, row_threads);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q: (B, nsub*dsub) f32, already rotated; books: (nsub, K, dsub) f32;
// out: (B, nsub, K) f32.
int adc_tables_launch(const float* q, const float* books, float* out,
                      int B, int nsub, int K, int dsub, void* stream) {
  if (B == 0 || nsub == 0 || K == 0) return 0;
  if (dsub < 1 || (size_t)kTablesTile * dsub * sizeof(float) > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dsub) {
    case 4: return (int)launch_tables<4>(q, books, out, B, nsub, K, 4, s);
    case 8: return (int)launch_tables<8>(q, books, out, B, nsub, K, 8, s);
    case 16: return (int)launch_tables<16>(q, books, out, B, nsub, K, 16, s);
    default: return (int)launch_tables<0>(q, books, out, B, nsub, K, dsub, s);
  }
}

size_t adc_score_smem_bytes(int cap, int nsub, int K) {
  (void)cap;   // the code rows are read into registers, not staged
  return (size_t)nsub * K * sizeof(float);
}

// lut: (B, nsub, K) f32; codes: (U, cap, nsub) u8; sel: (B, S) i32 with
// 0 <= sel < U (a slot out of range scores NaN); out: (B, S, cap) f32.
int adc_score_blocks_launch(const float* lut, const uint8_t* codes,
                            const int32_t* sel, float* out, int B, int S,
                            int U, int cap, int nsub, int K, void* stream) {
  if (B == 0 || S == 0 || cap == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const uintptr_t base = reinterpret_cast<uintptr_t>(codes);
  if (K == 256 && nsub % 16 == 0 && (base & 15) == 0)
    return (int)launch_score<true>(lut, codes, sel, out, B, S, U, cap, nsub,
                                   K, s);
  return (int)launch_score<false>(lut, codes, sel, out, B, S, U, cap, nsub, K,
                                  s);
}

}  // extern "C"
