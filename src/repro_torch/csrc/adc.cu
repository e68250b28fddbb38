// ADC (asymmetric distance computation) kernels for PQ code scoring on
// Hopper (sm_90a): the LUT build and the code-block scorer of the v2
// serving path.
//
// adc_tables replaces adc_tables_pallas (src/repro/kernels/adc/kernel.py,
// _tables_kernel): lut[b, j, k] = codebooks[j, k, :] . q_rot[b, j*dsub:
// (j+1)*dsub]. Grid (B, nsub), one thread per code k. Bound on the H100:
// bytes — it writes B*nsub*K floats (25 MB at B=256, nsub=96) and does
// 2*dsub flops per float written. Threads of a block write consecutive k,
// so the stores coalesce; each thread's dsub-long dot is summed in order
// with separate multiply and add (no FMA), which is exactly what the
// plain version (ref.py) does.
//
// adc_score_blocks replaces adc_score_blocks_pallas (same file,
// _score_kernel): score[b, s, c] = sum_{j ascending} lut[b, j,
// codes[sel[b, s], c, j]]. The TPU kernel turned the gather into a
// one-hot MXU product because a gather does not lower there; here the
// gather is native. One block per query: the query's (nsub, K) LUT is
// staged once in shared memory (96 KB at nsub=96, so dynamic shared
// memory above the 48 KB default) and serves all S selected slots. Each
// slot's (cap, nsub) uint8 code block is read from global memory with
// coalesced 4-byte loads and staged transposed, [j][c], so that thread c
// reads code j of its slot from consecutive bytes. Thread c adds
// lut[j][code] for ascending j into one fp32 register with no FMA: the
// result is bitwise the plain version's. Bound on the H100: bytes — the
// unique code blocks (up to B*S*cap*nsub bytes) plus the LUTs and the
// (B, S, cap) output; the shared-memory gathers are the next limit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void adc_tables_kernel(const float* __restrict__ q,
                                  const float* __restrict__ books,
                                  float* __restrict__ out,
                                  int nsub, int K, int dsub) {
  const int b = blockIdx.x;
  const int j = blockIdx.y;
  const float* qs = q + (size_t)b * nsub * dsub + (size_t)j * dsub;
  float* o = out + ((size_t)b * nsub + j) * K;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const float* c = books + ((size_t)j * K + k) * dsub;
    float acc = 0.0f;
    for (int d = 0; d < dsub; ++d) {
      acc = __fadd_rn(acc, __fmul_rn(qs[d], c[d]));
    }
    o[k] = acc;
  }
}

__global__ void adc_score_kernel(const float* __restrict__ lut,
                                 const uint8_t* __restrict__ codes,
                                 const int32_t* __restrict__ sel,
                                 float* __restrict__ out,
                                 int S, int U, int cap, int nsub, int K) {
  extern __shared__ float smem[];
  float* lut_s = smem;                                   // nsub * K floats
  uint8_t* code_s = reinterpret_cast<uint8_t*>(smem + (size_t)nsub * K);
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

  const int n_code = cap * nsub;
  for (int s = 0; s < S; ++s) {
    const int u = sel[(size_t)b * S + s];
    const bool ok = (u >= 0) && (u < U);   // uniform across the block
    __syncthreads();   // LUT staged / previous slot's code reads done
    if (ok) {
      const uint8_t* blk = codes + (size_t)u * n_code;
      if ((n_code & 3) == 0 &&
          (reinterpret_cast<uintptr_t>(codes) & 3) == 0) {
        const uint32_t* w = reinterpret_cast<const uint32_t*>(blk);
        for (int i4 = tid; i4 < n_code / 4; i4 += nt) {
          const uint32_t v = w[i4];
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const int i = 4 * i4 + t;
            const int c = i / nsub;
            const int j = i - c * nsub;
            code_s[j * cap + c] = (uint8_t)((v >> (8 * t)) & 0xffu);
          }
        }
      } else {
        for (int i = tid; i < n_code; i += nt) {
          const int c = i / nsub;
          const int j = i - c * nsub;
          code_s[j * cap + c] = blk[i];
        }
      }
    }
    __syncthreads();
    float* o = out + ((size_t)b * S + s) * cap;
    for (int c = tid; c < cap; c += nt) {
      float acc;
      if (ok) {
        acc = 0.0f;
        for (int j = 0; j < nsub; ++j) {
          acc = __fadd_rn(acc, lut_s[j * K + code_s[j * cap + c]]);
        }
      } else {
        acc = __int_as_float(0x7fc00000);   // NaN: slot index out of range
      }
      o[c] = acc;
    }
  }
}

}  // namespace

extern "C" {

// q: (B, nsub*dsub) f32, already rotated; books: (nsub, K, dsub) f32;
// out: (B, nsub, K) f32.
int adc_tables_launch(const float* q, const float* books, float* out,
                      int B, int nsub, int K, int dsub, void* stream) {
  if (B == 0 || nsub == 0 || K == 0) return 0;
  const int threads = K < 256 ? ((K + 31) / 32) * 32 : 256;
  dim3 grid(B, nsub);
  adc_tables_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      q, books, out, nsub, K, dsub);
  return (int)cudaGetLastError();
}

size_t adc_score_smem_bytes(int cap, int nsub, int K) {
  return (size_t)nsub * K * sizeof(float) + (size_t)cap * nsub;
}

// lut: (B, nsub, K) f32; codes: (U, cap, nsub) u8; sel: (B, S) i32 with
// 0 <= sel < U; out: (B, S, cap) f32.
int adc_score_blocks_launch(const float* lut, const uint8_t* codes,
                            const int32_t* sel, float* out, int B, int S,
                            int U, int cap, int nsub, int K, void* stream) {
  if (B == 0 || S == 0 || cap == 0) return 0;
  const size_t smem = adc_score_smem_bytes(cap, nsub, K);
  cudaError_t err = cudaFuncSetAttribute(
      adc_score_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  int threads = ((cap + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  adc_score_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      lut, codes, sel, out, S, U, cap, nsub, K);
  return (int)cudaGetLastError();
}

}  // extern "C"
