// Fused LSTM-selector sequence kernel for Hopper (sm_90a): Stage II of
// CluSD serving.
//
// Replaces lstm_sequence_pallas (src/repro/kernels/lstm/kernel.py,
// _lstm_kernel): the hidden sequence h_1..h_n of an LSTM over the
// (B, n, F) candidate features, gates in the order i, f, g, o:
//   gates = x_t @ wx + h @ wh + b
//   c = sigmoid(f) * c + sigmoid(i) * tanh(g);  h = sigmoid(o) * tanh(c)
//
// What bounds it on the H100: neither bytes (about 2 MB in and out at
// B=256, n=32, F=21, H=32) nor flops (about 0.1 GFLOP), but the latency
// of n dependent steps. So the step is kept short and free of barriers:
//
// - The input projection does not depend on h. A prologue computes
//   xg_t = (x_t . wx) + b for a chunk of up to 32 steps of the block's
//   rows, in parallel over steps and over all eight warps of the block
//   (a warp takes 8 steps of one row group, the 8 x 4 sums in
//   registers), into shared memory. The rows' x is read once, with
//   coalesced loads, before it.
// - One warp runs the recurrence of 32 / H rows (H 32, the full config's,
//   and 16, the smoke config's): lane
//   (r, j) owns hidden unit j of row r, with its four wh columns (4H
//   floats) in registers and eight independent accumulators (two per
//   gate). h_{t-1} reaches the row's other lanes by __shfl_sync, the cell
//   update is lane-local, and no block barrier is left inside a chunk.
// - A block holds two such warps (2 * 32 / H rows), so B = 256 at H = 32
//   makes 128 blocks, one per SM; B = 1 runs one warp and its step
//   latency is the floor.
//
// Precision: fp32 FMA throughout (no TF32). The recurrence uses the
// accurate expf (not __expf or fast-math) and writes sigmoid(x) = 1 / (1 +
// expf(-x)) and tanh(x) = sign(x) (1 - e) / (1 + e), e = expf(-2|x|),
// each with the hardware reciprocal (within 1 ulp) for the division:
// accurate to a few ulp of 1, and far shorter in latency than the IEEE
// division and tanhf, which were the longest part of a step. The
// order of additions is gate = ((x_t . wx), f ascending, + b) + (even-k
// terms + odd-k terms of h . wh), which is not the plain version's (x @
// wx + h @ wh) + b: the result stays within 1e-5 of it (ref.py).
//
// Any other H (4H <= 1024) takes the generic kernel: one thread per (row,
// gate column), wx and wh in shared memory, two barrier-separated phases
// per step.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;       // warps per block; all run the prologue
constexpr int kRecWarps = 2;    // of them, the ones that run the recurrence
constexpr int kChunk = 32;      // steps whose projection is staged at once
constexpr int kStepTile = 8;    // steps of one prologue work item

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// The recurrence's activations: accurate expf, and the reciprocal from
// MUFU.RCP (__fdividef, within 1 ulp; 0 once 1 + e overflows) in place of
// the IEEE-rounded division, which costs a subroutine call per use.
// tanh(x) = sign(x) (1 - e) / (1 + e) with e = expf(-2|x|) in (0, 1], so
// nothing overflows; its absolute error stays within a few ulp of 1.
__device__ __forceinline__ float sigmoid_rcp(float x) {
  return __fdividef(1.0f, 1.0f + expf(-x));
}

__device__ __forceinline__ float tanh_rcp(float x) {
  const float e = expf(-2.0f * fabsf(x));
  return copysignf((1.0f - e) * __fdividef(1.0f, 1.0f + e), x);
}

template <int H>
__global__ void __launch_bounds__(kWarps * 32)
lstm_warp_kernel(const float* __restrict__ x, const float* __restrict__ wx,
                 const float* __restrict__ wh, const float* __restrict__ bias,
                 float* __restrict__ out, int B, int n, int F) {
  constexpr int G = 4 * H;
  constexpr int kRowsPerWarp = 32 / H;
  constexpr int R = kRecWarps * kRowsPerWarp;   // rows per block
  extern __shared__ float sm[];
  float* wx_s = sm;                      // F * G
  float* b_s = wx_s + F * G;             // G
  // a row's x at a stride of kChunk * F + 1 floats, so that the rows of
  // one warp read other banks
  const int xs = kChunk * F + 1;
  float* x_s = b_s + G;                  // R * xs, [row][t][f]
  float* xg_s = x_s + R * xs;            // kChunk * 4 * R * H, [t][q][row][j]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int rr = lane / H;               // this lane's row in its warp
  const int j = lane - rr * H;           // and its hidden unit
  const int row0 = blockIdx.x * R;

  for (int i = tid; i < F * G; i += kWarps * 32) wx_s[i] = wx[i];
  for (int i = tid; i < G; i += kWarps * 32) b_s[i] = bias[i];

  const bool rec = warp < kRecWarps;
  const int rec_row = warp * kRowsPerWarp + rr;  // row in the tile
  float whr[4][H];
  if (rec) {
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int k = 0; k < H; ++k) whr[q][k] = wh[k * G + q * H + j];
  }
  float h = 0.0f, c = 0.0f;

  for (int t0 = 0; t0 < n; t0 += kChunk) {
    const int T = min(kChunk, n - t0);
    const int span = T * F;              // a row's x for these steps
    for (int i = tid; i < R * span; i += kWarps * 32) {
      const int r = i / span;
      const int e = i - r * span;
      const int row = row0 + r;
      x_s[r * xs + e] =
          row < B ? x[((size_t)row * n + t0) * F + e] : 0.0f;
    }
    __syncthreads();

    // prologue: xg[t][q][r][j] = (x_t . wx[:, q*H + j]) + b[q*H + j]
    const int n_items = kRecWarps * ((T + kStepTile - 1) / kStepTile);
    for (int p = warp; p < n_items; p += kWarps) {
      const int gw = p % kRecWarps;
      const int tb = (p / kRecWarps) * kStepTile;
      if (row0 + gw * kRowsPerWarp >= B) continue;   // uniform in the warp
      const int r = gw * kRowsPerWarp + rr;
      const float* xr = x_s + r * xs + tb * F;
      float acc[kStepTile][4];
#pragma unroll
      for (int tt = 0; tt < kStepTile; ++tt)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[tt][q] = 0.0f;
      for (int f = 0; f < F; ++f) {
        float w[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) w[q] = wx_s[f * G + q * H + j];
#pragma unroll
        for (int tt = 0; tt < kStepTile; ++tt) {
          const float xv = xr[tt * F + f];
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[tt][q] = fmaf(xv, w[q], acc[tt][q]);
        }
      }
#pragma unroll
      for (int tt = 0; tt < kStepTile; ++tt) {
        if (tb + tt < T) {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            xg_s[(((tb + tt) * 4 + q) * R + r) * H + j] =
                acc[tt][q] + b_s[q * H + j];
        }
      }
    }
    __syncthreads();

    if (rec && row0 + warp * kRowsPerWarp < B) {
      const int row = row0 + rec_row;
      for (int tt = 0; tt < T; ++tt) {
        const float* xg = xg_s + (tt * 4 * R + rec_row) * H + j;
        float a[4][2];
#pragma unroll
        for (int q = 0; q < 4; ++q) a[q][0] = a[q][1] = 0.0f;
#pragma unroll
        for (int k = 0; k < H; ++k) {
          const float hk = __shfl_sync(0xffffffffu, h, k, H);
#pragma unroll
          for (int q = 0; q < 4; ++q)
            a[q][k & 1] = fmaf(hk, whr[q][k], a[q][k & 1]);
        }
        const float ig = sigmoid_rcp(xg[0] + (a[0][0] + a[0][1]));
        const float fg = sigmoid_rcp(xg[R * H] + (a[1][0] + a[1][1]));
        const float gg = tanh_rcp(xg[2 * R * H] + (a[2][0] + a[2][1]));
        const float og = sigmoid_rcp(xg[3 * R * H] + (a[3][0] + a[3][1]));
        c = fg * c + ig * gg;
        h = og * tanh_rcp(c);
        if (row < B) out[((size_t)row * n + t0 + tt) * H + j] = h;
      }
    }
    __syncthreads();   // x_s and xg_s are rewritten by the next chunk
  }
}

template <int H>
size_t warp_smem_bytes(int F) {
  constexpr int G = 4 * H;
  constexpr int R = kRecWarps * (32 / H);
  return sizeof(float) *
         ((size_t)F * G + G + (size_t)R * (kChunk * F + 1) +
          (size_t)kChunk * 4 * R * H);
}

template <int H>
cudaError_t launch_warp(const float* x, const float* wx, const float* wh,
                        const float* b, float* out, int B, int n, int F,
                        cudaStream_t stream) {
  const size_t smem = warp_smem_bytes<H>(F);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        lstm_warp_kernel<H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  constexpr int R = kRecWarps * (32 / H);
  lstm_warp_kernel<H><<<(B + R - 1) / R, kWarps * 32, smem, stream>>>(
      x, wx, wh, b, out, B, n, F);
  return cudaGetLastError();
}

// The generic kernel: one block per tile of R batch rows, one thread per
// (row, gate column); wx, wh and b stay in shared memory for all n
// steps, and so do h, c and the gates; each step is two barrier-separated
// phases (gate dot products, then the cell update).
__global__ void lstm_seq_kernel(const float* __restrict__ x,
                                const float* __restrict__ wx,
                                const float* __restrict__ wh,
                                const float* __restrict__ bias,
                                float* __restrict__ out,
                                int B, int n, int F, int H, int R) {
  extern __shared__ float sm[];
  const int G = 4 * H;
  float* wx_s = sm;                    // F * G
  float* wh_s = wx_s + F * G;          // H * G
  float* b_s = wh_s + H * G;           // G
  float* h_s = b_s + G;                // R * H
  float* c_s = h_s + R * H;            // R * H
  float* g_s = c_s + R * H;            // R * G
  float* x_s = g_s + R * G;            // R * F (the current step's inputs)

  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int row0 = blockIdx.x * R;

  for (int i = tid; i < F * G; i += nt) wx_s[i] = wx[i];
  for (int i = tid; i < H * G; i += nt) wh_s[i] = wh[i];
  for (int i = tid; i < G; i += nt) b_s[i] = bias[i];
  for (int i = tid; i < R * H; i += nt) { h_s[i] = 0.0f; c_s[i] = 0.0f; }

  const int r = tid / G;               // this thread's row in the tile
  const int col = tid - r * G;         // and its gate column
  for (int t = 0; t < n; ++t) {
    for (int i = tid; i < R * F; i += nt) {
      const int rr = i / F;
      const int f = i - rr * F;
      const int row = row0 + rr;
      x_s[i] = row < B ? x[((size_t)row * n + t) * F + f] : 0.0f;
    }
    __syncthreads();
    if (r < R) {
      float ax = 0.0f;
      for (int f = 0; f < F; ++f) ax = fmaf(x_s[r * F + f], wx_s[f * G + col], ax);
      float ah = 0.0f;
      for (int k = 0; k < H; ++k) ah = fmaf(h_s[r * H + k], wh_s[k * G + col], ah);
      g_s[r * G + col] = (ax + ah) + b_s[col];
    }
    __syncthreads();
    if (r < R && col < H) {
      const float* g = g_s + r * G;
      const float ig = sigmoid_f(g[col]);
      const float fg = sigmoid_f(g[H + col]);
      const float gg = tanhf(g[2 * H + col]);
      const float og = sigmoid_f(g[3 * H + col]);
      const float c = fg * c_s[r * H + col] + ig * gg;
      const float h = og * tanhf(c);
      c_s[r * H + col] = c;
      h_s[r * H + col] = h;
      const int row = row0 + r;
      if (row < B) out[((size_t)row * n + t) * H + col] = h;
    }
    __syncthreads();
  }
}

cudaError_t launch_generic(const float* x, const float* wx, const float* wh,
                           const float* b, float* out, int B, int n, int F,
                           int H, cudaStream_t stream) {
  const int G = 4 * H;
  const int R = 256 / G < 1 ? 1 : 256 / G;
  const int threads = R * G;
  if (threads > 1024) return cudaErrorInvalidConfiguration;
  const size_t smem =
      sizeof(float) * ((size_t)F * G + H * G + G + 2 * R * H + R * G + R * F);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        lstm_seq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  lstm_seq_kernel<<<(B + R - 1) / R, threads, smem, stream>>>(
      x, wx, wh, b, out, B, n, F, H, R);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x: (B, n, F) f32; wx: (F, 4H); wh: (H, 4H); b: (4H,); out: (B, n, H).
int lstm_sequence_launch(const float* x, const float* wx, const float* wh,
                         const float* b, float* out, int B, int n, int F,
                         int H, void* stream) {
  if (B == 0 || n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (H) {
    case 16: return (int)launch_warp<16>(x, wx, wh, b, out, B, n, F, s);
    case 32: return (int)launch_warp<32>(x, wx, wh, b, out, B, n, F, s);
    default: return (int)launch_generic(x, wx, wh, b, out, B, n, F, H, s);
  }
}

}  // extern "C"
