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
// of n dependent steps. Eager PyTorch would spend a handful of small
// launches per step; this kernel runs the whole sequence in one launch.
// One block per tile of R batch rows, one thread per (row, gate column):
// wx, wh and b (21*128 + 32*128 + 128 floats, about 27 KB) stay resident
// in shared memory for all n steps, and so do h, c and the gates; each
// step is two barrier-separated phases (gate dot products, then the cell
// update). expf and tanhf are the accurate versions, not __expf or
// fast-math, so the result stays within 1e-5 of the plain version.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

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

}  // namespace

extern "C" {

int lstm_rows_per_block(int H) {
  const int G = 4 * H;
  const int r = 256 / G;
  return r < 1 ? 1 : r;
}

size_t lstm_smem_bytes(int F, int H, int R) {
  const size_t G = 4 * (size_t)H;
  return sizeof(float) * (F * G + H * G + G + 2 * R * H + R * G + R * F);
}

// x: (B, n, F) f32; wx: (F, 4H); wh: (H, 4H); b: (4H,); out: (B, n, H).
int lstm_sequence_launch(const float* x, const float* wx, const float* wh,
                         const float* b, float* out, int B, int n, int F,
                         int H, void* stream) {
  if (B == 0 || n == 0) return 0;
  const int R = lstm_rows_per_block(H);
  const int threads = R * 4 * H;
  if (threads > 1024) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = lstm_smem_bytes(F, H, R);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        lstm_seq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (B + R - 1) / R;
  lstm_seq_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      x, wx, wh, b, out, B, n, F, H, R);
  return (int)cudaGetLastError();
}

}  // extern "C"
