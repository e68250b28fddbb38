// Stage-I overlap features for Hopper (sm_90a): for each query, P[c, j]
// = how many of its sparse top-k results fall in cluster c and rank bin
// j, and Q[c, j] = the mean (normalised) sparse score of those results
// (paper section 2.2).
//
// Replaces bin_overlap_pallas (src/repro/kernels/bin_overlap/kernel.py,
// _overlap_kernel). The TPU kernel kept the (N, v) accumulators in VMEM
// and folded the k results in as one-hot (N, k) matrix products per bin,
// because a scatter does not lower there. On the card a scatter does,
// but atomics would add a slot's scores in no fixed order. So the grid
// runs over (slot tile, query), and each CTA owns `tile` slots of one
// query, their counts and sums in shared memory:
//
//   1. it reads the query's k cluster ids, bins and scores (12 KB at k
//      1000, from L2 after the first tile of the query), and keeps the
//      results whose slot c * v + bin falls in its tile, in ascending
//      rank, by a stable compaction (warp ballots and a prefix over the
//      warps' counts);
//   2. one warp adds the kept results into the shared tile in ascending
//      rank: each 32 of them, lanes of one slot are grouped by
//      __match_any_sync, the members' scores are added in lane order
//      with __fadd_rn onto the slot's sum (from 0.0f), taken from their
//      registers by shuffles, and the group's lowest lane stores the sum
//      and adds the group's size to the count;
//   3. it writes every slot of the tile once: P = count, Q = sum /
//      max(count, 1) (__fdiv_rn where count > 1: a sum of one or no
//      scores is its own mean), with coalesced 16-byte streaming stores.
//
// That is the order of the CPU's sequential scatter_add_ and of XLA's
// CPU segment_sum, so P and Q are bitwise the plain version's and the
// JAX reference's. There is no sort, no atomic and no separate
// zero-fill pass. Slots outside [0, N*v) are dropped, as segment_sum
// drops them. The tile is chosen at launch from B and N*v so that the
// grid fills the card at B 1 (the recsys query) as at B 256 (Stage I).
//
// What bounds it on the H100: bytes, nearly all of them P and Q written
// once (2 * B * N * v * 4 bytes: 117 MB at B 256, N 8192, v 7, 0.035 ms
// at 3.35 TB/s); each CTA's reads of the k results come from L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 2048;
constexpr int kMaxPer = kMaxK / kThreads;     // results a thread reads
constexpr int kMinTile = 256, kMaxTile = 4096;
constexpr long long kTargetCtas = 1024;       // about 8 per SM

// sum / max(count, 1) as the plain version rounds it; a sum of one or
// no scores is its own mean (0.0f + x, or 0.0f), so only count > 1
// divides.
__device__ __forceinline__ float mean(float sum, int count) {
  return count > 1 ? __fdiv_rn(sum, (float)count) : sum;
}

__global__ void __launch_bounds__(kThreads)
bin_overlap_kernel(const int32_t* __restrict__ cluster_of,
                   const int32_t* __restrict__ bin_ids, int bin_row_stride,
                   const float* __restrict__ scores, float* __restrict__ P,
                   float* __restrict__ Q, int k, int v, int n_slots,
                   int tile, int n_tiles, int per, int vec4) {
  extern __shared__ float smem[];
  float* s_sum = smem;                                       // tile
  int* s_cnt = reinterpret_cast<int*>(smem + tile);          // tile
  int* l_slot = s_cnt + tile;                                // k
  float* l_score = reinterpret_cast<float*>(l_slot + k);     // k
  __shared__ int warp_n[kWarps];

  // consecutive CTAs are one query's tiles: its results stay in L2
  const int b = blockIdx.x / n_tiles;
  const int t0 = (blockIdx.x - b * n_tiles) * tile;
  const int n = min(tile, n_slots - t0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned lt = (1u << lane) - 1u;

  // 1. result (warp * per + e) * 32 + lane: rank ascends with (warp, e,
  // lane), so the ballots' prefix keeps rank order. Every load is issued
  // before the first ballot waits on one.
  const int32_t* cb = cluster_of + (size_t)b * k;
  const int32_t* bb = bin_ids + (size_t)b * bin_row_stride;
  const float* sb = scores + (size_t)b * k;
  int cl[kMaxPer], bn[kMaxPer];
  float sc[kMaxPer];
#pragma unroll
  for (int e = 0; e < kMaxPer; ++e) {
    const int i = min((warp * per + e) * 32 + lane, k - 1);
    cl[e] = e < per ? __ldg(cb + i) : 0;
    bn[e] = e < per ? __ldg(bb + i) : 0;
    sc[e] = e < per ? __ldg(sb + i) : 0.0f;
  }
  const int4 z = make_int4(0, 0, 0, 0);
  for (int i = tid; i < tile / 4; i += kThreads) {
    reinterpret_cast<int4*>(s_sum)[i] = z;
    reinterpret_cast<int4*>(s_cnt)[i] = z;
  }
  int ls[kMaxPer];
  unsigned mask[kMaxPer];
  int n_mine = 0;
#pragma unroll
  for (int e = 0; e < kMaxPer; ++e) {
    mask[e] = 0u;
    ls[e] = 0;
    if (e < per) {
      const long long slot = (long long)cl[e] * v + bn[e] - t0;
      const bool in = (warp * per + e) * 32 + lane < k && slot >= 0
                      && slot < n;
      ls[e] = (int)slot;
      mask[e] = __ballot_sync(0xffffffffu, in);
      n_mine += __popc(mask[e]);
    }
  }
  if (lane == 0) warp_n[warp] = n_mine;
  __syncthreads();    // also orders the tile's zeroing before step 2
  int pos = 0, n_in = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    pos += w < warp ? warp_n[w] : 0;
    n_in += warp_n[w];
  }
#pragma unroll
  for (int e = 0; e < kMaxPer; ++e) {
    if ((mask[e] >> lane) & 1u) {
      const int p = pos + __popc(mask[e] & lt);
      l_slot[p] = ls[e];
      l_score[p] = sc[e];
    }
    pos += __popc(mask[e]);
  }
  __syncthreads();

  // 2. one warp, 32 kept results at a time, in rank order. Each lane
  // sums its group's scores, taken from the members' registers in lane
  // (= rank) order; the group's first lane stores the slot.
  if (warp == 0) {
    for (int j0 = 0; j0 < n_in; j0 += 32) {
      const int j = j0 + lane;
      const bool act = j < n_in;
      const int slot = act ? l_slot[j] : -1 - lane;   // idle lanes: unique
      const float x = act ? l_score[j] : 0.0f;
      const unsigned grp = __match_any_sync(0xffffffffu, slot);
      const bool first = act && (grp & lt) == 0u;
      float s = first ? s_sum[slot] : 0.0f;
      const int n_grp = __popc(grp);
      const int longest = (int)__reduce_max_sync(0xffffffffu, n_grp);
      unsigned rest = grp;
      for (int m = 0; m < longest; ++m) {
        const float y = __shfl_sync(0xffffffffu, x, (__ffs(rest) - 1) & 31);
        if (rest) s = __fadd_rn(s, y);
        rest &= rest - 1u;
      }
      if (first) {
        s_sum[slot] = s;
        s_cnt[slot] += n_grp;
      }
      __syncwarp();
    }
  }
  __syncthreads();

  // 3. every slot of the tile, once
  float* Pb = P + (size_t)b * n_slots + t0;
  float* Qb = Q + (size_t)b * n_slots + t0;
  if (vec4) {          // n_slots % 4 == 0 and 16-byte bases: n % 4 == 0
    const int4* c4 = reinterpret_cast<const int4*>(s_cnt);
    const float4* s4 = reinterpret_cast<const float4*>(s_sum);
    for (int i = tid; i < n / 4; i += kThreads) {
      const int4 c = c4[i];
      const float4 s = s4[i];
      const float4 p = make_float4((float)c.x, (float)c.y, (float)c.z,
                                   (float)c.w);
      const float4 q = make_float4(mean(s.x, c.x), mean(s.y, c.y),
                                   mean(s.z, c.z), mean(s.w, c.w));
      __stcs(reinterpret_cast<float4*>(Pb) + i, p);
      __stcs(reinterpret_cast<float4*>(Qb) + i, q);
    }
  } else {
    for (int i = tid; i < n; i += kThreads) {
      __stcs(Pb + i, (float)s_cnt[i]);
      __stcs(Qb + i, mean(s_sum[i], s_cnt[i]));
    }
  }
}

// The slots a CTA owns: a power of two in [kMinTile, kMaxTile], about
// kTargetCtas CTAs in all.
int choose_tile(long long B, long long n_slots) {
  int t = kMinTile;
  while (t < kMaxTile && B * n_slots / (2LL * t) >= kTargetCtas) t <<= 1;
  return t;
}

}  // namespace

extern "C" {

// cluster_of (B, k) i32; bin_ids (k,) i32 (bin_row_stride 0) or (B, k)
// (bin_row_stride k); scores (B, k) f32; P, Q (B, n_clusters * v) f32.
// All contiguous on one device; 1 <= k <= kMaxK.
int bin_overlap_launch(const int32_t* cluster_of, const int32_t* bin_ids,
                       int bin_row_stride, const float* scores, float* P,
                       float* Q, int B, int k, int n_clusters, int v,
                       void* stream) {
  if (B == 0) return 0;
  if (B < 0 || k < 1 || k > kMaxK || v < 1 || n_clusters < 1)
    return (int)cudaErrorInvalidValue;
  const long long n_slots = (long long)n_clusters * v;
  if (n_slots >= 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int tile = choose_tile(B, n_slots);
  const long long n_tiles = (n_slots + tile - 1) / tile;
  if (B * n_tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int per = (k + kThreads - 1) / kThreads;
  const size_t smem = (size_t)tile * 8 + (size_t)k * 8;
  if (smem > 46 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        bin_overlap_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int vec4 = (n_slots % 4 == 0)
      && (reinterpret_cast<uintptr_t>(P) % 16 == 0)
      && (reinterpret_cast<uintptr_t>(Q) % 16 == 0);
  bin_overlap_kernel<<<(unsigned)(B * n_tiles), kThreads, smem,
                       (cudaStream_t)stream>>>(
      cluster_of, bin_ids, bin_row_stride, scores, P, Q, k, v,
      (int)n_slots, tile, (int)n_tiles, per, vec4);
  return (int)cudaGetLastError();
}

}  // extern "C"
