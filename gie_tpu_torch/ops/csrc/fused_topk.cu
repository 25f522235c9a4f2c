// fused_blend_topk for Hopper (sm_90a).
//
// Replaces: gie_tpu/ops/fused_topk.py:fused_blend_topk (+ _kernel), the
// Pallas kernel that blends the S scorer columns, masks ineligible lanes and
// extracts the top k per request row in one VMEM-resident pass per N tile.
//
// What it computes, per row n: total[m] = (sum_s w[s] * col[s][n][m]) /
// max(sum_s w[s], 1e-6), summed in order s = 0, 1, ... with explicitly
// rounded multiply and add; masked lanes set to NEG = -1e9; then k rounds
// of (row max, FIRST index holding it, set that lane to NEG). Once a row
// runs out of candidates the max is NEG and the first lane holding it wins
// again (eligible lanes {5, 7} give [5, 7, 0, 0]).
//
// What bounds it on the H100: bytes. It must read S*N*M*4 bytes of scorer
// columns and N*M bytes of mask (6.56 MB at S=6, 1024x256: 1.96 us at
// 3.35 TB/s) and writes only N*k*8 bytes; the blend is 2*S flops a lane.
// The first port reached 13% of that: scalar 4-byte loads and a runtime-S
// scorer loop left too few bytes in flight per SM.
//
// Design: one warp per row, no [N, M] or [M] array anywhere, so every M
// works (and N, and k up to kMaxK):
//  - Loads. S is a template parameter (1..kMaxS), so all S loads of a step
//    are in flight before the blend. Where M % 4 == 0 and the pointers
//    allow, lane l reads 16 bytes of each scorer (columns 4l..4l+3 of a
//    128-column chunk) and 4 mask bytes, two chunks a step: 2*S*512 B in
//    flight per warp (6 KB at S=6), ~48 KB per SM at 1024 rows. Otherwise
//    lane l reads columns l + 32j, four a step.
//  - Top k without the row. Each lane keeps the best L >= k (value, index)
//    pairs of its own columns, by value descending then index ascending,
//    in registers (columns arrive in increasing index order, so an equal
//    value goes behind). The row's top k is in the union of the lanes'
//    lists. Each round the warp reduces the lane heads with shuffles (larger
//    value, then lower index), and the owning lane pops its head. When the
//    best head is NEG or below after the first round, every lane holds NEG
//    (picked lanes are NEG): the winner is the lowest index among the
//    picked lanes and the unpicked NEG lanes, which are the lane heads.
// There is no shared memory, so wide rows (M = 2048, 4096, ...) cost only
// their loads.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRowsPerBlock = 8;
constexpr int kThreads = kRowsPerBlock * kWarp;
constexpr int kMaxS = 8;
constexpr int kMaxK = 8;
constexpr float kNeg = -1e9f;

// Insert (x, idx) into a lane's list sorted by value descending, index
// ascending; idx is larger than every listed index.
template <int L>
__device__ __forceinline__ void insert(float (&lv)[L], int (&li)[L], float x,
                                       int idx) {
  if (!(x > lv[L - 1])) return;
  lv[L - 1] = x;
  li[L - 1] = idx;
#pragma unroll
  for (int j = L - 1; j > 0; --j) {
    if (lv[j] > lv[j - 1]) {
      float tv = lv[j];
      lv[j] = lv[j - 1];
      lv[j - 1] = tv;
      int ti = li[j];
      li[j] = li[j - 1];
      li[j - 1] = ti;
    }
  }
}

template <int S>
__device__ __forceinline__ float blend(const float (&w)[S], const float (&x)[S],
                                       float denom) {
  float total = 0.0f;
#pragma unroll
  for (int s = 0; s < S; ++s) total = __fadd_rn(total, __fmul_rn(w[s], x[s]));
  return __fdiv_rn(total, denom);
}

// The four columns c..c+3 of one 16-byte load per scorer.
template <int S, int L>
__device__ __forceinline__ void take4(float (&lv)[L], int (&li)[L],
                                      const float (&w)[S], float denom,
                                      const float4 (&xs)[S], uchar4 mk,
                                      int c) {
  float e[4][S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    e[0][s] = xs[s].x;
    e[1][s] = xs[s].y;
    e[2][s] = xs[s].z;
    e[3][s] = xs[s].w;
  }
  insert(lv, li, mk.x ? blend(w, e[0], denom) : kNeg, c);
  insert(lv, li, mk.y ? blend(w, e[1], denom) : kNeg, c + 1);
  insert(lv, li, mk.z ? blend(w, e[2], denom) : kNeg, c + 2);
  insert(lv, li, mk.w ? blend(w, e[3], denom) : kNeg, c + 3);
}

template <int S, int L, bool kVec>
__global__ void __launch_bounds__(kThreads)
blend_topk(const float* __restrict__ stacked, const float* __restrict__ wvec,
           const uint8_t* __restrict__ mask, float* __restrict__ vals,
           int* __restrict__ idxs, int n, int m, int k) {
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (row >= n) return;

  float w[S];
  float wsum = 0.0f;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    w[s] = __ldg(wvec + s);
    wsum = __fadd_rn(wsum, w[s]);
  }
  const float denom = fmaxf(wsum, 1e-6f);
  const size_t plane = static_cast<size_t>(n) * m;
  const float* base = stacked + static_cast<size_t>(row) * m;
  const uint8_t* mrow = mask + static_cast<size_t>(row) * m;

  float lv[L];
  int li[L];
#pragma unroll
  for (int j = 0; j < L; ++j) {
    lv[j] = -INFINITY;
    li[j] = INT_MAX;
  }

  if constexpr (kVec) {
    constexpr int kChunk = 4 * kWarp;
    for (int c0 = 4 * lane; c0 < m; c0 += 2 * kChunk) {
      const int c1 = c0 + kChunk;
      const bool has1 = c1 < m;
      float4 x0[S], x1[S];
      uchar4 m0, m1 = make_uchar4(0, 0, 0, 0);
#pragma unroll
      for (int s = 0; s < S; ++s) {
        x0[s] = __ldg(reinterpret_cast<const float4*>(base + s * plane + c0));
      }
      m0 = __ldg(reinterpret_cast<const uchar4*>(mrow + c0));
      if (has1) {
#pragma unroll
        for (int s = 0; s < S; ++s) {
          x1[s] = __ldg(reinterpret_cast<const float4*>(base + s * plane + c1));
        }
        m1 = __ldg(reinterpret_cast<const uchar4*>(mrow + c1));
      }
      take4(lv, li, w, denom, x0, m0, c0);
      if (has1) take4(lv, li, w, denom, x1, m1, c1);
    }
  } else {
    constexpr int kStep = 4;
    for (int c0 = lane; c0 < m; c0 += kStep * kWarp) {
      float x[kStep][S];
      uint8_t mb[kStep];
#pragma unroll
      for (int q = 0; q < kStep; ++q) {
        const int c = c0 + q * kWarp;
        if (c < m) {
#pragma unroll
          for (int s = 0; s < S; ++s) x[q][s] = __ldg(base + s * plane + c);
          mb[q] = __ldg(mrow + c);
        }
      }
#pragma unroll
      for (int q = 0; q < kStep; ++q) {
        const int c = c0 + q * kWarp;
        if (c < m) insert(lv, li, mb[q] ? blend(w, x[q], denom) : kNeg, c);
      }
    }
  }

  int min_picked = INT_MAX;
  for (int r = 0; r < k; ++r) {
    float bv = lv[0];
    int bi = li[0];
#pragma unroll
    for (int off = kWarp / 2; off > 0; off >>= 1) {
      float ov = __shfl_xor_sync(kFull, bv, off);
      int oi = __shfl_xor_sync(kFull, bi, off);
      if (ov > bv || (ov == bv && oi < bi)) {
        bv = ov;
        bi = oi;
      }
    }
    float out_v = bv;
    int out_i = bi;
    if (r > 0 && !(bv > kNeg)) {
      // Every lane holds NEG or less, and the picked lanes hold NEG.
      out_v = kNeg;
      out_i = (bv == kNeg && bi < min_picked) ? bi : min_picked;
    }
    if (li[0] == out_i) {  // the owning lane pops its head
#pragma unroll
      for (int j = 0; j < L - 1; ++j) {
        lv[j] = lv[j + 1];
        li[j] = li[j + 1];
      }
      lv[L - 1] = -INFINITY;
      li[L - 1] = INT_MAX;
    }
    min_picked = min(min_picked, out_i);
    if (lane == 0) {
      vals[static_cast<size_t>(row) * k + r] = out_v;
      idxs[static_cast<size_t>(row) * k + r] = out_i;
    }
  }
}

template <int S, int L>
cudaError_t launch_s(const float* stacked, const float* wvec,
                     const uint8_t* mask, float* vals, int* idxs, int n, int m,
                     int k, bool vec, cudaStream_t st) {
  dim3 grid((n + kRowsPerBlock - 1) / kRowsPerBlock);
  if (vec) {
    blend_topk<S, L, true><<<grid, kThreads, 0, st>>>(stacked, wvec, mask,
                                                      vals, idxs, n, m, k);
  } else {
    blend_topk<S, L, false><<<grid, kThreads, 0, st>>>(stacked, wvec, mask,
                                                       vals, idxs, n, m, k);
  }
  return cudaGetLastError();
}

template <int L>
cudaError_t launch_l(const float* stacked, const float* wvec,
                     const uint8_t* mask, float* vals, int* idxs, int s, int n,
                     int m, int k, bool vec, cudaStream_t st) {
  switch (s) {
    case 1: return launch_s<1, L>(stacked, wvec, mask, vals, idxs, n, m, k, vec, st);
    case 2: return launch_s<2, L>(stacked, wvec, mask, vals, idxs, n, m, k, vec, st);
    case 3: return launch_s<3, L>(stacked, wvec, mask, vals, idxs, n, m, k, vec, st);
    case 4: return launch_s<4, L>(stacked, wvec, mask, vals, idxs, n, m, k, vec, st);
    case 5: return launch_s<5, L>(stacked, wvec, mask, vals, idxs, n, m, k, vec, st);
    case 6: return launch_s<6, L>(stacked, wvec, mask, vals, idxs, n, m, k, vec, st);
    case 7: return launch_s<7, L>(stacked, wvec, mask, vals, idxs, n, m, k, vec, st);
    case 8: return launch_s<8, L>(stacked, wvec, mask, vals, idxs, n, m, k, vec, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// stacked f32[s, n, m], wvec f32[s], mask bool[n, m] (one byte per lane)
// -> vals f32[n, k], idxs i32[n, k]. Takes 1 <= s <= 8, 1 <= k <= 8, any
// n and m >= 1 (checked by the Python wrapper as well). Returns a
// cudaError_t (0 = launched).
extern "C" int gie_fused_blend_topk(const float* stacked, const float* wvec,
                                    const void* mask, float* vals, int* idxs,
                                    int s, int n, int m, int k, void* stream) {
  if (n <= 0 || k <= 0) return 0;
  if (m <= 0 || s < 1 || s > kMaxS || k > kMaxK) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const uint8_t* mk = static_cast<const uint8_t*>(mask);
  const bool vec = m % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(stacked) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(mk) & 3) == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = k <= 4
      ? launch_l<4>(stacked, wvec, mk, vals, idxs, s, n, m, k, vec, st)
      : launch_l<kMaxK>(stacked, wvec, mk, vals, idxs, s, n, m, k, vec, st);
  return static_cast<int>(e);
}
