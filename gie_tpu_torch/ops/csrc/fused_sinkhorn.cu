// fused_sinkhorn_plan for Hopper (sm_90a): one persistent cooperative launch.
//
// Replaces: gie_tpu/ops/fused_sinkhorn.py:fused_sinkhorn_plan (+ _kernel),
// the Pallas kernel that holds the whole [N, M] plan in VMEM and runs
// `iters` rounds of row-normalize then column-cap on it.
//
// What it computes: plan_0 = K diag(v_init); per round, normalize every row
// to sum 1 (rows summing to 0 stay 0), then scale every column whose sum
// exceeds cap[m] down to cap[m], carrying v as the running product of the
// column scales; finally normalize the rows once more. Returns (plan, v).
// It runs the dual form of those iterates, p_t = diag(u_t) K diag(v_t)
// (gie_tpu/sched/sinkhorn.py:_dual_solve), so a round needs two vectors:
//   u_n = 1 / sum_m K[n,m] v[m]                 (kept where the sum is 0)
//   load_m = v_m sum_n u_n K[n,m];  v_m *= cap_m / max(load_m, 1e-9)
//                                               where load_m > cap_m.
//
// What bounds it on the H100: bytes, at the least reading K once and
// writing the plan once (2 MiB at 1024x256: 0.63 us at 3.35 TB/s); the
// arithmetic (~4 flops per element per round) is far below the card's
// rate. In practice it is bound by latency: every round ends in a
// grid-wide reduction (the column cap couples every row), a chain of
// trips through L2 between SMs.
//
// Design, the Hopper counterpart of "hold the plan resident in VMEM":
//  - One launch. A cooperative persistent grid of at most one block per SM
//    (min(SMs, N) blocks; fewer, larger bands measured slower, PERF.md). A
//    grid that cannot be resident at once is refused by the launch, never
//    run.
//  - K read from device memory once. Block b owns the band of `rows` whole
//    rows starting at b*rows and copies its K slab (rows x M f32, 32 KB at
//    1024x1024 on 132 SMs) into shared memory, where it stays for every
//    round and the final pass: the whole of K is spread over the SMs'
//    shared memory, as the TPU kernel keeps it in VMEM.
//  - Row pass, local: whole rows, so u needs no communication.
//  - Column pass, no barrier: each block writes its [M] partials
//    sum_{n in band} u_n K[n,m] to a caller-allocated scratch; block b
//    folds a slice of the columns over all blocks' partials, in block
//    order, and writes the new v of that slice; every block reads all of v.
//    Each exchanged word carries its round in its high half and is written
//    and read as one 64-bit access, so a reader polls until the tag
//    matches: no grid barrier inside the rounds (one at the start clears
//    the words). This measured faster than a grid barrier before and after
//    each fold, and than a fold through thread-block clusters (PERF.md).
//  - Final pass, local: plan = K u v normalized by its row sum, written
//    once; v_out written once.
// Deterministic: every sum is folded in a fixed order with explicitly
// rounded __fadd_rn/__fmul_rn and no atomics on values, so two runs are
// bitwise identical (on one device: the fold order follows the grid). The
// kernel allocates nothing and never synchronizes the host, so it can be
// captured in a CUDA graph. Cross-block data moves through L2 only
// (.relaxed.gpu accesses): L1 is not coherent across SMs.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / kWarp;
// A tagged read gives up after this many polls (seconds) and yields NaN,
// so a fault shows as a wrong result instead of a hung card.
constexpr int kMaxPolls = 1 << 22;
// Tagged words a lane reads before it waits on the first of them.
constexpr int kBatch = 4;

// One 8-byte word: a float in the low half, the round's tag in the high
// half, written and read as one single-copy-atomic 64-bit access, so a
// reader that sees the tag sees the value (no fence, no barrier).
__device__ __forceinline__ void put_tagged(unsigned long long* p, float x,
                                           unsigned tag) {
  unsigned long long w =
      (static_cast<unsigned long long>(tag) << 32) | __float_as_uint(x);
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;" ::"l"(p), "l"(w)
               : "memory");
}

__device__ __forceinline__ unsigned long long load_tagged(
    const unsigned long long* p) {
  unsigned long long w;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];" : "=l"(w) : "l"(p)
               : "memory");
  return w;
}

// Polls word `w` (first read already in hand) at p until it carries `tag`.
__device__ __forceinline__ float await_tagged(unsigned long long w,
                                              const unsigned long long* p,
                                              unsigned tag) {
  int polls = 0;
  while (static_cast<unsigned>(w >> 32) != tag && ++polls < kMaxPolls) {
    w = load_tagged(p);
  }
  return static_cast<unsigned>(w >> 32) == tag
             ? __uint_as_float(static_cast<unsigned>(w))
             : __uint_as_float(0x7fffffffu);
}

// Butterfly sum: every lane ends with the same, order-fixed total (each
// stage adds the same two operands in both lanes of a pair).
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    x = __fadd_rn(x, __shfl_xor_sync(kFull, x, off));
  }
  return x;
}

// v_m after one column cap, given sum_n u_n K[n,m].
__device__ __forceinline__ float capped(float vm, float colsum, float c) {
  float load = __fmul_rn(vm, colsum);
  return load > c ? __fmul_rn(vm, __fdiv_rn(c, fmaxf(load, 1e-9f))) : vm;
}

__global__ void __launch_bounds__(kThreads)
sinkhorn_persistent(const float* __restrict__ k, const float* __restrict__ cap,
                    const float* __restrict__ v_init, float* __restrict__ plan,
                    float* __restrict__ v_out,
                    unsigned long long* __restrict__ words, int n, int m,
                    int rows, int iters) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int lane = tid % kWarp;
  const int warp = tid / kWarp;
  const int b = blockIdx.x;
  const int g = gridDim.x;
  const int row0 = b * rows;
  const int nrows = max(0, min(rows, n - row0));
  float* slab = smem;                              // [rows][m]
  float* v_s = slab + static_cast<size_t>(rows) * m;
  float* u_s = v_s + m;
  unsigned long long* part = words;                // [g][m] tagged partials
  unsigned long long* tv = words + static_cast<size_t>(g) * m;  // [m] v

  // The K slab, read from device memory once.
  const float* ks = k + static_cast<size_t>(row0) * m;
  const int count = nrows * m;
  if (count % 4 == 0 && (reinterpret_cast<uintptr_t>(ks) & 15) == 0) {
    const float4* src = reinterpret_cast<const float4*>(ks);
    float4* dst = reinterpret_cast<float4*>(slab);
    for (int i = tid; i < count / 4; i += kThreads) dst[i] = __ldg(src + i);
  } else {
    for (int i = tid; i < count; i += kThreads) slab[i] = __ldg(ks + i);
  }
  for (int c = tid; c < m; c += kThreads) v_s[c] = __ldg(v_init + c);
  for (int r = tid; r < rows; r += kThreads) u_s[r] = 1.0f;
  // The scratch comes uninitialized: clear every word to tag 0 (rounds use
  // tags 1, 2, ...) before any block writes a round.
  for (int c = tid; c < m; c += kThreads) {
    part[static_cast<size_t>(b) * m + c] = 0ull;
    if (b == 0) tv[c] = 0ull;
  }
  cg::this_grid().sync();

  // Block b folds columns [c0, c1).
  const int per = (m + g - 1) / g;
  const int c0 = b * per;
  const int c1 = min(m, c0 + per);
  for (int it = 0; it < iters; ++it) {
    const unsigned tag = static_cast<unsigned>(it) + 1u;
    // Row pass: one warp per row, lane l sums columns l, l+32, ...
    for (int r = warp; r < nrows; r += kWarps) {
      const float* kr = slab + static_cast<size_t>(r) * m;
      float acc = 0.0f;
#pragma unroll 8
      for (int c = lane; c < m; c += kWarp) {
        acc = __fadd_rn(acc, __fmul_rn(kr[c], v_s[c]));
      }
      acc = warp_sum(acc);
      if (lane == 0 && acc > 0.0f) u_s[r] = __fdiv_rn(1.0f, acc);
    }
    __syncthreads();

    // The band's column partials, rows in order.
    for (int c = tid; c < m; c += kThreads) {
      float acc = 0.0f;
#pragma unroll 8
      for (int r = 0; r < nrows; ++r) {
        acc = __fadd_rn(acc, __fmul_rn(u_s[r], slab[static_cast<size_t>(r) * m + c]));
      }
      put_tagged(part + static_cast<size_t>(b) * m + c, acc, tag);
    }
    // The fold of columns [c0, c1), one warp per column, as soon as every
    // block's partial of it has landed: lane l sums blocks l, l+32, ... in
    // order, then the butterfly. A batch's first reads are all in flight
    // before any wait (one trip to L2 a batch, not one a word). Reusing the words
    // across rounds is safe: a block writes round t+1's partials only
    // after reading all of round t's v, which every owner wrote after
    // reading all of round t's partials.
    for (int c = c0 + warp; c < c1; c += kWarps) {
      float s = 0.0f;
      for (int j0 = lane; j0 < g; j0 += kBatch * kWarp) {
        unsigned long long w[kBatch];
#pragma unroll
        for (int q = 0; q < kBatch; ++q) {
          const int j = j0 + q * kWarp;
          w[q] = j < g ? load_tagged(part + static_cast<size_t>(j) * m + c) : 0ull;
        }
#pragma unroll
        for (int q = 0; q < kBatch; ++q) {
          const int j = j0 + q * kWarp;
          if (j < g) {
            s = __fadd_rn(s, await_tagged(w[q], part + static_cast<size_t>(j) * m + c, tag));
          }
        }
      }
      s = warp_sum(s);
      if (lane == 0) put_tagged(tv + c, capped(v_s[c], s, __ldg(cap + c)), tag);
    }
    __syncthreads();
    // Every block reads all of v as each slice's owner writes it.
    for (int c = tid; c < m; c += kThreads) {
      v_s[c] = await_tagged(load_tagged(tv + c), tv + c, tag);
    }
    __syncthreads();
  }

  // Final pass: plan = K u v normalized by its row sum, written once.
  for (int r = warp; r < nrows; r += kWarps) {
    const float* kr = slab + static_cast<size_t>(r) * m;
    const float un = u_s[r];
    float acc = 0.0f;
    for (int c = lane; c < m; c += kWarp) {
      acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(kr[c], un), v_s[c]));
    }
    acc = warp_sum(acc);
    float* pr = plan + static_cast<size_t>(row0 + r) * m;
    for (int c = lane; c < m; c += kWarp) {
      float p = __fmul_rn(__fmul_rn(kr[c], un), v_s[c]);
      pr[c] = acc > 0.0f ? __fdiv_rn(p, acc) : p;
    }
  }
  if (b == 0) {
    for (int c = tid; c < m; c += kThreads) v_out[c] = v_s[c];
  }
}

// The launch geometry of one call.
struct Layout {
  int grid;            // blocks
  int rows;            // rows per block
  int smem_bytes;      // dynamic shared memory per block
  int smem_max;        // the most a block may have on this device
  int scratch_floats;  // tagged words the caller allocates, in floats
  int sms;             // streaming multiprocessors
};

cudaError_t make_layout(int n, int m, Layout* out) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  int sms = 0, smem_max = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return e;
  const int rows = (n + sms - 1) / sms;
  const int grid = (n + rows - 1) / rows;
  // slab [rows][m], v [m], u [rows]; words: [grid][m] partials, [m] v.
  const size_t bytes = (static_cast<size_t>(rows) * m + m + rows) * sizeof(float);
  const size_t scratch = 2 * static_cast<size_t>(m) * (grid + 1);
  out->grid = grid;
  out->rows = rows;
  out->smem_bytes = bytes > 0x7fffffff ? 0x7fffffff : static_cast<int>(bytes);
  out->smem_max = smem_max;
  out->scratch_floats = scratch > 0x7fffffff ? 0x7fffffff : static_cast<int>(scratch);
  out->sms = sms;
  return cudaSuccess;
}

}  // namespace

// The geometry of a call on the current device, for the caller to size
// the scratch and check the shared memory: out = {grid, rows, smem_bytes,
// smem_max, scratch_floats, sms, blocks_per_sm}. Returns a cudaError_t.
extern "C" int gie_fused_sinkhorn_layout(int n, int m, int* out) {
  Layout lay;
  cudaError_t e = make_layout(n > 0 ? n : 1, m > 0 ? m : 1, &lay);
  if (e != cudaSuccess) return static_cast<int>(e);
  int per_sm = 0;
  if (lay.smem_bytes <= lay.smem_max) {
    // Once per shape, never per launch: the kernel may take up to the
    // device's opt-in maximum, so every shape whose slab fits launches
    // without another attribute call (none is made under graph capture).
    e = cudaFuncSetAttribute(sinkhorn_persistent,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             lay.smem_max);
    if (e != cudaSuccess) return static_cast<int>(e);
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, sinkhorn_persistent, kThreads, lay.smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  out[0] = lay.grid;
  out[1] = lay.rows;
  out[2] = lay.smem_bytes;
  out[3] = lay.smem_max;
  out[4] = lay.scratch_floats;
  out[5] = lay.sms;
  out[6] = per_sm;
  return 0;
}

// k f32[n, m], cap f32[m], v_init f32[m] -> plan f32[n, m], v_out f32[m].
// scratch: at least the layout's scratch_floats floats, 8-byte aligned,
// caller-allocated; its contents on entry do not matter (the kernel clears
// it before round 1), so a captured launch may reuse it on every replay.
// gie_fused_sinkhorn_layout must have run for this shape on this device
// (it raises the kernel's shared-memory limit). All pointers are device
// pointers, row-major and contiguous. One cooperative launch on `stream`,
// which stream capture records into a CUDA graph like any other launch.
// Returns a cudaError_t (0 = launched): cudaErrorInvalidValue when the K
// slab does not fit in shared memory, cudaErrorCooperativeLaunchTooLarge
// when the grid cannot be resident at once.
extern "C" int gie_fused_sinkhorn_plan(const float* k, const float* cap,
                                       const float* v_init, float* plan,
                                       float* v_out, float* scratch, int n,
                                       int m, int iters, void* stream) {
  if (n <= 0 || m <= 0) return 0;
  Layout lay;
  cudaError_t e = make_layout(n, m, &lay);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (lay.smem_bytes > lay.smem_max) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute coop;
  coop.id = cudaLaunchAttributeCooperative;
  coop.val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(lay.grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = lay.smem_bytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = &coop;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, sinkhorn_persistent, k, cap, v_init, plan,
                         v_out, reinterpret_cast<unsigned long long*>(scratch),
                         n, m, lay.rows, iters > 0 ? iters : 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
