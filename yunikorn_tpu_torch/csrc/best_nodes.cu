// Fused fit + group mask + score + argmax: every pod's best node.
//
// Replaces the TPU kernel of the JAX package, ops/pallas_kernels.py
// (`_best_node_kernel` behind `pallas_best_nodes`), on the odd rounds of the
// assignment solve (ops/assign.py `_solve_rounds`). For each pod i and node j:
//
//   ok(i, j)    = feas[gid[i], j]  AND  free[j, r] >= req[i, r] for every r
//   score(i, j) = base[j] + soft[gid[i], j]          (soft only if kSoft)
//   best[i]     = the ok node of highest score, ties to the lowest j
//   feasible[i] = any ok node; best[i] = 0 when there is none
//
// Two modes, chosen at compile time:
//   exact      bit-equal to the plain argmax (the default solve path): the
//              key is a uint64 with the order-preserving bits of the f32
//              score (after -0.0 -> +0.0, as argmax treats them as equal)
//              high and M-1-j low, so one max picks the best score and, on
//              ties, the lowest node.
//   quantized  bit-equal to the Pallas kernel: q = rint(score * 128) packed as
//              q * index_span + (M - j) in int32 (wrapping), masked nodes at
//              -2^30, best = M - (packed mod index_span).
//
// What bounds it on an H100: at the main-path shape (N = 65,536 pods,
// M = 16,384 nodes, R = 8) the work is N * M * (2R + 2) ~ 1.9e10 32-bit lane
// operations (R compares, R ANDs, the score add, the running max) against
// ~3.5 MB of traffic, so the non-tensor ALU rate bounds it, not memory:
// ~0.29 ms at the 67 TFLOP/s float32 peak, ~0.001 ms of bytes at 3.35 TB/s.
// The design keeps every operand of the inner loop on chip:
// one thread per pod holds its request row in registers and its running best
// in a register; the block stages a tile of nodes (free rows, base scores and
// the G group rows of feas/soft) in shared memory, where every thread of a
// warp reads the same free/base word (a broadcast). No reduction crosses
// threads or blocks. Later work: skip pods that are already placed, split
// the node range across blocks with a second pass, warp-level reductions.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPodsPerBlock = 128;
constexpr int kPackedMin = -(1 << 30);
constexpr float kScoreScale = 128.0f;

__device__ __forceinline__ uint32_t ordered_bits(float s) {
  s = s + 0.0f;  // -0.0 -> +0.0
  const uint32_t u = __float_as_uint(s);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

template <int kMaxR, bool kSoft, bool kQuantized>
__global__ void __launch_bounds__(kPodsPerBlock)
best_nodes_kernel(const int32_t* __restrict__ req,
                  const int32_t* __restrict__ group_id,
                  const uint8_t* __restrict__ feas,
                  const float* __restrict__ soft,
                  const int32_t* __restrict__ free_,
                  const float* __restrict__ base,
                  int n_pods, int n_nodes, int n_groups, int n_res, int tile,
                  int index_span,
                  int32_t* __restrict__ best_out,
                  uint8_t* __restrict__ feasible_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* s_free = reinterpret_cast<int32_t*>(smem);             // [tile, R]
  float* s_base = reinterpret_cast<float*>(s_free + tile * n_res);  // [tile]
  float* s_soft = s_base + tile;                                    // [G, tile]
  uint8_t* s_feas = reinterpret_cast<uint8_t*>(
      s_soft + (kSoft ? n_groups * tile : 0));                      // [G, tile]

  const int pod = blockIdx.x * kPodsPerBlock + threadIdx.x;
  const bool live = pod < n_pods;
  int g = live ? group_id[pod] : 0;
  g = min(max(g, 0), n_groups - 1);  // a gather clamps, as XLA's does

  int32_t rq[kMaxR];
#pragma unroll
  for (int r = 0; r < kMaxR; ++r) {
    rq[r] = (live && r < n_res) ? req[(size_t)pod * n_res + r] : 0;
  }

  uint64_t best_key = 0;
  bool found = false;
  int32_t best_packed = kPackedMin;

  for (int t0 = 0; t0 < n_nodes; t0 += tile) {
    const int tn = min(tile, n_nodes - t0);
    __syncthreads();  // the previous tile is no longer read
    for (int i = threadIdx.x; i < tn * n_res; i += kPodsPerBlock) {
      s_free[i] = free_[(size_t)t0 * n_res + i];
    }
    for (int i = threadIdx.x; i < tn; i += kPodsPerBlock) {
      s_base[i] = base[t0 + i];
    }
    for (int i = threadIdx.x; i < n_groups * tn; i += kPodsPerBlock) {
      const int gg = i / tn;
      const int j = i - gg * tn;
      const size_t src = (size_t)gg * n_nodes + t0 + j;
      s_feas[gg * tile + j] = feas[src];
      if (kSoft) s_soft[gg * tile + j] = soft[src];
    }
    __syncthreads();
    if (!live) continue;

    const uint8_t* f_row = s_feas + g * tile;
    const float* so_row = s_soft + g * tile;
    for (int j = 0; j < tn; ++j) {
      bool ok = f_row[j] != 0;
      const int32_t* fr = s_free + j * n_res;
#pragma unroll
      for (int r = 0; r < kMaxR; ++r) {
        if (r < n_res) ok = ok && (fr[r] >= rq[r]);
      }
      if (!ok) continue;
      const float s = kSoft ? s_base[j] + so_row[j] : s_base[j];
      const int col = t0 + j;
      if (kQuantized) {
        const int32_t q = (int32_t)rintf(s * kScoreScale);
        const int32_t packed = (int32_t)((uint32_t)q * (uint32_t)index_span +
                                         (uint32_t)(n_nodes - col));
        best_packed = max(best_packed, packed);
      } else {
        const uint64_t key = ((uint64_t)ordered_bits(s) << 32) |
                             (uint64_t)(uint32_t)(n_nodes - 1 - col);
        if (!found || key > best_key) {
          best_key = key;
          found = true;
        }
      }
    }
  }
  if (!live) return;
  if (kQuantized) {
    const bool feasible = best_packed > kPackedMin;
    const int32_t frac = best_packed & (index_span - 1);
    best_out[pod] = feasible ? n_nodes - frac : 0;
    feasible_out[pod] = feasible ? 1 : 0;
  } else {
    best_out[pod] =
        found ? n_nodes - 1 - (int32_t)(uint32_t)(best_key & 0xffffffffu) : 0;
    feasible_out[pod] = found ? 1 : 0;
  }
}

template <int kMaxR, bool kSoft, bool kQuantized>
cudaError_t launch(const void* req, const void* group_id, const void* feas,
                   const void* soft, const void* free_, const void* base,
                   int n_pods, int n_nodes, int n_groups, int n_res, int tile,
                   int index_span, void* best, void* feasible,
                   cudaStream_t stream) {
  auto kernel = best_nodes_kernel<kMaxR, kSoft, kQuantized>;
  const size_t smem = (size_t)tile * n_res * 4 + (size_t)tile * 4 +
                      (kSoft ? (size_t)n_groups * tile * 4 : 0) +
                      (size_t)n_groups * tile;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int blocks = (n_pods + kPodsPerBlock - 1) / kPodsPerBlock;
  kernel<<<blocks, kPodsPerBlock, smem, stream>>>(
      static_cast<const int32_t*>(req), static_cast<const int32_t*>(group_id),
      static_cast<const uint8_t*>(feas), static_cast<const float*>(soft),
      static_cast<const int32_t*>(free_), static_cast<const float*>(base),
      n_pods, n_nodes, n_groups, n_res, tile, index_span,
      static_cast<int32_t*>(best), static_cast<uint8_t*>(feasible));
  return cudaGetLastError();
}

template <int kMaxR>
cudaError_t dispatch(int has_soft, int quantized, const void* req,
                     const void* group_id, const void* feas, const void* soft,
                     const void* free_, const void* base, int n_pods,
                     int n_nodes, int n_groups, int n_res, int tile,
                     int index_span, void* best, void* feasible,
                     cudaStream_t stream) {
#define YK_LAUNCH(S, Q)                                                      \
  return launch<kMaxR, S, Q>(req, group_id, feas, soft, free_, base, n_pods, \
                             n_nodes, n_groups, n_res, tile, index_span,    \
                             best, feasible, stream)
  if (has_soft) {
    if (quantized) YK_LAUNCH(true, true);
    YK_LAUNCH(true, false);
  }
  if (quantized) YK_LAUNCH(false, true);
  YK_LAUNCH(false, false);
#undef YK_LAUNCH
}

}  // namespace

extern "C" {

// Widest request row the kernel keeps in registers.
int yk_best_nodes_max_res() { return 64; }

// Returns cudaGetLastError() after the launch (0 = launched).
int yk_best_nodes(const void* req, const void* group_id, const void* feas,
                  const void* soft, const void* free_, const void* base,
                  int n_pods, int n_nodes, int n_groups, int n_res, int tile,
                  int has_soft, int quantized, int index_span, void* best,
                  void* feasible, void* stream) {
  if (n_pods <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_res <= 8) {
    return (int)dispatch<8>(has_soft, quantized, req, group_id, feas, soft,
                            free_, base, n_pods, n_nodes, n_groups, n_res,
                            tile, index_span, best, feasible, s);
  }
  return (int)dispatch<64>(has_soft, quantized, req, group_id, feas, soft,
                           free_, base, n_pods, n_nodes, n_groups, n_res, tile,
                           index_span, best, feasible, s);
}

const char* yk_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
