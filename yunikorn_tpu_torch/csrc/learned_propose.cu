// The learned policy's gated proposal pass: for every active pod, the node
// its two-tower score picks under seeded Gumbel exploration, kept only when
// the pick's score beats the pod's feasible mean by a margin.
//
// Replaces the proposal half of `_learned_chunk_pass` in the JAX package's
// ops/assign.py (an XLA-fused stage there, not a Pallas kernel), called on
// every round of the learned solve (ops/assign `_solve_rounds`). For each
// active pod i and node m:
//
//   ok(i, m)  = feas[gid[i], m]  AND  free[m, r] >= req[i, r] for every r
//   ls(i, m)  = sum_e pod_emb[i, e] * node_emb[m, e]   (e in order, each
//               product and sum rounded: no fused multiply-add)
//   g(i, m)   = -log(-log(u)), u the float32 uniform in [tiny, 1) that
//               threefry2x32 gives under the key fold_in(fold_in(key, rnd),
//               c) at the counter (i - c * chunk) * M + m, c = i / chunk:
//               the reference's Gumbel draw of shape (chunk, M) at
//               [i - c * chunk, m] (utils/prng)
//   pick[i]   = the ok node of largest ls + tau * g, ties to the lowest m
//   nf[i]     = the number of ok nodes
//   lmean[i]  = (sum of ls over the ok nodes) / max(nf, 1)
//   prop[i]   = pick[i] if nf > 0 and ls(i, pick) - lmean > 0.05, else M
//
// Inactive pods come back as prop M, pick 0, nf 0, lmean 0.
//
// What bounds it on an H100: integer operations. Each fitting pair costs
// one threefry2x32 hash (20 rounds of add, rotate, xor, and 5 key
// injections: about 74 32-bit integer operations, with the uniform's shift
// and or), against 64 integer results per clock per SM; then two logf (the
// special-function unit: 16 a clock per SM) and the 16-term dot product
// (31 float32 operations at 128 a clock). The fit test costs R compares per
// pair the group row admits. The [N, M] noise is never stored: the key is
// folded once a chunk, and each pair's counter is its own.
// What the design does about it, in three launches:
//   prep    folds the chunk keys (two threefry hashes each) into a small
//           table, packs the [G, M] mask into 32-node words per group,
//           resets the per-row merge slots and compacts the active rows
//           into a row list counted on the device (nothing is read back).
//   main    a grid of (128-node slice, 128-row tile) blocks. A block stages
//           its slice's free rows and node embeddings in shared memory; a
//           thread owns one row, with its request row, its embedding and its
//           chunk key in registers. A warp walks only the nodes some row of
//           the warp admits (the OR of their group words) and hashes only
//           the pairs that fit. Each row's slice result merges into its slot:
//           the argmax as one atomicMax on an ordered 64-bit key (the score's
//           order-preserving bits high, M - 1 - m low, so ties go to the
//           lowest node), the count by an integer atomicAdd, and the slice's
//           sum of ls into its own cell of a [N, slices] table (no float
//           atomics: the sum is deterministic).
//   finish  adds each row's slice sums in slice order, recomputes ls at the
//           pick in the same order as main, and applies the gate.
// A first, simple design: no tensor cores (a 16-term dot product a pair is
// not a matrix product worth a wgmma tile), no TMA.
#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;      // rows of a tile, one a thread
constexpr int kSlice = 128;        // nodes of a block's slice
constexpr int kWords = kSlice / 32;
constexpr int kPrepThreads = 256;
constexpr int kGridRowTiles = 128;
constexpr float kGateMargin = 0.05f;    // policy/net.GATE_MARGIN
constexpr float kTiny = 1.17549435e-38f;  // the smallest normal float32
constexpr uint32_t kParity = 0x1BD11BDAu;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int d) {
  return __funnelshift_l(x, x, d);
}

#define YK_ROUND(r)   \
  x0 += x1;           \
  x1 = rotl(x1, r);   \
  x1 ^= x0;

// threefry2x32 (20 rounds) of the counter pair (x0, x1) under (k0, k1), in
// place: utils/prng.threefry2x32.
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ kParity;
  x0 += k0;
  x1 += k1;
  YK_ROUND(13) YK_ROUND(15) YK_ROUND(26) YK_ROUND(6)
  x0 += k1; x1 += k2 + 1u;
  YK_ROUND(17) YK_ROUND(29) YK_ROUND(16) YK_ROUND(24)
  x0 += k2; x1 += k0 + 2u;
  YK_ROUND(13) YK_ROUND(15) YK_ROUND(26) YK_ROUND(6)
  x0 += k0; x1 += k1 + 3u;
  YK_ROUND(17) YK_ROUND(29) YK_ROUND(16) YK_ROUND(24)
  x0 += k1; x1 += k2 + 4u;
  YK_ROUND(13) YK_ROUND(15) YK_ROUND(26) YK_ROUND(6)
  x0 += k2; x1 += k0 + 5u;
}

#undef YK_ROUND

__device__ __forceinline__ uint32_t ordered_bits(float s) {
  s = s + 0.0f;  // -0.0 -> +0.0
  const uint32_t u = __float_as_uint(s);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// Standard Gumbel noise of one 32-bit word: utils/prng.uniform's float in
// [tiny, 1) (the top 23 bits as a mantissa in [1, 2), minus 1, plus tiny,
// floored at tiny), then -log(-log(u)).
__device__ __forceinline__ float gumbel_of(uint32_t bits) {
  const float f = __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
  const float u = fmaxf(__fadd_rn(f, kTiny), kTiny);
  return -logf(-logf(u));
}

// ls of one pair, e in order: products and sums each rounded.
template <int kE>
__device__ __forceinline__ float dot_rn(const float* pe, const float* ne) {
  float acc = __fmul_rn(pe[0], ne[0]);
#pragma unroll
  for (int e = 1; e < kE; ++e) acc = __fadd_rn(acc, __fmul_rn(pe[e], ne[e]));
  return acc;
}

// One thread per (group, padded node) and per row: words [G, W]; the row
// slots reset; the active rows compacted into row_list (one atomicAdd on the
// count per block, so rows keep their order inside each block of 256); the
// chunk keys [n_chunks, 2] folded from the call's key.
__global__ void __launch_bounds__(kPrepThreads)
prep_kernel(const uint8_t* __restrict__ feas,
            const uint8_t* __restrict__ active,
            const int64_t* __restrict__ key, int rnd, int n_chunks,
            int n_nodes, int n_groups, int n_words, int n_rows,
            uint32_t* words, uint32_t* chunk_keys,
            unsigned long long* row_key, int32_t* row_nf, int32_t* row_list,
            int32_t* row_count) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t < n_rows) {
    row_key[t] = 0ull;
    row_nf[t] = 0;
  }
  if (t < n_chunks) {
    uint32_t r0 = 0u, r1 = (uint32_t)rnd;
    threefry2x32((uint32_t)key[0], (uint32_t)key[1], r0, r1);
    uint32_t c0 = 0u, c1 = (uint32_t)t;
    threefry2x32(r0, r1, c0, c1);
    chunk_keys[2 * t] = c0;
    chunk_keys[2 * t + 1] = c1;
  }
  if ((int)(blockIdx.x * blockDim.x) < n_rows) {  // uniform over the block
    __shared__ int s_warp[kPrepThreads / 32];
    __shared__ int s_base;
    const bool want = t < n_rows && active[t];
    const unsigned ballot = __ballot_sync(0xffffffffu, want);
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    if (lane == 0) s_warp[warp] = __popc(ballot);
    __syncthreads();
    if (threadIdx.x == 0) {
      int total = 0;
      for (int w = 0; w < kPrepThreads / 32; ++w) {
        const int c = s_warp[w];
        s_warp[w] = total;
        total += c;
      }
      s_base = atomicAdd(row_count, total);
    }
    __syncthreads();
    if (want) {
      row_list[s_base + s_warp[warp] + __popc(ballot & ((1u << lane) - 1u))] =
          t;
    }
  }
  const int padded = n_words * 32;
  // padded is a multiple of 32, so this exit is uniform over each warp
  if (t >= n_groups * padded) return;
  const int g = t / padded;
  const int j = t - g * padded;
  const bool bit = j < n_nodes && feas[(size_t)g * n_nodes + j];
  const unsigned bits = __ballot_sync(0xffffffffu, bit);
  if ((t & 31) == 0) words[t >> 5] = bits;
}

template <int kMaxR, int kE>
__global__ void __launch_bounds__(kThreads)
propose_kernel(const int32_t* __restrict__ req,
               const int32_t* __restrict__ group_id,
               const int32_t* __restrict__ free_,
               const float* __restrict__ pod_emb,
               const float* __restrict__ node_emb,
               const uint32_t* __restrict__ words,
               const uint32_t* __restrict__ chunk_keys,
               const int32_t* __restrict__ rows,
               const int32_t* __restrict__ row_count, int n_rows,
               int n_nodes, int n_groups, int n_res, int n_words,
               int n_slices, int chunk, float tau,
               unsigned long long* __restrict__ row_key,
               int32_t* __restrict__ row_nf, float* __restrict__ partial) {
  // [kSlice, res4] free rows, then [kSlice, kE] node embeddings
  extern __shared__ __align__(16) int32_t s_free[];
  const int count = min(*row_count, n_rows);
  if ((int)blockIdx.y * kThreads >= count) return;  // uniform
  const int res4 = (n_res + 3) & ~3;
  float* s_emb = reinterpret_cast<float*>(s_free + kSlice * res4);
  const int s0 = blockIdx.x * kSlice;
  const int sn = min(kSlice, n_nodes - s0);
  for (int i = threadIdx.x; i < kSlice * res4; i += kThreads) {
    const int j = i / res4;
    const int r = i - j * res4;
    // padding columns fit every request (req 0); nodes past the slice are
    // never visited (their mask bits are 0)
    s_free[i] = (j < sn && r < n_res) ? free_[(size_t)(s0 + j) * n_res + r]
                                      : INT_MAX;
  }
  for (int i = threadIdx.x; i < kSlice * kE; i += kThreads) {
    const int j = i / kE;
    s_emb[i] = j < sn ? node_emb[(size_t)s0 * kE + i] : 0.0f;
  }
  __syncthreads();

  const int n_tiles = (count + kThreads - 1) / kThreads;
  for (int tile = blockIdx.y; tile < n_tiles; tile += gridDim.y) {
    const int t = tile * kThreads + threadIdx.x;
    const int row = t < count ? rows[t] : -1;
    int32_t rq[kMaxR];
    float pe[kE];
    int w_off = 0;
    uint32_t k0 = 0u, k1 = 0u;
    unsigned long long base = 0ull;
    if (row >= 0) {
      int g = group_id[row];
      g = min(max(g, 0), n_groups - 1);  // a gather clamps, as XLA's does
      w_off = g * n_words;
      const int c = row / chunk;
      k0 = chunk_keys[2 * c];
      k1 = chunk_keys[2 * c + 1];
      base = (unsigned long long)(row - c * chunk) * (unsigned)n_nodes + s0;
    }
#pragma unroll
    for (int r = 0; r < kMaxR; ++r) {
      rq[r] = (row >= 0 && r < n_res) ? req[(size_t)row * n_res + r] : 0;
    }
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      pe[e] = row >= 0 ? pod_emb[(size_t)row * kE + e] : 0.0f;
    }
    float best_v = 0.0f, sum = 0.0f;
    int best_j = -1, nf = 0;
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
      const int gw = blockIdx.x * kWords + w;
      const uint32_t m =
          (row >= 0 && gw < n_words) ? __ldg(words + w_off + gw) : 0u;
      uint32_t todo = __reduce_or_sync(0xffffffffu, m);
      while (todo) {
        const int b = __ffs(todo) - 1;
        todo &= todo - 1;
        const int j = w * 32 + b;
        const int32_t* fr = s_free + j * res4;
        bool ok = (m >> b) & 1u;
#pragma unroll
        for (int r = 0; r < kMaxR; r += 4) {
          if (r < res4) {
            const int4 f = *reinterpret_cast<const int4*>(fr + r);
            ok = ok & (f.x >= rq[r]) & (f.y >= rq[r + 1]) &
                 (f.z >= rq[r + 2]) & (f.w >= rq[r + 3]);
          }
        }
        if (ok) {
          const float ls = dot_rn<kE>(pe, s_emb + j * kE);
          ++nf;
          sum = __fadd_rn(sum, ls);
          const unsigned long long idx = base + (unsigned)j;
          uint32_t x0 = (uint32_t)(idx >> 32), x1 = (uint32_t)idx;
          threefry2x32(k0, k1, x0, x1);
          const float v = __fadd_rn(ls, __fmul_rn(tau, gumbel_of(x0 ^ x1)));
          if (best_j < 0 || v > best_v) {  // nodes ascend: first max kept
            best_v = v;
            best_j = s0 + j;
          }
        }
      }
    }
    if (row >= 0) {
      partial[(size_t)row * n_slices + blockIdx.x] = sum;
      if (nf > 0) {
        atomicAdd(row_nf + row, nf);
        atomicMax(row_key + row,
                  ((unsigned long long)ordered_bits(best_v) << 32) |
                      (unsigned long long)(uint32_t)(n_nodes - 1 - best_j));
      }
    }
  }
}

template <int kE>
__global__ void finish_kernel(const uint8_t* __restrict__ active,
                              const float* __restrict__ pod_emb,
                              const float* __restrict__ node_emb,
                              const unsigned long long* __restrict__ row_key,
                              const int32_t* __restrict__ row_nf,
                              const float* __restrict__ partial, int n_rows,
                              int n_nodes, int n_slices,
                              int32_t* __restrict__ prop,
                              int32_t* __restrict__ pick,
                              int32_t* __restrict__ nf_out,
                              float* __restrict__ lmean_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rows) return;
  if (!active[i]) {
    prop[i] = n_nodes;
    pick[i] = 0;
    nf_out[i] = 0;
    lmean_out[i] = 0.0f;
    return;
  }
  float sum = 0.0f;
  for (int s = 0; s < n_slices; ++s) {
    sum = __fadd_rn(sum, partial[(size_t)i * n_slices + s]);
  }
  const int nf = row_nf[i];
  const float lmean = __fdiv_rn(sum, fmaxf((float)nf, 1.0f));
  const unsigned long long k = row_key[i];
  const int p = k ? n_nodes - 1 - (int)(uint32_t)(k & 0xffffffffull) : 0;
  bool good = false;
  if (nf > 0) {
    float pe[kE], ne[kE];
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      pe[e] = pod_emb[(size_t)i * kE + e];
      ne[e] = node_emb[(size_t)p * kE + e];
    }
    good = __fsub_rn(dot_rn<kE>(pe, ne), lmean) > kGateMargin;
  }
  prop[i] = good ? p : n_nodes;
  pick[i] = p;
  nf_out[i] = nf;
  lmean_out[i] = lmean;
}

struct Args {
  const void *req, *group_id, *feas, *free_, *active, *pod_emb, *node_emb,
      *key;
  int rnd, chunk;
  float tau;
  int n_rows, n_nodes, n_groups, n_res;
  void *words, *chunk_keys, *row_key, *row_nf, *row_list, *row_count,
      *partial, *prop, *pick, *nf, *lmean;
};

template <int kMaxR, int kE>
cudaError_t run(const Args& a, cudaStream_t stream) {
  const int n_words = (a.n_nodes + 31) / 32;
  const int n_slices = (a.n_nodes + kSlice - 1) / kSlice;
  const int n_chunks = (a.n_rows + a.chunk - 1) / a.chunk;
  int prep_threads = a.n_groups * n_words * 32;
  if (prep_threads < a.n_rows) prep_threads = a.n_rows;
  if (prep_threads < n_chunks) prep_threads = n_chunks;
  cudaError_t err;
  if ((err = cudaMemsetAsync(a.row_count, 0, sizeof(int32_t), stream)) !=
      cudaSuccess) {
    return err;
  }
  prep_kernel<<<(prep_threads + kPrepThreads - 1) / kPrepThreads,
                kPrepThreads, 0, stream>>>(
      static_cast<const uint8_t*>(a.feas),
      static_cast<const uint8_t*>(a.active),
      static_cast<const int64_t*>(a.key), a.rnd, n_chunks, a.n_nodes,
      a.n_groups, n_words, a.n_rows, static_cast<uint32_t*>(a.words),
      static_cast<uint32_t*>(a.chunk_keys),
      static_cast<unsigned long long*>(a.row_key),
      static_cast<int32_t*>(a.row_nf), static_cast<int32_t*>(a.row_list),
      static_cast<int32_t*>(a.row_count));
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (a.n_nodes > 0) {
    const int res4 = (a.n_res + 3) & ~3;
    int tiles = (a.n_rows + kThreads - 1) / kThreads;
    tiles = tiles > kGridRowTiles ? kGridRowTiles : tiles;
    const dim3 grid(n_slices, tiles);
    const size_t smem = (size_t)kSlice * (res4 + kE) * sizeof(int32_t);
    propose_kernel<kMaxR, kE><<<grid, kThreads, smem, stream>>>(
        static_cast<const int32_t*>(a.req),
        static_cast<const int32_t*>(a.group_id),
        static_cast<const int32_t*>(a.free_),
        static_cast<const float*>(a.pod_emb),
        static_cast<const float*>(a.node_emb),
        static_cast<const uint32_t*>(a.words),
        static_cast<const uint32_t*>(a.chunk_keys),
        static_cast<const int32_t*>(a.row_list),
        static_cast<const int32_t*>(a.row_count), a.n_rows, a.n_nodes,
        a.n_groups, a.n_res, n_words, n_slices, a.chunk, a.tau,
        static_cast<unsigned long long*>(a.row_key),
        static_cast<int32_t*>(a.row_nf), static_cast<float*>(a.partial));
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  finish_kernel<kE><<<(a.n_rows + 255) / 256, 256, 0, stream>>>(
      static_cast<const uint8_t*>(a.active),
      static_cast<const float*>(a.pod_emb),
      static_cast<const float*>(a.node_emb),
      static_cast<const unsigned long long*>(a.row_key),
      static_cast<const int32_t*>(a.row_nf),
      static_cast<const float*>(a.partial), a.n_rows, a.n_nodes, n_slices,
      static_cast<int32_t*>(a.prop), static_cast<int32_t*>(a.pick),
      static_cast<int32_t*>(a.nf), static_cast<float*>(a.lmean));
  return cudaGetLastError();
}

template <int kMaxR>
cudaError_t dispatch(int emb, const Args& a, cudaStream_t s) {
  return emb == 16 ? run<kMaxR, 16>(a, s) : run<kMaxR, 32>(a, s);
}

}  // namespace

extern "C" {

// Widest request row the kernel keeps in registers.
int yk_learned_propose_max_res() { return 64; }

// Nodes per block slice (the width of one cell of the partial-sum table).
int yk_learned_propose_slice_nodes() { return kSlice; }

// req [n_rows, n_res] int32, group_id [n_rows] int32, feas [G, n_nodes]
// bool, free_ [n_nodes, n_res] int32, active [n_rows] bool, pod_emb
// [n_rows, emb] and node_emb [n_nodes, emb] float32 (emb 16 or 32, zero
// padded), key [2] int64 (two 32-bit words). Scratch: words [G, ceil(n_nodes
// / 32)] uint32, chunk_keys [ceil(n_rows / chunk), 2] uint32, row_key
// [n_rows] uint64, row_nf, row_list [n_rows] and row_count [1] int32,
// partial [n_rows, ceil(n_nodes / slice)] float32. Outputs prop, pick, nf
// [n_rows] int32 and lmean [n_rows] float32. Returns the first CUDA error of
// the launches (0 = launched).
int yk_learned_propose(const void* req, const void* group_id,
                       const void* feas, const void* free_,
                       const void* active, const void* pod_emb,
                       const void* node_emb, const void* key, int rnd,
                       int chunk, float tau, int n_rows, int n_nodes,
                       int n_groups, int n_res, int emb, void* words,
                       void* chunk_keys, void* row_key, void* row_nf,
                       void* row_list, void* row_count, void* partial,
                       void* prop, void* pick, void* nf, void* lmean,
                       void* stream) {
  if (n_rows <= 0) return 0;
  if ((emb != 16 && emb != 32) || chunk <= 0 || n_groups < 1 ||
      n_res > 64) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{req,      group_id, feas,       free_,   active,  pod_emb,
               node_emb, key,      rnd,        chunk,   tau,     n_rows,
               n_nodes,  n_groups, n_res,      words,   chunk_keys,
               row_key,  row_nf,   row_list,   row_count, partial, prop,
               pick,     nf,       lmean};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_res <= 8) return (int)dispatch<8>(emb, a, s);
  return (int)dispatch<64>(emb, a, s);
}

const char* yk_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
