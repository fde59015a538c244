// Fused fit + group mask + score + argmax: the best node of each requested pod.
//
// Replaces the TPU kernel of the JAX package, ops/pallas_kernels.py
// (`_best_node_kernel` behind `pallas_best_nodes`), on the odd rounds of the
// assignment solve (ops/assign.py `_solve_rounds`). For each requested pod i
// and node j:
//
//   ok(i, j)    = feas[gid[i], j]  AND  free[j, r] >= req[i, r] for every r
//   score(i, j) = base[j] + soft[gid[i], j]          (soft only if kSoft)
//   best[i]     = the ok node of highest score, ties to the lowest j
//   feasible[i] = any ok node; best[i] = 0 when there is none
//
// Pods that are not requested come back as best 0, feasible 0.
//
// The planned-domain bonus (topology steering; the reference's steered
// rounds take its plain argmax): given node_dom [M] and pref [N],
//   score(i, j) = fl(fl(base[j] + soft[gid[i], j]) + 8)  when
//                 pref[i] >= 0 and node_dom[j] == pref[i], else as above.
// The score now depends on the pod, not only on its group, so prep folds a
// second key table from the ROUNDED sum fl(s + 8) (the add can merge
// distinct scores into a tie, which must still go to the lowest node, so
// the bonus key cannot be derived from the plain one), main stages the
// slice's node_dom beside its free rows and, for each fitting pair, reads
// the bonus key when the domains match. The bonus runs in the exact mode.
//
// The learned term (solver.policy=learned; the reference's learned argmax in
// `_learned_chunk_pass`, ops/assign.py of the JAX package): given pod_emb
// [N, E] and node_emb [M, E] (E zero-padded to 16 or 32),
//   score(i, j) = fl(s(i, j) + ls(i, j)),  ls = sum_e pod_emb[i, e] *
//                 node_emb[j, e], e in order, each product and sum rounded,
// s the score above (with the bonus when it applies). The exact key keeps
// s's order-preserving bits, so main decodes s from the key it reads for a
// fitting pair, adds ls (the pod's embedding in registers, the slice's node
// embeddings staged in shared memory beside its free rows) and re-encodes.
// Exact mode with the soft matrix only, as the reference's learned argmax.
//
// Two modes, chosen at compile time, both a max over one key per
// (group, node):
//   exact      bit-equal to the plain argmax (the default solve path): a
//              uint64 with the order-preserving bits of the f32 score (after
//              -0.0 -> +0.0, as argmax treats them as equal) high and M-1-j
//              low, so one max picks the best score and, on ties, the lowest
//              node. 0 marks an excluded node: the bits are never 0 for a
//              non-NaN score.
//   quantized  bit-equal to the Pallas kernel: q = rint(score * 128) packed as
//              q * index_span + (M - j) in int32 (wrapping); excluded nodes
//              and packings at or below -2^30 hold -2^30, which no max picks;
//              best = M - (packed mod index_span).
// Keys are unique per node, so the max is the same in any order.
//
// A node shard (parallel/mesh: the solve's node axis cut into slices, one
// call per slice): given node_offset and m_total (the slice's first global
// node and the whole node count; 0 and n_nodes otherwise), the exact key's
// low word is m_total-1-(node_offset+j), the node's GLOBAL reverse index,
// and keys_out [n_rows] int64 receives each row's key with its top bit
// flipped (0 -> INT64_MIN for a row with no feasible node or not requested),
// so the signed max over the shards' keys is the key of the whole call: the
// same best node, bit for bit, in any shard order. best stays the slice's
// local index. Exact mode only.
//
// What bounds it on an H100: compares. Each (pod, admitted node) pair costs
// R integer compares, each ANDing the running fit predicate in the same
// instruction (ISETP takes a predicate input), and each pair that fits one
// max; the card issues compares, min/max and bitwise ops at 64 results per
// clock per SM (half its f32 add rate), against ~1 MB of node state that
// sits in L2.
// There are no products, so wgmma and the tensor cores have no role. The
// bonus adds one compare per fitting pair (the domain match) and a second
// key table of the same size as the first. The learned term adds E products
// and E adds per fitting pair (a 16-term dot product: no tile for wgmma).
// What the design does about it, in three launches:
//   prep    once per call, over (group, node): folds base, soft and the group
//           mask into the key (the score add is done G*M times, not N*M) and
//           into 32-node bit words of admitted nodes per group. Its first N
//           threads reset the per-row merge slots and compact the caller's
//           row mask into a row list, counting it in device memory with one
//           atomicAdd per block: nothing is read back to the host.
//   main    a grid of (64-node slice, 256-row tile) blocks: thousands of
//           blocks for the 132 SMs already at ~4,000 rows. Rows are requested
//           rows only, and their count stays on the device: the grid has at
//           most 128 row tiles, blocks past the count return at once, and
//           each block loops over the tiles past the grid. Each
//           block stages its slice's free rows in shared memory with
//           cp.async, one commit group per 32-node word, and starts on the
//           first word while the rest lands; several blocks per SM overlap
//           one block's copy with the others' compares. A thread owns 2 pods
//           whose request rows stay in registers, so one 16-byte broadcast
//           load of a free row serves both; the R compares chain through the
//           predicate AND. A warp walks only the nodes some pod of the warp
//           admits: the OR over the warp of its pods' group words (the row
//           list keeps batch order within blocks of 256, so a warp mostly
//           holds one app and one group) skips padding columns and excluded
//           nodes 32 at a time and visits the rest one set bit at a time.
//           The key is read (from L1/L2) only for a pair that fits. Each
//           pod's best over the slice merges into its row's slot with one
//           atomicMax.
//   finish  decodes each row's slot into (best, feasible).
// Tried on an H100 at the main path's inputs: 2 pods a thread beat 4 and 8
// (fewer registers, more warps in flight) at ~4,500 rows and tie at 65,536;
// 64-node slices beat 128, 256 and 512 at ~4,500 rows (more, shorter
// blocks) and lose a little to 128 at 65,536; 64 or 256 threads a block,
// loading all of a slice's group words up front, and sizing the grid from a
// host-side bound on the requested rows rather than 128 row tiles, changed
// nothing.
#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunks = 2;
constexpr int kPackedMin = -(1 << 30);
constexpr float kScoreScale = 128.0f;
// the planned-domain bonus (ops/best_nodes.TOPO_GANG_W)
constexpr float kPrefBonus = 8.0f;

template <bool kQuantized>
struct Key {
  using T = unsigned long long;
  static constexpr T kNone = 0ull;
};
template <>
struct Key<true> {
  using T = int;
  static constexpr T kNone = kPackedMin;
};

// Nodes per block slice: kChunks copy stages of one 32-node word each.
constexpr int kSlice = 32 * kChunks;
constexpr int kPrepThreads = 256;
// Row tiles in the main launch's grid; blocks loop over the tiles past it.
constexpr int kGridRowTiles = 128;

template <int kMaxR>
__host__ __device__ constexpr int pods_per_thread() {
  return kMaxR <= 8 ? 2 : 1;
}

__device__ __forceinline__ uint32_t ordered_bits(float s) {
  s = s + 0.0f;  // -0.0 -> +0.0
  const uint32_t u = __float_as_uint(s);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The score whose ordered bits are u (ordered_bits' inverse; -0.0 comes
// back as +0.0, which the argmax treats alike).
__device__ __forceinline__ float from_ordered_bits(uint32_t u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7FFFFFFFu) : ~u);
}

// The learned term of one pair, e in order: products and sums each rounded
// (no fused multiply-add), as ops/best_nodes.learned_dot computes it.
template <int kE>
__device__ __forceinline__ float dot_rn(const float* pe, const float* ne) {
  float acc = __fmul_rn(pe[0], ne[0]);
#pragma unroll
  for (int e = 1; e < kE; ++e) acc = __fadd_rn(acc, __fmul_rn(pe[e], ne[e]));
  return acc;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most n of this thread's commit groups are still in flight
__device__ __forceinline__ void cp_async_wait_pending(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
  }
}

// One thread per (group, padded node): keys [G, 32W] (and with the bonus
// bonus_keys [G, 32W]), words [G, W]. The first n_rows threads also reset
// the merge slots and, given a row mask, append their row to the compacted
// list: one atomicAdd on the count per block, so rows keep their order
// inside each block of 256.
template <bool kSoft, bool kQuantized, bool kBonus>
__global__ void __launch_bounds__(kPrepThreads)
prep_kernel(const uint8_t* __restrict__ feas, const float* __restrict__ soft,
            const float* __restrict__ base, const uint8_t* __restrict__ mask,
            int n_nodes, int n_groups, int n_words, int index_span,
            int node_offset, int m_total,
            int n_rows, typename Key<kQuantized>::T* keys,
            typename Key<kQuantized>::T* bonus_keys, uint32_t* words,
            typename Key<kQuantized>::T* row_best, int32_t* row_list,
            int32_t* row_count) {
  using K = Key<kQuantized>;
  using T = typename K::T;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t < n_rows) row_best[t] = K::kNone;
  if (mask != nullptr && (int)(blockIdx.x * blockDim.x) < n_rows) {
    __shared__ int s_warp[kPrepThreads / 32];
    __shared__ int s_base;
    const bool want = t < n_rows && mask[t];
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
  T key = K::kNone;
  T bkey = K::kNone;
  if (j < n_nodes && feas[(size_t)g * n_nodes + j]) {
    const float s = kSoft ? base[j] + soft[(size_t)g * n_nodes + j] : base[j];
    if constexpr (kQuantized) {
      const int32_t q = (int32_t)rintf(s * kScoreScale);
      const int32_t packed = (int32_t)((uint32_t)q * (uint32_t)index_span +
                                       (uint32_t)(n_nodes - j));
      key = max(packed, kPackedMin);
    } else {
      const T low = (T)(uint32_t)(m_total - 1 - (node_offset + j));
      key = ((T)ordered_bits(s) << 32) | low;
      if constexpr (kBonus) {
        // the rounded sum, as the plain argmax sees it
        bkey = ((T)ordered_bits(__fadd_rn(s, kPrefBonus)) << 32) | low;
      }
    }
  }
  keys[t] = key;
  if constexpr (kBonus) bonus_keys[t] = bkey;
  const unsigned bits = __ballot_sync(0xffffffffu, key > K::kNone);
  if ((t & 31) == 0) words[t >> 5] = bits;
}

// kE: the (padded) embedding width of the learned term, 0 = none.
template <int kMaxR, bool kQuantized, bool kBonus, int kE>
__global__ void __launch_bounds__(kThreads)
best_nodes_kernel(const int32_t* __restrict__ req,
                  const int32_t* __restrict__ group_id,
                  const int32_t* __restrict__ free_,
                  const typename Key<kQuantized>::T* __restrict__ keys,
                  const typename Key<kQuantized>::T* __restrict__ bonus_keys,
                  const int32_t* __restrict__ node_dom,
                  const int32_t* __restrict__ pref,
                  const float* __restrict__ pod_emb,
                  const float* __restrict__ node_emb,
                  const uint32_t* __restrict__ words,
                  const int32_t* __restrict__ rows,
                  const int32_t* __restrict__ row_count, int n_rows,
                  int n_nodes, int n_groups, int n_res, int n_words,
                  typename Key<kQuantized>::T* __restrict__ row_best) {
  using K = Key<kQuantized>;
  using T = typename K::T;
  constexpr int kPods = pods_per_thread<kMaxR>();
  constexpr int kRowsPerTile = kThreads * kPods;
  // [kSlice, res4] free rows, then (learned) the slice's [kSlice, kE] node
  // embeddings, then (bonus) its [kSlice] domains
  extern __shared__ __align__(16) int32_t s_free[];

  const int count = row_count ? min(*row_count, n_rows) : n_rows;
  if ((int)blockIdx.y * kRowsPerTile >= count) return;  // uniform
  const int res4 = (n_res + 3) & ~3;
  const int s0 = blockIdx.x * kSlice;
  const int sn = min(kSlice, n_nodes - s0);
  const int padded = n_words * 32;
  const bool vec =
      (n_res & 3) == 0 && (reinterpret_cast<uintptr_t>(free_) & 15) == 0;
  float* s_emb = reinterpret_cast<float*>(s_free + kSlice * res4);
  int32_t* s_dom = s_free + kSlice * (res4 + kE);
  if constexpr (kE > 0) {
    // plain stores: the first tile's __syncthreads below orders them
    for (int i = threadIdx.x; i < kSlice * kE; i += kThreads) {
      s_emb[i] = i / kE < sn ? node_emb[(size_t)s0 * kE + i] : 0.0f;
    }
  }
  if constexpr (kBonus) {
    // plain stores: the first tile's __syncthreads below orders them
    for (int j = threadIdx.x; j < kSlice; j += kThreads) {
      s_dom[j] = j < sn ? node_dom[s0 + j] : -1;
    }
  }

#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int j0 = c * 32;
    const int jn = max(0, min(32, sn - j0));
    const int32_t* src = free_ + (size_t)(s0 + j0) * n_res;
    int32_t* dst = s_free + j0 * res4;
    if (vec) {  // res4 == n_res: rows are contiguous in both places
      for (int i = threadIdx.x * 4; i < jn * n_res; i += kThreads * 4) {
        cp_async16(dst + i, src + i);
      }
    } else {
      for (int i = threadIdx.x; i < jn * res4; i += kThreads) {
        const int j = i / res4;
        const int r = i - j * res4;
        if (r < n_res) {
          cp_async4(dst + i, src + (size_t)j * n_res + r);
        } else {
          dst[i] = INT_MAX;  // padding columns fit every request (req 0)
        }
      }
    }
    cp_async_commit();
  }

  const int n_tiles = (count + kRowsPerTile - 1) / kRowsPerTile;
  const int w_base = blockIdx.x * kChunks;
  bool staged = false;
  for (int tile = blockIdx.y; tile < n_tiles; tile += gridDim.y) {
    int row[kPods], w_off[kPods], k_off[kPods], pf[kPods];
    int32_t rq[kPods][kMaxR];
    float pe[kPods][kE > 0 ? kE : 1];
    T best[kPods];
#pragma unroll
    for (int p = 0; p < kPods; ++p) {
      const int i = tile * kRowsPerTile + p * kThreads + threadIdx.x;
      row[p] = i < count ? (rows ? rows[i] : i) : -1;
      int g = row[p] >= 0 ? group_id[row[p]] : 0;
      g = min(max(g, 0), n_groups - 1);  // a gather clamps, as XLA's does
      w_off[p] = g * n_words;
      k_off[p] = g * padded + s0;
      pf[p] = (kBonus && row[p] >= 0) ? pref[row[p]] : -1;
#pragma unroll
      for (int r = 0; r < kMaxR; ++r) {
        rq[p][r] = (row[p] >= 0 && r < n_res)
                       ? req[(size_t)row[p] * n_res + r] : 0;
      }
      if constexpr (kE > 0) {
#pragma unroll
        for (int e = 0; e < kE; ++e) {
          pe[p][e] = row[p] >= 0 ? pod_emb[(size_t)row[p] * kE + e] : 0.0f;
        }
      }
      best[p] = K::kNone;
    }
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      if (!staged) {  // the first tile waits for each word's rows in turn
        cp_async_wait_pending(kChunks - 1 - c);
        __syncthreads();
      }
      const int gw = w_base + c;
      uint32_t m[kPods];
      uint32_t any = 0;
#pragma unroll
      for (int p = 0; p < kPods; ++p) {
        m[p] = (row[p] >= 0 && gw < n_words) ? __ldg(words + w_off[p] + gw)
                                             : 0u;
        any |= m[p];
      }
      uint32_t todo = __reduce_or_sync(0xffffffffu, any);
      while (todo) {
        const int b = __ffs(todo) - 1;
        todo &= todo - 1;
        const int j = c * 32 + b;
        const int32_t* fr = s_free + j * res4;
        bool ok[kPods];
#pragma unroll
        for (int p = 0; p < kPods; ++p) ok[p] = (m[p] >> b) & 1u;
#pragma unroll
        for (int r = 0; r < kMaxR; r += 4) {
          if (r < res4) {
            const int4 f = *reinterpret_cast<const int4*>(fr + r);
#pragma unroll
            for (int p = 0; p < kPods; ++p) {
              ok[p] = ok[p] & (f.x >= rq[p][r]) & (f.y >= rq[p][r + 1]) &
                      (f.z >= rq[p][r + 2]) & (f.w >= rq[p][r + 3]);
            }
          }
        }
#pragma unroll
        for (int p = 0; p < kPods; ++p) {
          if (ok[p]) {
            const T* table = keys;
            if constexpr (kBonus) {
              if (pf[p] >= 0 && s_dom[j] == pf[p]) table = bonus_keys;
            }
            T k = __ldg(table + k_off[p] + j);
            if constexpr (kE > 0) {
              // s from the key's high word, plus ls, re-encoded; the low
              // word (the node) stays
              const float s = from_ordered_bits((uint32_t)(k >> 32));
              const float ls = dot_rn<kE>(pe[p], s_emb + j * kE);
              k = ((T)ordered_bits(__fadd_rn(s, ls)) << 32) |
                  (k & 0xffffffffull);
            }
            if (k > best[p]) best[p] = k;
          }
        }
      }
    }
    staged = true;
#pragma unroll
    for (int p = 0; p < kPods; ++p) {
      if (row[p] >= 0 && best[p] != K::kNone) {
        atomicMax(row_best + row[p], best[p]);
      }
    }
  }
}

template <bool kQuantized>
__global__ void finish_kernel(const typename Key<kQuantized>::T* row_best,
                              int n_rows, int n_nodes, int index_span,
                              int node_offset, int m_total,
                              int32_t* __restrict__ best,
                              uint8_t* __restrict__ feasible,
                              long long* __restrict__ keys_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rows) return;
  const auto k = row_best[i];
  bool found;
  int32_t b;
  if constexpr (kQuantized) {
    found = k > kPackedMin;
    b = n_nodes - (k & (index_span - 1));
  } else {
    found = k != 0ull;
    b = m_total - 1 - node_offset - (int32_t)(uint32_t)(k & 0xffffffffull);
    if (keys_out != nullptr) {
      keys_out[i] = (long long)(k ^ 0x8000000000000000ull);
    }
  }
  best[i] = found ? b : 0;
  feasible[i] = found ? 1 : 0;
}

struct Args {
  const void *req, *group_id, *feas, *soft, *free_, *base, *mask, *node_dom,
      *pref, *pod_emb, *node_emb;
  int n_rows, n_nodes, n_groups, n_res, index_span, node_offset, m_total;
  void *keys, *bonus_keys, *words, *row_best, *row_list, *row_count, *best,
      *feasible, *keys_out;
};

template <int kMaxR, bool kSoft, bool kQuantized, bool kBonus, int kE = 0>
cudaError_t run(const Args& a, cudaStream_t stream) {
  using T = typename Key<kQuantized>::T;
  constexpr int kRowsPerTile = kThreads * pods_per_thread<kMaxR>();
  const int n_words = (a.n_nodes + 31) / 32;
  const int prep_threads = a.n_groups * n_words * 32 > a.n_rows
                               ? a.n_groups * n_words * 32 : a.n_rows;
  cudaError_t err;
  if (a.mask != nullptr &&
      (err = cudaMemsetAsync(a.row_count, 0, sizeof(int32_t), stream)) !=
          cudaSuccess) {
    return err;
  }
  prep_kernel<kSoft, kQuantized, kBonus>
      <<<(prep_threads + kPrepThreads - 1) / kPrepThreads, kPrepThreads, 0,
         stream>>>(
          static_cast<const uint8_t*>(a.feas),
          static_cast<const float*>(a.soft), static_cast<const float*>(a.base),
          static_cast<const uint8_t*>(a.mask), a.n_nodes, a.n_groups, n_words,
          a.index_span, a.node_offset, a.m_total, a.n_rows,
          static_cast<T*>(a.keys),
          static_cast<T*>(a.bonus_keys), static_cast<uint32_t*>(a.words),
          static_cast<T*>(a.row_best),
          static_cast<int32_t*>(a.row_list),
          static_cast<int32_t*>(a.row_count));
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (a.n_nodes > 0) {
    const int res4 = (a.n_res + 3) & ~3;
    int tiles = (a.n_rows + kRowsPerTile - 1) / kRowsPerTile;
    tiles = tiles > kGridRowTiles ? kGridRowTiles : tiles;
    const dim3 grid((a.n_nodes + kSlice - 1) / kSlice, tiles);
    const size_t smem =
        (size_t)kSlice * (res4 + kE + (kBonus ? 1 : 0)) * sizeof(int32_t);
    const bool masked = a.mask != nullptr;
    best_nodes_kernel<kMaxR, kQuantized, kBonus, kE>
        <<<grid, kThreads, smem, stream>>>(
        static_cast<const int32_t*>(a.req),
        static_cast<const int32_t*>(a.group_id),
        static_cast<const int32_t*>(a.free_), static_cast<const T*>(a.keys),
        static_cast<const T*>(a.bonus_keys),
        static_cast<const int32_t*>(a.node_dom),
        static_cast<const int32_t*>(a.pref),
        static_cast<const float*>(a.pod_emb),
        static_cast<const float*>(a.node_emb),
        static_cast<const uint32_t*>(a.words),
        masked ? static_cast<const int32_t*>(a.row_list) : nullptr,
        masked ? static_cast<const int32_t*>(a.row_count) : nullptr,
        a.n_rows, a.n_nodes, a.n_groups, a.n_res, n_words,
        static_cast<T*>(a.row_best));
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  finish_kernel<kQuantized><<<(a.n_rows + 255) / 256, 256, 0, stream>>>(
      static_cast<const T*>(a.row_best), a.n_rows, a.n_nodes, a.index_span,
      a.node_offset, a.m_total, static_cast<int32_t*>(a.best),
      static_cast<uint8_t*>(a.feasible),
      static_cast<long long*>(a.keys_out));
  return cudaGetLastError();
}

template <int kMaxR>
cudaError_t dispatch(int has_soft, int quantized, int emb, const Args& a,
                     cudaStream_t s) {
  if (emb > 0) {  // the learned term: exact mode with the soft matrix only
    const bool bonus = a.pref != nullptr;
    if (emb == 16) {
      return bonus ? run<kMaxR, true, false, true, 16>(a, s)
                   : run<kMaxR, true, false, false, 16>(a, s);
    }
    return bonus ? run<kMaxR, true, false, true, 32>(a, s)
                 : run<kMaxR, true, false, false, 32>(a, s);
  }
  if (a.pref != nullptr) {  // the bonus: exact mode only
    return has_soft ? run<kMaxR, true, false, true>(a, s)
                    : run<kMaxR, false, false, true>(a, s);
  }
  if (has_soft) {
    return quantized ? run<kMaxR, true, true, false>(a, s)
                     : run<kMaxR, true, false, false>(a, s);
  }
  return quantized ? run<kMaxR, false, true, false>(a, s)
                   : run<kMaxR, false, false, false>(a, s);
}

}  // namespace

extern "C" {

// Widest request row the kernel keeps in registers.
int yk_best_nodes_max_res() { return 64; }

// Nodes per block slice: the node range splits across blocks at multiples
// of this.
int yk_best_nodes_slice_nodes() { return kSlice; }

// mask: [n_rows] bool of the rows to compute (nullptr = every row).
// node_dom [n_nodes] and pref [n_rows] int32: the planned-domain bonus
// (both or neither; exact mode only), with bonus_keys its key table.
// pod_emb [n_rows, emb] and node_emb [n_nodes, emb] float32 (emb 16 or 32,
// zero-padded; 0 = no learned term, both nullptr): the learned term (exact
// mode with the soft matrix only).
// keys and bonus_keys [G, 32 * ceil(M / 32)]
// and row_best [n_rows] are int64 (exact) or int32 (quantized) scratch,
// words [G, ceil(M / 32)] uint32, row_list [n_rows] and row_count [1] int32.
// node_offset / m_total: the node shard's first global node and the global
// node count (0 and n_nodes for a whole call); keys_out [n_rows] int64 (or
// nullptr): each row's key, top bit flipped. Both exact mode only.
// Returns the first CUDA error of the launches (0 = launched).
int yk_best_nodes(const void* req, const void* group_id, const void* feas,
                  const void* soft, const void* free_, const void* base,
                  const void* mask, const void* node_dom, const void* pref,
                  const void* pod_emb, const void* node_emb, int emb,
                  int n_rows, int n_nodes, int n_groups, int n_res,
                  int has_soft, int quantized, int index_span, void* keys,
                  void* bonus_keys, void* words, void* row_best,
                  void* row_list, void* row_count, void* best,
                  void* feasible, int node_offset, int m_total,
                  void* keys_out, void* stream) {
  if (n_rows <= 0) return 0;
  if (node_offset < 0 || m_total < node_offset + n_nodes ||
      (quantized && (node_offset != 0 || m_total != n_nodes ||
                     keys_out != nullptr)) ||
      (pref == nullptr) != (node_dom == nullptr) ||
      (pref != nullptr && (quantized || bonus_keys == nullptr)) ||
      (emb != 0 && (emb != 16 && emb != 32)) ||
      (emb != 0 && (quantized || !has_soft || pod_emb == nullptr ||
                    node_emb == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{req,        group_id,    feas,       soft,     free_,
               base,       mask,        node_dom,   pref,     pod_emb,
               node_emb,   n_rows,      n_nodes,    n_groups, n_res,
               index_span, node_offset, m_total,    keys,     bonus_keys,
               words,      row_best,    row_list,   row_count, best,
               feasible,   keys_out};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_res <= 8) return (int)dispatch<8>(has_soft, quantized, emb, a, s);
  return (int)dispatch<64>(has_soft, quantized, emb, a, s);
}

const char* yk_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
