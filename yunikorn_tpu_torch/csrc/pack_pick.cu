// The pack arm's rounding pick: for every ask of every part, the node it
// samples by Gumbel-max over its rounding scores among the nodes it fits,
// as an exact 64-bit key.
//
// Replaces the pick half of `_round_part` in the JAX package's
// ops/pack_solve.py (an XLA-fused stage there, not a Pallas kernel): the fit
// margin, the Gumbel draw, the masked argmax and its gather, called once a
// rounding round (ops/pack_solve `_round_part`, for the pack arm's parts and
// for the cvx arm's one part over the fleet or its node pieces). For part k,
// row i and node j of the piece lo .. lo + w of m nodes:
//
//   fit(k, i, j) = feas[k, i, j] AND min_r (cur[k, j, r] - req[k, i, r]) >= 0
//                  (int32, wrapping as the plain version's subtraction)
//   u(k, i, j)   = fl(fl(scores[k, i, j] + tb[k, j]) * inv_tau)
//   g(k, i, j)   = -log(-log(x)), x the float32 uniform in [tiny, 1) that
//                  threefry2x32 gives under round_keys[k] at the counter
//                  i * m + lo + j (high word, low word): utils/prng.gumbel's
//                  draw of shape (n, m) at [i, lo + j]
//   key(k, i)    = the max over fitting j of (the order-preserving bits of
//                  fl(u + g) + 0.0 high, m - 1 - (lo + j) low), top bit
//                  flipped so that a signed max orders it
//                  (ops/best_nodes.exact_key); LLONG_MIN where no node fits
//
// so ties go to the lowest node and -0.0 ties +0.0, as torch.argmax's first
// maximum does. Every float operation is rounded on its own (no contracted
// multiply-add): the plain version rounds each.
//
// What bounds it on an H100: integer operations. Each fitting pair costs one
// threefry2x32 hash (20 rounds of add, rotate and xor, 5 key injections) and
// the uniform's shift and or, about 74 32-bit integer operations, plus R
// subtractions for the fit, against 64 integer results per clock per SM; the
// two logf and the few float32 operations run beside them. The bytes, the
// f32 scores and the bool feasibility once each, take about a third of that
// time.
// What the design does about it: the [K, n, w] noise, margin and masked
// scores are never stored. A block of 8 warps serves one part: it stages a
// tile of the part's nodes (cur transposed to [R][tile], padded against bank
// conflicts, and tb) in shared memory, and each warp takes one row at a
// time, its request row and the round key in registers, its lanes striding
// over the tile's nodes so that the scores and feasibility loads coalesce,
// each lane loading four pairs' inputs before it computes any.
// Only the pairs that fit are hashed (the plain version discards the others'
// noise). A row's key is reduced with warp shuffles and stored once a tile;
// a piece wider than a tile merges each later tile's key into the row's
// stored one (the same lane stores and reloads it, so no atomics and no
// initialising pass). A first, simple design: no tensor cores (there is no
// product to run on them), no TMA.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTile = 1024;               // nodes staged at once
constexpr int kUnroll = 4;                   // pairs a lane loads at once
constexpr int kSmemBudget = 48 * 1024;       // static launch limit, bytes
constexpr float kTiny = 1.17549435e-38f;     // the smallest normal float32
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
// floored at tiny), then -log(-log(x)).
__device__ __forceinline__ float gumbel_of(uint32_t bits) {
  const float f = __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
  const float x = fmaxf(__fadd_rn(f, kTiny), kTiny);
  return -logf(-logf(x));
}

// The nodes a tile stages: the widest multiple of 32 (at most kMaxTile)
// whose transposed cur rows (pitch tile + 1) and tb fit the budget, or the
// whole piece when it is narrower.
int tile_nodes(int w, int n_res) {
  int t = (kSmemBudget / 4 - n_res) / (n_res + 1);
  t = t < kMaxTile ? t : kMaxTile;
  t &= ~31;
  return w < t ? w : t;
}

// grid (row blocks, K); every row of every part is written.
template <int kMaxR>
__global__ void __launch_bounds__(kThreads)
pick_kernel(const uint8_t* __restrict__ feas, const float* __restrict__ scores,
            const int32_t* __restrict__ cur, const int32_t* __restrict__ req,
            const float* __restrict__ tb, const int64_t* __restrict__ keys,
            int n, int w, int n_res, int lo, int m, int tile, float inv_tau,
            long long* __restrict__ out) {
  // [n_res][tile + 1] transposed cur, then [tile] tb
  extern __shared__ int32_t s_cur[];
  const int pitch = tile + 1;
  float* s_tb = reinterpret_cast<float*>(s_cur + n_res * pitch);
  const int k = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const uint32_t k0 = (uint32_t)keys[2 * k];
  const uint32_t k1 = (uint32_t)keys[2 * k + 1];
  const int32_t* cur_k = cur + (size_t)k * w * n_res;
  int t0 = 0;
  do {  // at least once, so a piece of no nodes writes every row's none
    const int tn = min(tile, w - t0);
    __syncthreads();  // the last tile's rows are done with the tile
    for (int idx = threadIdx.x; idx < tn * n_res; idx += kThreads) {
      const int j = idx / n_res;
      const int r = idx - j * n_res;
      s_cur[r * pitch + j] = cur_k[(size_t)(t0 + j) * n_res + r];
    }
    for (int j = threadIdx.x; j < tn; j += kThreads) {
      s_tb[j] = tb[(size_t)k * w + t0 + j];
    }
    __syncthreads();
    for (int i = blockIdx.x * kWarps + warp; i < n; i += gridDim.x * kWarps) {
      const size_t row = (size_t)k * n + i;
      int32_t rq[kMaxR];
#pragma unroll
      for (int r = 0; r < kMaxR; ++r) {
        rq[r] = r < n_res ? req[row * n_res + r] : 0;
      }
      const float* srow = scores + row * w + t0;
      const uint8_t* frow = feas + row * w + t0;
      const unsigned long long base =
          (unsigned long long)i * (unsigned)m + (unsigned)(lo + t0);
      const uint32_t low0 = (uint32_t)(m - 1 - lo - t0);
      unsigned long long best = 0ull;  // below every key of a real score
      for (int j0 = lane; j0 < tn; j0 += 32 * kUnroll) {
        // every load of the group before any use: one memory latency a
        // group of kUnroll pairs, not two a pair
        bool fit[kUnroll];
        float sc[kUnroll];
#pragma unroll
        for (int q = 0; q < kUnroll; ++q) {
          const int j = j0 + 32 * q;
          fit[q] = j < tn && frow[j];
          sc[q] = j < tn ? srow[j] : 0.0f;
        }
#pragma unroll
        for (int q = 0; q < kUnroll; ++q) {
          if (!fit[q]) continue;
          const int j = j0 + 32 * q;
          uint32_t neg = 0u;  // the sign bits of cur - req, or-ed
#pragma unroll
          for (int r = 0; r < kMaxR; ++r) {
            if (r < n_res) {
              neg |= (uint32_t)s_cur[r * pitch + j] - (uint32_t)rq[r];
            }
          }
          if (neg & 0x80000000u) continue;
          const float u = __fmul_rn(__fadd_rn(sc[q], s_tb[j]), inv_tau);
          const unsigned long long c = base + (unsigned)j;
          uint32_t x0 = (uint32_t)(c >> 32), x1 = (uint32_t)c;
          threefry2x32(k0, k1, x0, x1);
          const float v = __fadd_rn(u, gumbel_of(x0 ^ x1));
          const unsigned long long key =
              ((unsigned long long)ordered_bits(v) << 32) |
              (low0 - (uint32_t)j);
          best = key > best ? key : best;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const unsigned long long o = __shfl_xor_sync(0xffffffffu, best, off);
        best = o > best ? o : best;
      }
      if (lane == 0) {
        long long s = (long long)(best ^ (1ull << 63));
        if (t0 > 0) {
          const long long prev = out[row];
          s = prev > s ? prev : s;
        }
        out[row] = s;
      }
    }
    t0 += tile;
  } while (t0 < w);
}

template <int kMaxR>
cudaError_t run(const void* feas, const void* scores, const void* cur,
                const void* req, const void* tb, const void* keys, int K,
                int n, int w, int n_res, int lo, int m, float inv_tau,
                void* out, cudaStream_t stream) {
  const int tile = tile_nodes(w, n_res);
  const size_t smem = ((size_t)n_res * (tile + 1) + tile) * sizeof(int32_t);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess) {
    return err;
  }
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, pick_kernel<kMaxR>, kThreads, smem)) != cudaSuccess) {
    return err;
  }
  // one wave of resident blocks over the K parts; each block's warps stride
  // over its part's rows
  const int rows_blocks = (n + kWarps - 1) / kWarps;
  int bx = (per_sm * sms + K - 1) / K;
  bx = bx < rows_blocks ? bx : rows_blocks;
  bx = bx > 0 ? bx : 1;
  pick_kernel<kMaxR><<<dim3(bx, K), kThreads, smem, stream>>>(
      static_cast<const uint8_t*>(feas), static_cast<const float*>(scores),
      static_cast<const int32_t*>(cur), static_cast<const int32_t*>(req),
      static_cast<const float*>(tb), static_cast<const int64_t*>(keys), n, w,
      n_res, lo, m, tile, inv_tau, static_cast<long long*>(out));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Widest request row the kernel keeps in registers.
int yk_pack_pick_max_res() { return 64; }

// The pick of K parts of n rows over the piece lo .. lo + w of m nodes:
// feas [K, n, w] bool, scores [K, n, w] float32, cur [K, w, R] int32, req
// [K, n, R] int32, tb [K, w] float32, keys [K, 2] int64 (two 32-bit words
// each); out [K, n] int64, every row written. Returns the launch's CUDA
// error (0 = launched).
int yk_pack_pick(const void* feas, const void* scores, const void* cur,
                 const void* req, const void* tb, const void* keys, int K,
                 int n, int w, int n_res, int lo, int m, float inv_tau,
                 void* out, void* stream) {
  if (K <= 0 || n <= 0) return 0;
  if (K > 65535 || w < 0 || n_res < 1 || n_res > 64 || lo < 0 ||
      (long long)lo + w > (long long)m) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_res <= 8) {
    return (int)run<8>(feas, scores, cur, req, tb, keys, K, n, w, n_res, lo,
                       m, inv_tau, out, s);
  }
  if (n_res <= 16) {
    return (int)run<16>(feas, scores, cur, req, tb, keys, K, n, w, n_res, lo,
                        m, inv_tau, out, s);
  }
  return (int)run<64>(feas, scores, cur, req, tb, keys, K, n, w, n_res, lo, m,
                      inv_tau, out, s);
}

const char* yk_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
