// Strip scores of SharePrefill's pattern estimation (paper Algorithm 3).
//
// Replaces the TPU kernel repro/kernels/strip.py::strip_scores_pallas
// (_strip_ml_kernel + _strip_norm_kernel): for every (batch, query head) it
// computes softmax(Q_hat K^T / sqrt(D)) of the last `bs` queries against all
// N keys, causally masked (strip row r is global query N - bs + r, so only
// the last bs keys are ever masked), as a (B, H, bs, N) float32 strip.
//
// Bound on an H100: the bytes of the strip it writes, B * H * bs * N * 4
// (268 MB, 80 us at 3.35 TB/s, for llama3-8b at N = 8192, B = 2).  The
// products over the causally valid pairs are 17 GFLOP, ~17 us at the bf16
// tensor-core rate, twice that with the second pass's recompute.  The design
// writes the strip once and overlaps the second pass's products with that
// write (on an H100, ~122 us for pass 2 against ~90 us for the write alone
// and ~72 us for pass 1, which writes nothing; PERF.md):
//   * Key split.  The keys are cut into C chunks of `chunk` keys (a multiple
//     of the 64-key sub-tile; the wrapper's kernels/strip.py::strip_chunk
//     picks it from N alone).  The grid is (row tiles, C): a row tile is 128
//     strip rows of one (batch, kv head), the G query heads' bs rows each
//     (bs % 16 == 0, so a 16-row fragment never spans two heads), so K is
//     read once per GQA group, never repeated.  The partition depends only
//     on N and compile-time tile sizes, never on B or the SM count, so a
//     sample's strip is bitwise the same alone or in a batch; and at B = 1
//     the grid still holds hundreds of CTAs.
//   * Pass 1 (PASS = 1) computes each row's partial (m, l) over its chunk
//     in base 2 (m the largest logit times scale * log2 e, l the sum of
//     exp2 against it) into scratch (2, B, H, bs, C); a chunk with no
//     visible key for a row writes (-inf, 0), as the last chunk does for
//     the first rows when chunk < bs.
//   * Pass 2 (PASS = 2) first merges each of its rows' C partials in chunk
//     order (a partial weighs exp2(m_c - M) against the largest M, 0 at
//     -inf; the sum clamped at 1e-30 as the reference does), then
//     recomputes its chunk's logits and writes exp2(s * scale * log2 e - M)
//     / L, exact zeros where the causal mask hides the key.  Writing
//     exp(s - m_chunk) in one pass and rescaling it would read and write
//     the strip again (~160 us); recomputing Q K^T costs less.
//   * A ragged last chunk is masked and never read past N (the source row
//     of a key >= N is clamped to N - 1; its logits are masked).
//
// bfloat16 body (strip_tc_kernel, D in {64, 96, 128, 192, 256}), the
// serving path: 4 warps of 32 rows each, as two 16-row mma.sync m16n8k16 A
// fragments (bf16 in, float32 accumulate: a bf16 x bf16 product is exact in
// float32, so only the summation order differs from the reference) loaded
// once per CTA by ldmatrix (up to D = 192); every K fragment serves both.
// K streams through a three-stage ring of 64-key bf16 sub-tiles by 16-byte
// cp.async, rows padded by 16 bytes so ldmatrix is conflict-free.  Only a
// sub-tile reaching past key N - bs runs the causal mask.  Pass 2 stages
// each warp's 32 x 64 probabilities in shared memory (where Q was, up to
// D = 192) and writes them as 16-byte streaming stores, two whole 256-byte
// rows per warp instruction: on an H100 pass 2 took ~15 % less time than
// with 8-byte stores straight from the accumulator fragments
// (scripts/torch_strip_variants.py).
// On an H100 at D = 256, G = 16 (B = 2, N = 8192) pass 1 runs its 17 GFLOP
// at ~223 TFLOP/s, the rate mma.sync bodies reach on this card (PERF.md).
// D = 192 (DeepSeek-V2's MLA: qk_nope 128 + qk_rope 64) takes this body
// too: its 2 x 12 Q fragments a warp fit in 242 (pass 1) and 255 (pass 2)
// registers with no spill (ptxas, sm_90a), and its Q tile and K ring take
// 128000 bytes of shared memory, one CTA an SM.
// D = 256 (RecurrentGemma, G = 16): 2 x 16 Q fragments (128 registers) and
// the 64 float32 S accumulators do not fit in 255 registers, so the Q tile
// stays resident in shared memory and each k-step reloads the warp's two A
// fragments by ldmatrix (as csrc/block_sparse_attn.cu does at D = 256); pass
// 2's staging then gets a region of its own after Q.  Q 67584 + staging
// 36864 + K ring 101376 = 205824 bytes, one CTA an SM.
// CUDA-core body (strip_f32_kernel): float32 inputs (TF32 would miss the
// 1e-5 tolerance) and bf16 at any other head dim, the same chunks, scratch
// and merge; 64 rows per CTA, each thread a 4-row x 4-key tile with its
// query values in registers per d.
#include "common.cuh"

namespace {

constexpr int KN = 64;           // keys per sub-tile (a chunk is whole ones)
constexpr int TC_ROWS = 128;     // strip rows per CTA, tensor-core body
constexpr int TC_THREADS = 128;  // 4 warps x 32 rows
constexpr int NSTAGE = 3;        // K ring stages
constexpr int F_ROWS = 64;       // strip rows per CTA, CUDA-core body
constexpr int F_THREADS = 256;   // 16 row groups x 16 key lanes
constexpr int SP = KN + 8;       // padded row of a warp's staged output

// Whether the tensor-core body keeps Q's A fragments in registers (D up to
// 192) or reloads them from the resident Q tile at each k-step (D = 256).
__host__ __device__ constexpr bool tc_qreg(int D) { return D <= 192; }

// Bytes before the K ring in the tensor-core body's shared memory: Q, then
// pass 2's output staging, in the same place where Q's fragments live in
// registers, after Q where they are reloaded.
__host__ __device__ constexpr int tc_head_bytes(int D) {
  return tc_qreg(D) ? (TC_ROWS * (D + 8) * 2 > TC_ROWS * SP * 4
                           ? TC_ROWS * (D + 8) * 2
                           : TC_ROWS * SP * 4)
                    : TC_ROWS * (D + 8) * 2 + TC_ROWS * SP * 4;
}

struct Dims {
  int B, H, Hkv, Nq, N, D, bs, chunk, C;
};

// The grid's CTA: batch, kv head, row tile and chunk; rows of the tile are
// the kv head's strip rows rho in [tile * rows_per_cta, ...) < G * bs, row
// rho being row rho % bs of query head hk * G + rho / bs.
struct Cta {
  int b, hk, rho0, c, G, rows;
  __device__ Cta(const Dims& a, int rows_per_cta) {
    G = a.H / a.Hkv;
    rows = G * a.bs;
    const int tiles = (rows + rows_per_cta - 1) / rows_per_cta;
    int x = blockIdx.x;
    rho0 = (x % tiles) * rows_per_cta;
    x /= tiles;
    hk = x % a.Hkv;
    b = x / a.Hkv;
    c = blockIdx.y;
  }
  // the row's index in (B, H, bs): (b * H + h) * bs + r
  __device__ size_t grow(const Dims& a, int rho) const {
    return ((size_t)b * a.H + (size_t)hk * G) * a.bs + rho;
  }
  // element offset of the row's query vector in q (B, H, Nq, D)
  __device__ size_t qrow(const Dims& a, int rho) const {
    const int h = hk * G + rho / a.bs, r = rho % a.bs;
    return (((size_t)b * a.H + h) * a.Nq + (a.Nq - a.bs) + r) * a.D;
  }
};

// The row's merged max M (base 2; 0 when every partial is -inf) and
// 1 / max(L, 1e-30) from its C chunk partials, in chunk order.
__device__ __forceinline__ void merge_row(const float* __restrict__ ml,
                                          const Dims& a, size_t grow,
                                          float& M, float& inv) {
  const float* m = ml + grow * a.C;
  const float* l = ml + ((size_t)a.B * a.H * a.bs + grow) * a.C;
  float mx = -CUDART_INF_F;
  for (int c = 0; c < a.C; ++c) mx = fmaxf(mx, m[c]);
  float L = 0.f;
  for (int c = 0; c < a.C; ++c)
    if (m[c] != -CUDART_INF_F) L += l[c] * exp2f(m[c] - mx);
  M = mx == -CUDART_INF_F ? 0.f : mx;
  inv = 1.f / fmaxf(L, 1e-30f);
}

// Online (m, l) of one row over the values of one sub-tile that a thread
// holds: `smax` their largest raw logit (-inf if none is visible) and `s`
// the raw logits, -inf where masked.
template <int NV>
__device__ __forceinline__ void online(float& m, float& l, float smax,
                                       const float (&s)[NV], float sl2) {
  const float m_new = fmaxf(m, smax * sl2);
  if (m_new == -CUDART_INF_F) return;        // nothing visible yet
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) sum += exp2f(fmaf(s[i], sl2, -m_new));
  l = (m == -CUDART_INF_F ? 0.f : l * exp2f(m - m_new)) + sum;
  m = m_new;
}

// Merge the (m, l) of two threads holding parts of the same row.
__device__ __forceinline__ void merge_pair(float& m, float& l, float mo,
                                           float lo) {
  const float M = fmaxf(m, mo);
  if (M == -CUDART_INF_F) return;
  l = (m == -CUDART_INF_F ? 0.f : l * exp2f(m - M)) +
      (mo == -CUDART_INF_F ? 0.f : lo * exp2f(mo - M));
  m = M;
}

// Pass 1's work on one sub-tile's logits s (a warp's 32 rows as fragments
// f, halves rr; this thread's keys kc + 8 nt + e): the rows' online (m, l).
// MASK: some key of the sub-tile lies past a row's last visible key lim.
template <bool MASK, int NN>
__device__ __forceinline__ void tile_stats(const float (&s)[2][NN][4],
                                           float (&m)[2][2], float (&l)[2][2],
                                           const int (&lim)[2][2], int kc,
                                           float sl2) {
#pragma unroll
  for (int f = 0; f < 2; ++f)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float v[2 * NN];
      float smax = -CUDART_INF_F;
#pragma unroll
      for (int nt = 0; nt < NN; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x = s[f][nt][2 * rr + e];
          if (MASK && kc + nt * 8 + e > lim[f][rr]) x = -CUDART_INF_F;
          v[2 * nt + e] = x;
          smax = fmaxf(smax, x);
        }
      online(m[f][rr], l[f][rr], smax, v, sl2);
    }
}

// Pass 2's work on one sub-tile: the normalised probabilities of the
// warp's 32 rows into its staging rows st (32 x SP floats).
template <bool MASK, int NN>
__device__ __forceinline__ void tile_probs(const float (&s)[2][NN][4],
                                           const float (&M)[2][2],
                                           const float (&inv)[2][2],
                                           const int (&lim)[2][2], int kc,
                                           float sl2, float* st, int gq,
                                           int tq) {
#pragma unroll
  for (int f = 0; f < 2; ++f)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
#pragma unroll
      for (int nt = 0; nt < NN; ++nt) {
        float p[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          p[e] = exp2f(fmaf(s[f][nt][2 * rr + e], sl2, -M[f][rr])) *
                 inv[f][rr];
          if (MASK && kc + nt * 8 + e > lim[f][rr]) p[e] = 0.f;
        }
        *reinterpret_cast<float2*>(st + (16 * f + gq + 8 * rr) * SP +
                                   nt * 8 + 2 * tq) = make_float2(p[0], p[1]);
      }
}

// The bfloat16 tensor-core body (header comment).
template <int D, int PASS>
__global__ void __launch_bounds__(TC_THREADS, 2)
strip_tc_kernel(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                float* __restrict__ out, float* __restrict__ ml, Dims a,
                float sl2) {
  using bf16 = __nv_bfloat16;
  constexpr int DP = D + 8;        // padded smem row (bf16)
  constexpr int DK = D / 16;       // k-steps of Q K^T
  constexpr int NN = KN / 8;       // n-tiles of S
  constexpr int CPR = D / 8;       // 16-byte chunks per row
  constexpr bool QREG = tc_qreg(D);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // Q (TC_ROWS x DP bf16) and pass 2's output staging (TC_ROWS x SP floats,
  // 32 rows a warp), the staging where Q was once QREG fragments are
  // loaded, else after Q; then the K ring
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw + tc_head_bytes(D));
  __shared__ float row_m[TC_ROWS], row_inv[TC_ROWS];

  const Cta cta(a, TC_ROWS);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;   // fragment row / column group
  const int N = a.N;
  const int key0 = cta.c * a.chunk;
  const int nsub = (min(a.chunk, N - key0) + KN - 1) / KN;
  const bf16* kb = k + ((size_t)cta.b * a.Hkv + cta.hk) * (size_t)N * D;

  // Q rows of the tile (rows past G * bs read a valid row and write
  // nothing) and the first NSTAGE - 1 K sub-tiles
  for (int i = tid; i < TC_ROWS * CPR; i += TC_THREADS) {
    const int rr = i / CPR, cc = (i % CPR) * 8;
    const int rho = min(cta.rho0 + rr, cta.rows - 1);
    repro::cp_async16(q_s + rr * DP + cc, q + cta.qrow(a, rho) + cc);
  }
  auto prefetch = [&](int i) {
    bf16* ks = k_s + (i % NSTAGE) * KN * DP;
    const int k0 = key0 + i * KN;
    for (int j = tid; j < KN * CPR; j += TC_THREADS) {
      const int rr = j / CPR, cc = (j % CPR) * 8;
      const int key = min(k0 + rr, N - 1);
      repro::cp_async16(ks + rr * DP + cc, kb + (size_t)key * D + cc);
    }
  };
  for (int i = 0; i < NSTAGE - 1; ++i) {   // Q lands with sub-tile 0
    if (i < nsub) prefetch(i);
    repro::cp_async_commit();
  }
  if constexpr (PASS == 2) {
    for (int i = tid; i < TC_ROWS; i += TC_THREADS) {
      const int rho = cta.rho0 + i;
      if (rho < cta.rows) merge_row(ml, a, cta.grow(a, rho), row_m[i],
                                    row_inv[i]);
    }
  }

  // this thread's rows: fragment f, half rr -> tile row 32 warp + 16 f +
  // gq + 8 rr; a fragment lies in one head and is valid or not as a whole
  int lim[2][2];          // last visible key of the row
  bool fv[2];
  float m[2][2], l[2][2], M[2][2], inv[2][2];
#pragma unroll
  for (int f = 0; f < 2; ++f) {
    const int rho = cta.rho0 + 32 * warp + 16 * f;
    fv[f] = rho < cta.rows;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      lim[f][rr] = N - a.bs + (rho + gq + 8 * rr) % a.bs;
      m[f][rr] = -CUDART_INF_F;
      l[f][rr] = 0.f;
    }
  }
  uint32_t qf[2][QREG ? DK : 1][4];
  // the A fragment of fragment f's rows at QK^T's k-step kk, from the Q tile
  auto load_q = [&](uint32_t (&r)[4], int f, int kk) {
    repro::ldmatrix_x4(r, q_s + (32 * warp + 16 * f + (lane & 7) +
                                 ((lane >> 3) & 1) * 8) * DP +
                              kk * 16 + (lane >> 4) * 8);
  };
  float* st = reinterpret_cast<float*>(
                  smem_raw + (QREG ? 0 : TC_ROWS * DP * 2)) +
              warp * 32 * SP;

  for (int i = 0; i < nsub; ++i) {
    repro::cp_async_wait<NSTAGE - 2>();
    __syncthreads();            // sub-tile i landed; sub-tile i - 1 consumed
    if (i == 0) {
      if constexpr (QREG) {
#pragma unroll
        for (int f = 0; f < 2; ++f)
#pragma unroll
          for (int kk = 0; kk < DK; ++kk) load_q(qf[f][kk], f, kk);
      }
      if constexpr (PASS == 2) {
#pragma unroll
        for (int f = 0; f < 2; ++f)
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            M[f][rr] = row_m[32 * warp + 16 * f + gq + 8 * rr];
            inv[f][rr] = row_inv[32 * warp + 16 * f + gq + 8 * rr];
          }
        if constexpr (QREG)
          __syncthreads();      // every warp's Q read: q_s becomes st
      }
    }
    if (i + NSTAGE - 1 < nsub) prefetch(i + NSTAGE - 1);
    repro::cp_async_commit();
    const bf16* ks = k_s + (i % NSTAGE) * KN * DP;

    // S = Q K^T: 32 rows x 64 keys per warp, each K fragment used twice
    float s[2][NN][4];
#pragma unroll
    for (int f = 0; f < 2; ++f)
#pragma unroll
      for (int nt = 0; nt < NN; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[f][nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DK; ++kk) {
      uint32_t qa[2][4];
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        if constexpr (QREG) {
#pragma unroll
          for (int e = 0; e < 4; ++e) qa[f][e] = qf[f][QREG ? kk : 0][e];
        } else {
          load_q(qa[f], f, kk);
        }
      }
#pragma unroll
      for (int np = 0; np < NN / 2; ++np) {
        uint32_t kf[4];
        repro::ldmatrix_x4(kf, ks + (np * 16 + (lane & 7) + (lane >> 4) * 8)
                                        * DP +
                                   kk * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int f = 0; f < 2; ++f) {
          repro::mma_bf16(s[f][2 * np], qa[f], kf[0], kf[1]);
          repro::mma_bf16(s[f][2 * np + 1], qa[f], kf[2], kf[3]);
        }
      }
    }

    // only a sub-tile reaching past key N - bs can hide keys from a row
    const int k0 = key0 + i * KN;
    const bool mask = k0 + KN - 1 > N - a.bs;
    if constexpr (PASS == 1) {
      if (mask) tile_stats<true>(s, m, l, lim, k0 + 2 * tq, sl2);
      else tile_stats<false>(s, m, l, lim, k0 + 2 * tq, sl2);
    } else {
      if (mask) tile_probs<true>(s, M, inv, lim, k0 + 2 * tq, sl2, st, gq,
                                 tq);
      else tile_probs<false>(s, M, inv, lim, k0 + 2 * tq, sl2, st, gq, tq);
      __syncwarp();
      // two rows of 64 keys per instruction, 16 bytes a lane, whole
      // 128-byte lines; a ragged sub-tile's columns past N are not written
      const int col = (lane & 15) * 4;
#pragma unroll
      for (int it = 0; it < 16; ++it) {
        const int row = 2 * it + (lane >> 4);
        const float4 val =
            *reinterpret_cast<const float4*>(st + row * SP + col);
        if (fv[row >> 4] && k0 + col < N)
          __stcs(reinterpret_cast<float4*>(
                     out + cta.grow(a, cta.rho0 + 32 * warp + row) *
                               (size_t)N + k0 + col),
                 val);
      }
      __syncwarp();             // st is rewritten by the next sub-tile
    }
  }

  if constexpr (PASS == 1) {
    // merge the quad's partials of each row; lane tq == 0 writes them
#pragma unroll
    for (int f = 0; f < 2; ++f)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
#pragma unroll
        for (int o = 1; o <= 2; o <<= 1)
          merge_pair(m[f][rr], l[f][rr],
                     __shfl_xor_sync(0xffffffffu, m[f][rr], o),
                     __shfl_xor_sync(0xffffffffu, l[f][rr], o));
        if (fv[f] && tq == 0) {
          const size_t g =
              cta.grow(a, cta.rho0 + 32 * warp + 16 * f + gq + 8 * rr);
          ml[g * a.C + cta.c] = m[f][rr];
          ml[((size_t)a.B * a.H * a.bs + g) * a.C + cta.c] = l[f][rr];
        }
      }
  }
  repro::cp_async_wait<0>();
}

// The CUDA-core body (header comment): thread (ty, tx) owns tile rows
// 4 ty .. 4 ty + 3 and keys tx + 16 j of each 64-key sub-tile.
template <typename T, int PASS>
__global__ void __launch_bounds__(F_THREADS)
strip_f32_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 float* __restrict__ out, float* __restrict__ ml, Dims a,
                 float sl2) {
  extern __shared__ float fsm[];
  const int D = a.D, QS = D + 1;     // odd stride: conflict-free columns
  float* q_s = fsm;                  // F_ROWS x QS
  float* k_s = q_s + F_ROWS * QS;    // KN x QS
  __shared__ float row_m[F_ROWS], row_inv[F_ROWS];

  const Cta cta(a, F_ROWS);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int N = a.N;
  const int key0 = cta.c * a.chunk;
  const int nsub = (min(a.chunk, N - key0) + KN - 1) / KN;
  const T* kb = k + ((size_t)cta.b * a.Hkv + cta.hk) * (size_t)N * D;

  for (int i = tid; i < F_ROWS * D; i += F_THREADS) {
    const int rr = i / D, c = i - rr * D;
    const int rho = min(cta.rho0 + rr, cta.rows - 1);
    q_s[rr * QS + c] = repro::to_f(q[cta.qrow(a, rho) + c]);
  }
  if constexpr (PASS == 2) {
    for (int i = tid; i < F_ROWS; i += F_THREADS) {
      const int rho = cta.rho0 + i;
      if (rho < cta.rows) merge_row(ml, a, cta.grow(a, rho), row_m[i],
                                    row_inv[i]);
    }
  }
  int lim[4];
  bool rv[4];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int rho = cta.rho0 + 4 * ty + i;
    rv[i] = rho < cta.rows;
    lim[i] = N - a.bs + rho % a.bs;
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
  }

  for (int it = 0; it < nsub; ++it) {
    const int k0 = key0 + it * KN;
    __syncthreads();                 // previous sub-tile consumed
    for (int i = tid; i < KN * D; i += F_THREADS) {
      const int rr = i / D, c = i - rr * D;
      k_s[rr * QS + c] = repro::to_f(kb[(size_t)min(k0 + rr, N - 1) * D + c]);
    }
    __syncthreads();
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = q_s[(4 * ty + i) * QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = k_s[(tx + 16 * j) * QS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
    const bool full = k0 + KN - 1 <= N - a.bs;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (PASS == 1) {
        float smax = -CUDART_INF_F;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (!(full || k0 + tx + 16 * j <= lim[i])) s[i][j] = -CUDART_INF_F;
          smax = fmaxf(smax, s[i][j]);
        }
        online(m[i], l[i], smax, s[i], sl2);
      } else {
        const int rr = 4 * ty + i;
        float* o = out + cta.grow(a, cta.rho0 + rr) * (size_t)N;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int key = k0 + tx + 16 * j;
          if (rv[i] && key < N)
            o[key] = (full || key <= lim[i])
                         ? exp2f(fmaf(s[i][j], sl2, -row_m[rr])) *
                               row_inv[rr]
                         : 0.f;
        }
      }
    }
  }
  if constexpr (PASS == 1) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int o = 1; o <= 8; o <<= 1)
        merge_pair(m[i], l[i], __shfl_xor_sync(0xffffffffu, m[i], o),
                   __shfl_xor_sync(0xffffffffu, l[i], o));
      if (rv[i] && tx == 0) {
        const size_t g = cta.grow(a, cta.rho0 + 4 * ty + i);
        ml[g * a.C + cta.c] = m[i];
        ml[((size_t)a.B * a.H * a.bs + g) * a.C + cta.c] = l[i];
      }
    }
  }
}

template <int D>
int launch_tc(const void* q, const void* k, float* out, float* ml,
              const Dims& a, float sl2, cudaStream_t st) {
  const size_t smem = tc_head_bytes(D) + NSTAGE * KN * (D + 8) * 2;
  const int tiles = (a.H / a.Hkv * a.bs + TC_ROWS - 1) / TC_ROWS;
  const dim3 grid(a.B * a.Hkv * tiles, a.C);
  cudaError_t e = cudaFuncSetAttribute(
      strip_tc_kernel<D, 1>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(strip_tc_kernel<D, 2>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (e != cudaSuccess) return (int)e;
  const auto* qb = (const __nv_bfloat16*)q;
  const auto* kb = (const __nv_bfloat16*)k;
  strip_tc_kernel<D, 1><<<grid, TC_THREADS, smem, st>>>(qb, kb, out, ml, a,
                                                        sl2);
  strip_tc_kernel<D, 2><<<grid, TC_THREADS, smem, st>>>(qb, kb, out, ml, a,
                                                        sl2);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_f32(const void* q, const void* k, float* out, float* ml,
               const Dims& a, float sl2, cudaStream_t st) {
  const size_t smem = (size_t)(F_ROWS + KN) * (a.D + 1) * sizeof(float);
  const int tiles = (a.H / a.Hkv * a.bs + F_ROWS - 1) / F_ROWS;
  const dim3 grid(a.B * a.Hkv * tiles, a.C);
  cudaError_t e = cudaFuncSetAttribute(
      strip_f32_kernel<T, 1>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(strip_f32_kernel<T, 2>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (e != cudaSuccess) return (int)e;
  strip_f32_kernel<T, 1><<<grid, F_THREADS, smem, st>>>(
      (const T*)q, (const T*)k, out, ml, a, sl2);
  strip_f32_kernel<T, 2><<<grid, F_THREADS, smem, st>>>(
      (const T*)q, (const T*)k, out, ml, a, sl2);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, H, Nq, D), k (B, Hkv, N, D) -> out (B, H, bs, N) float32; ml is
// float32 scratch (2, B, H, bs, ceil(N / chunk)) for the chunk partials.
extern "C" int repro_strip(const void* q, const void* k, void* out,
                           float* ml, int dtype, int B, int H, int Hkv,
                           int Nq, int N, int D, int bs, int chunk,
                           void* stream) {
  if (bs <= 0 || bs % 16 || Hkv <= 0 || H % Hkv || chunk <= 0 ||
      chunk % KN || N % bs || Nq < bs)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0 || N == 0) return 0;
  const Dims a{B, H, Hkv, Nq, N, D, bs, chunk, (N + chunk - 1) / chunk};
  const float sl2 = 1.4426950408889634f / sqrtf((float)D);
  const auto st = (cudaStream_t)stream;
  float* o = (float*)out;
  if (dtype == REPRO_BF16) {
    if (D == 256) return launch_tc<256>(q, k, o, ml, a, sl2, st);
    if (D == 192) return launch_tc<192>(q, k, o, ml, a, sl2, st);
    if (D == 128) return launch_tc<128>(q, k, o, ml, a, sl2, st);
    if (D == 96) return launch_tc<96>(q, k, o, ml, a, sl2, st);
    if (D == 64) return launch_tc<64>(q, k, o, ml, a, sl2, st);
    return launch_f32<__nv_bfloat16>(q, k, o, ml, a, sl2, st);
  }
  return launch_f32<float>(q, k, o, ml, a, sl2, st);
}
