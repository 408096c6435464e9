// Block-sparse prefill attention with fused block-mean QK stats: one kernel
// body per dtype, three instances each, and a Hopper body for the BATCHED
// bf16 instance at bs = 128, D = 128.
//
// Replaces the TPU kernels of repro/kernels/block_sparse_attn.py:
//   BATCHED  block_sparse_attention_batched (_kernel_batched)
//   PAGED    block_sparse_attention_batched_paged (_kernel_batched_paged)
//   SINGLE   block_sparse_attention_kernel (_kernel)
// For every (batch b, query head h, query block row) it runs FlashAttention-2
// online softmax over the kv blocks listed in indices[b, h, row, :n] only,
// reading K/V of kv head h / G (GQA, never expanded), with the causal mask
// anchored at q_block_offset:  (q_block_offset + row) * bs + i >= j * bs + t.
// It also emits, for every visited block j, the mean of the scaled logits
// over the causally valid entries (-inf when the block has none).  Rows with
// nothing visited write zeros.  Q and K have width Dqk (the template's
// DQK) and V and the output width Dv (DV); they are equal except at
// DeepSeek-V2's MLA prefill, Dqk = 192 and Dv = 128 (BATCHED and SINGLE),
// whose instances stand beside the equal-width ones (by_dim).  The scale is
// 1 / sqrt(Dqk), from Q's width.
//
// BATCHED and PAGED take the reference's ragged schedule: a row visits
// n = min(counts, min(causal bound, W)) blocks, stats only for heads with
// stats_gate[b, h] != 0, written straight into a_tilde[b, h, row, j] (the
// wrapper fills it with -inf; valid indices within a row are distinct).  The
// TPU kernel emitted its stats in schedule order because its grid runs in
// order; here CTAs run in no order and write Ã in place.
// PAGED reads K/V from a pool (P, Hkv, bs, D) through page_table (B, NBkv):
// the tile of block j starts at pool + ((page_table[b * NBkv + j] * Hkv + hk)
// * bs) * D, in size_t (a whole pool comes near 2^31 elements).  That address
// is the only difference: tables, causal bounds and Ã stay logical, so it is
// bitwise the BATCHED instance of its body run on the gathered pages (in
// bf16 at bs = 128, D = 128 the BATCHED launch takes the Hopper body, which
// rounds otherwise).  A page id outside [0, P) is never read: its block is
// skipped.
// SINGLE is the reference's single-sample oracle kernel: B = 1, offset 0,
// a uniform n = min(counts, W) steps per row with no causal bound, no stats
// gate, and compact stats: step w of the row writes stats[h, row, w] (the
// wrapper fills -inf, which stays for w >= n).  A listed block above the
// diagonal is visited, contributes nothing to the output and gets -inf.
// The per-row arithmetic does not depend on the instance.
//
// Bound on an H100: the products, 2 * bs^2 * (Dqk + Dv) flops per visited
// block (4 * bs^2 * D at equal widths).  One
// llama3-8b layer at N = 8192, B = 2 and ~0.93 block density visits ~124k
// blocks of 8.4 MFLOP each, ~1 TFLOP, ~0.9 ms at the bf16 tensor-core rate,
// far above its bytes (q, out, K and V once: ~0.34 GB, 0.1 ms).
//
// bfloat16 body (bsa_tc_kernel), the serving path: FlashAttention-2 on the
// tensor cores.
//   * QK^T and PV run as mma.sync.m16n8k16 bf16 products with float32
//     accumulators; no product runs on CUDA cores.  One CTA per (row, h, b)
//     of 2 * bs threads: warp w owns query rows [16w, 16w + 16), and the Q
//     tile stays in registers as A fragments for the whole row (up to
//     Dqk = 192; at 256 they are reloaded from shared memory at each
//     k-step, by_dim).
//   * K/V stream through a two-stage shared-memory ring of 64-key bf16
//     sub-tiles, filled by 16-byte cp.async while the previous sub-tile is
//     computed; rows are padded by 16 bytes so ldmatrix is conflict-free
//     (~102 KB at bs = D = 128).
//   * Online softmax in registers on the accumulator fragments, in base 2
//     (exp2 of the logits times scale * log2 e), with the guards of the TPU
//     kernel: alpha = 0 while the running max is -inf, p = 0 off the causal
//     mask, denominator max(l, 1e-30).  P is rounded to bf16 only as the A
//     operand of PV; l sums the float32 values.
//   * Ã fused: each thread sums the raw logits of its causally valid
//     entries and counts them; at the block's end a warp shuffle and one
//     shared-memory slot per warp reduce them, and thread 0 writes the
//     mean after the next pipeline barrier (no extra barrier per block).
//   * Grid order: a 1-D grid whose fastest index is the G query heads of
//     one kv head (their K/V tiles meet in the 50 MB L2), then kv head and
//     batch, with the query block rows reversed so that the causal rows
//     with the most blocks start first.
// It runs PAGED and SINGLE, bs = 64, and the widths other than 128; the
// BATCHED instance at bs = 128, Dqk = Dv = 128 in bf16 is the Hopper body's.
// Every mma.sync instance stops near 225 TFLOP/s (23-25 % of the bf16 peak),
// whatever the width.
//
// Hopper body (bsa_wgmma_kernel<128, 128, BATCHED>), bf16 only, the prefill
// main path of every GQA model at head dim 128: replaces the TPU kernel
// block_sparse_attention_batched (_kernel_batched) at that shape, with the
// same semantics and per-row arithmetic as above, on sm_90a's own path.
// Bound by the products as above; FlashAttention-3's design:
//   * One CTA of 384 threads per (row, h, b): a producer warpgroup
//     (setmaxnreg 40) whose thread 0 issues every TMA load, and two
//     consumer warpgroups (setmaxnreg 232), each owning 64 of the 128 query
//     rows.  __launch_bounds__(384, 1), 165 KB of shared memory.
//   * Loads by TMA, 128-byte swizzle, each 128 x 128 tile as two 128 x 64
//     boxes: Q once, then K and V as whole 128-key blocks in two rings of
//     two stages each (32 KB a stage), full and empty mbarriers per stage.
//     The producer reads block j from indices itself and loads row
//     kv0 + j * 128 of 2-D tensor maps over (B * Hkv * NBkv * 128, 128) K
//     and V (built on the host at each launch; cuTensorMapEncodeTiled
//     comes through the runtime's driver entry point).  K runs one block
//     ahead of V, since QK^T of block i + 1 comes before PV of block i.
//   * Products on wgmma.m64n128k16: S = Q K^T with both operands from
//     shared-memory descriptors (8 k-steps), O += P V with P from
//     registers (the float32 S fragments rounded to bf16 in place of the
//     A fragments) and V as the transposed B operand.
//   * Overlap: intra-warpgroup pipelining, QK^T of block i issued together
//     with PV of block i - 1, and the softmax of block i run while PV
//     executes.  FlashAttention-3's two-warpgroup ping-pong on named
//     barriers measured within the noise of none here (PERF.md), so the
//     warpgroups run unsynchronised.  The softmax only reads the
//     accumulator registers and writes P straight into the other of two
//     register arrays: a write to a register that a wgmma in flight reads
//     or writes makes ptxas wait for it, which put the exponentials after
//     PV.  2^x is ex2.approx.ftz (one SFU op; exp2f's denormal handling
//     cost a sixth of the body's time).
//   * The causal mask only on the block that crosses the diagonal (block
//     index against q_block_offset + row); interior blocks skip the
//     predicate.  The online softmax rescales O once per 128-key block.
//   * Ã: on interior blocks the count is 128^2 and is not counted (the
//     diagonal's is 128 * 129 / 2).  Each consumer warp shuffles its sum to
//     one value; the last of the 8 warps to arrive (an acquire-release
//     counter per slot, 4 slots) sums the 8 in warp order and writes the
//     mean, so the result does not depend on timing.  A named barrier over
//     the 256 consumer threads measured 3-10 % slower with half the heads
//     emitting; the producer never waits on either.
//   * Grid order as above; not persistent.
// float32 body (bsa_f32_kernel): products as FMAs on CUDA cores, one CTA per
// (row, h, b) of 2 * bs threads, Q, K, V and P in shared memory in float32,
// each thread owning 4 query rows x 4 keys of S and 4 rows x Dv/8 columns
// of the output.
#include <cuda.h>   // CUtensorMap and its enums (no driver library linked)

#include "common.cuh"

namespace {

constexpr int KT = 32;   // keys per sub-tile of the float32 body

enum Mode { BATCHED = 0, PAGED = 1, SINGLE = 2 };

struct Dims {
  int B, H, Hkv, N, NBkv, W, q_block_offset, causal, P;
};

// Everything a launch needs.  k / v are (B, Hkv, NBkv * bs, Dqk / Dv) for
// BATCHED and SINGLE and the pools (P, Hkv, bs, D) for PAGED; stats is a_tilde
// (B, H, NBq, NBkv) or, for SINGLE, the compact (H, NBq, W).
struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* page_table;   // PAGED only
  const int* indices;
  const int* counts;
  const int* gate;         // BATCHED and PAGED only
  void* out;
  float* stats;
  Dims d;
};

// The blocks a row visits: uniform min(counts, W) for SINGLE; for BATCHED
// and PAGED min(counts, steps), where steps is the row's budget in the TPU
// kernel's ragged schedule (min(causal bound, W)), which keeps its exact
// semantics.
template <int MODE>
__device__ __forceinline__ int visited(const Dims& a, int count, int row) {
  if constexpr (MODE == SINGLE) {
    return min(count, a.W);
  } else {
    int steps = a.causal ? min(a.q_block_offset + row + 1, a.W) : a.W;
    steps = max(1, min(steps, a.NBkv));
    return min(count, steps);
  }
}

// The float32 body: products as FMAs on CUDA cores (TF32 would miss the
// 1e-4 float32 tolerance, and float32 is on no serving path).
template <int BQ, int DQK, int DV, int MODE>
__global__ void __launch_bounds__(2 * BQ)
bsa_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const int* __restrict__ page_table,
           const int* __restrict__ indices, const int* __restrict__ counts,
           const int* __restrict__ gate, float* __restrict__ out,
           float* __restrict__ stats, Dims a, float scale) {
  using T = float;
  constexpr int NT = 2 * BQ;          // threads
  constexpr int QS = DQK + 1;         // padded row stride of Q and K tiles
  constexpr int PS = KT + 1;          // padded row stride of P
  constexpr int DC = DV / 8;          // output columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;                  // BQ x QS
  float* k_s = q_s + BQ * QS;         // KT x QS
  float* v_s = k_s + KT * QS;         // KT x DV
  float* p_s = v_s + KT * DV;         // BQ x PS
  __shared__ float red_sum[NT / 32], red_cnt[NT / 32];

  const int H = a.H, W = a.W, NBkv = a.NBkv;
  const int NBq = a.N / BQ;
  const int row = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;
  const int hk = h / (H / a.Hkv);
  const size_t bh = (size_t)b * H + h;
  const size_t trow = bh * NBq + row;  // table row
  const T* qb = q + (bh * a.N + (size_t)row * BQ) * DQK;
  // first K/V row of this (batch, kv head) in the contiguous instances
  const size_t kv0 = ((size_t)b * a.Hkv + hk) * (size_t)NBkv * BQ;

  const int n = visited<MODE>(a, counts[trow], row);
  const bool emit = MODE == SINGLE || gate[bh] != 0;

  for (int i = tid; i < BQ * DQK; i += NT)
    q_s[(i / DQK) * QS + (i % DQK)] = repro::to_f(qb[i]);

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }
  const int qpos0 = (a.q_block_offset + row) * BQ + 4 * ty;

  for (int w = 0; w < n; ++w) {
    const int j = indices[trow * W + w];
    // the block's first K/V row: the cache's (row j * bs of the head) or
    // the block's page
    size_t jrow = kv0 + (size_t)j * BQ;
    if constexpr (MODE == PAGED) {
      const int page = page_table[(size_t)b * NBkv + j];
      if (page < 0 || page >= a.P) continue;    // uniform across the CTA
      jrow = ((size_t)page * a.Hkv + hk) * (size_t)BQ;
    }
    float s_sum = 0.f, s_cnt = 0.f;
    for (int t0 = 0; t0 < BQ; t0 += KT) {
      __syncthreads();                // previous sub-tile fully consumed
      for (int i = tid; i < KT * DQK; i += NT) {
        int r = i / DQK, c = i - r * DQK;
        k_s[r * QS + c] = repro::to_f(k[(jrow + t0 + r) * DQK + c]);
      }
      for (int i = tid; i < KT * DV; i += NT) {
        int r = i / DV, c = i - r * DV;
        v_s[r * DV + c] = repro::to_f(v[(jrow + t0 + r) * DV + c]);
      }
      __syncthreads();

      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[i][c] = 0.f;
#pragma unroll 8
      for (int d = 0; d < DQK; ++d) {
        float qv[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) qv[i] = q_s[(4 * ty + i) * QS + d];
#pragma unroll
        for (int c = 0; c < 4; ++c) kv[c] = k_s[(tx + 8 * c) * QS + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
      }

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        bool ok[4];
        float mx = -CUDART_INF_F;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int kpos = j * BQ + t0 + tx + 8 * c;
          ok[c] = !a.causal || kpos <= qpos0 + i;
          s[i][c] *= scale;
          if (ok[c]) {
            mx = fmaxf(mx, s[i][c]);
            if (emit) { s_sum += s[i][c]; s_cnt += 1.f; }
          }
        }
        mx = repro::group_max<8>(mx);
        const float m_new = fmaxf(m[i], mx);
        const float alpha = (m[i] == -CUDART_INF_F) ? 0.f
                                                    : expf(m[i] - m_new);
        float ps = 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float p = ok[c] ? expf(s[i][c] - m_new) : 0.f;
          p_s[(4 * ty + i) * PS + tx + 8 * c] = p;
          ps += p;
        }
        ps = repro::group_sum<8>(ps);
        l[i] = l[i] * alpha + ps;
        m[i] = m_new;
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
      }
      __syncthreads();

#pragma unroll 4
      for (int kk = 0; kk < KT; ++kk) {
        float pv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) pv[i] = p_s[(4 * ty + i) * PS + kk];
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          const float vv = v_s[kk * DV + tx + 8 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
        }
      }
    }
    if (emit) {                       // uniform across the CTA
      s_sum = repro::group_sum<32>(s_sum);
      s_cnt = repro::group_sum<32>(s_cnt);
      if ((tid & 31) == 0) {
        red_sum[tid >> 5] = s_sum;
        red_cnt[tid >> 5] = s_cnt;
      }
      __syncthreads();
      if (tid == 0) {
        float sum = 0.f, cnt = 0.f;
        for (int i = 0; i < NT / 32; ++i) {
          sum += red_sum[i];
          cnt += red_cnt[i];
        }
        const float mean = cnt > 0.f ? sum / cnt : -CUDART_INF_F;
        if constexpr (MODE == SINGLE) stats[trow * W + w] = mean;
        else stats[trow * NBkv + j] = mean;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    T* ob = out + (bh * a.N + (size_t)row * BQ + 4 * ty + i) * DV;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      ob[tx + 8 * c] = repro::from_f<T>(acc[i][c] * inv);
  }
}

// The bfloat16 body (header comment).  The pointers stay __restrict__
// kernel parameters (read-only loads).
template <int BQ, int DQK, int DV, int MODE>
__global__ void __launch_bounds__(2 * BQ, 1)
bsa_tc_kernel(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v,
              const int* __restrict__ page_table,
              const int* __restrict__ indices,
              const int* __restrict__ counts, const int* __restrict__ gate,
              __nv_bfloat16* __restrict__ out, float* __restrict__ stats,
              Dims a, float scale) {
  using bf16 = __nv_bfloat16;
  constexpr int NT = 2 * BQ;          // threads
  constexpr int NW = NT / 32;         // warps, 16 query rows each
  constexpr int KN = 64;              // keys per sub-tile
  constexpr int TPB = BQ / KN;        // sub-tiles per kv block
  constexpr int DP = DQK + 8;         // padded smem row of Q and K (bf16)
  constexpr int VP = DV + 8;          // padded smem row of V (bf16)
  constexpr int DK = DQK / 16;        // k-steps of QK^T
  constexpr int NN = KN / 8;          // n-tiles of S
  constexpr int DN = DV / 8;          // n-tiles of O
  constexpr int CPR = DQK / 8;        // 16-byte chunks per Q / K row
  constexpr int CPV = DV / 8;         // 16-byte chunks per V row
  // Q's A fragments stay in registers for the whole row up to Dqk = 192;
  // at 256 (with O's 128 accumulators) they are reloaded from q_s at
  // each k-step instead
  constexpr bool QREG = DQK <= 192;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);   // BQ x DP
  bf16* k_s = q_s + BQ * DP;                       // 2 stages x KN x DP
  bf16* v_s = k_s + 2 * KN * DP;                   // 2 stages x KN x VP
  __shared__ float red_sum[2][NW];
  __shared__ int red_cnt[2][NW];

  const int H = a.H, G = H / a.Hkv, W = a.W, NBkv = a.NBkv;
  const int NBq = a.N / BQ;
  // launch order: g fastest, then kv head, batch, and the rows reversed
  int t = blockIdx.x;
  const int g = t % G;
  t /= G;
  const int hk = t % a.Hkv;
  t /= a.Hkv;
  const int b = t % a.B;
  const int row = NBq - 1 - t / a.B;
  const int h = hk * G + g;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;   // fragment row / column group
  const size_t bh = (size_t)b * H + h;
  const size_t trow = bh * NBq + row;        // table row
  const bf16* qb = q + (bh * a.N + (size_t)row * BQ) * DQK;
  // first K/V row of this (batch, kv head) in the contiguous instances
  const size_t kv0 = ((size_t)b * a.Hkv + hk) * (size_t)NBkv * BQ;

  const int n = visited<MODE>(a, counts[trow], row);
  const bool emit = MODE == SINGLE || gate[bh] != 0;
  const int ntiles = n * TPB;

  // sub-tile i: its block (rank w, id j) and first K/V row; false for a
  // block on a page outside [0, P) (uniform across the CTA)
  auto source = [&](int i, int& j, size_t& r0) -> bool {
    j = indices[trow * W + i / TPB];
    const int sub = i % TPB;
    if constexpr (MODE == PAGED) {
      const int page = page_table[(size_t)b * NBkv + j];
      if (page < 0 || page >= a.P) return false;
      r0 = ((size_t)page * a.Hkv + hk) * BQ + (size_t)sub * KN;
    } else {
      r0 = kv0 + (size_t)j * BQ + (size_t)sub * KN;
    }
    return true;
  };
  auto prefetch = [&](int i) {
    int j;
    size_t r0;
    if (!source(i, j, r0)) return;
    bf16* ks = k_s + (i & 1) * KN * DP;
    bf16* vs = v_s + (i & 1) * KN * VP;
    for (int c = tid; c < KN * CPR; c += NT) {
      const int r = c / CPR, cc = (c % CPR) * 8;
      repro::cp_async16(ks + r * DP + cc, k + (r0 + r) * DQK + cc);
    }
    for (int c = tid; c < KN * CPV; c += NT) {
      const int r = c / CPV, cc = (c % CPV) * 8;
      repro::cp_async16(vs + r * VP + cc, v + (r0 + r) * DV + cc);
    }
  };

  for (int c = tid; c < BQ * CPR; c += NT) {
    const int r = c / CPR, cc = (c % CPR) * 8;
    repro::cp_async16(q_s + r * DP + cc, qb + (size_t)r * DQK + cc);
  }
  if (ntiles > 0) prefetch(0);
  repro::cp_async_commit();

  float o[DN][4];
#pragma unroll
  for (int i = 0; i < DN; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
  uint32_t qf[QREG ? DK : 1][4];
  const float sl2 = scale * 1.4426950408889634f;   // logits in base 2
  const int q0 = (a.q_block_offset + row) * BQ;     // first query position
  const int qr = q0 + warp * 16 + gq;               // rows gq and gq + 8
  // warp w's A fragment of QK^T's k-step kk, from the Q tile
  auto load_q = [&](uint32_t (&f)[4], int kk) {
    repro::ldmatrix_x4(f, q_s + (warp * 16 + (lane & 7) +
                                 ((lane >> 3) & 1) * 8) * DP +
                              kk * 16 + (lane >> 4) * 8);
  };
  float ssum = 0.f;                                 // this block's Ã terms
  int scnt = 0;
  int pend_w = -1, pend_j = 0;   // block whose per-warp stats await thread 0

  auto flush = [&]() {           // thread 0, after a barrier
    float sum = 0.f;
    int cnt = 0;
#pragma unroll
    for (int x = 0; x < NW; ++x) {
      sum += red_sum[pend_w & 1][x];
      cnt += red_cnt[pend_w & 1][x];
    }
    const float mean = cnt > 0 ? sum * scale / (float)cnt : -CUDART_INF_F;
    if constexpr (MODE == SINGLE) stats[trow * W + pend_w] = mean;
    else stats[trow * NBkv + pend_j] = mean;
  };

  for (int i = 0; i < ntiles; ++i) {
    repro::cp_async_wait<0>();
    __syncthreads();            // sub-tile i landed; sub-tile i - 1 consumed
    if constexpr (QREG) {
      if (i == 0) {
#pragma unroll
        for (int kk = 0; kk < DK; ++kk) load_q(qf[kk], kk);
      }
    }
    if (pend_w >= 0) {
      if (tid == 0) flush();
      pend_w = -1;
    }
    if (i + 1 < ntiles) prefetch(i + 1);
    repro::cp_async_commit();
    int j;
    size_t r0;
    if (!source(i, j, r0)) continue;
    const int sub = i % TPB;
    const bf16* ks = k_s + (i & 1) * KN * DP;
    const bf16* vs = v_s + (i & 1) * KN * VP;

    // S = Q K^T (16 rows x 64 keys per warp)
    float s[NN][4];
#pragma unroll
    for (int nt = 0; nt < NN; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DK; ++kk) {
      uint32_t qa[4];
      if constexpr (QREG) {
#pragma unroll
        for (int e = 0; e < 4; ++e) qa[e] = qf[kk][e];
      } else {
        load_q(qa, kk);
      }
#pragma unroll
      for (int np = 0; np < NN / 2; ++np) {
        uint32_t kb[4];
        repro::ldmatrix_x4(kb, ks + (np * 16 + (lane & 7) + (lane >> 4) * 8)
                                          * DP +
                                   kk * 16 + ((lane >> 3) & 1) * 8);
        repro::mma_bf16(s[2 * np], qa, kb[0], kb[1]);
        repro::mma_bf16(s[2 * np + 1], qa, kb[2], kb[3]);
      }
    }

    // causal mask, Ã terms, and the online softmax of rows gq, gq + 8
    const int k0 = j * BQ + sub * KN;               // first key position
    const bool full = !a.causal || k0 + KN - 1 <= q0;
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int nt = 0; nt < NN; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rr = e >> 1;
        const bool ok =
            full || k0 + nt * 8 + 2 * tq + (e & 1) <= qr + 8 * rr;
        if (emit && ok) { ssum += s[nt][e]; ++scnt; }
        s[nt][e] = ok ? s[nt][e] * sl2 : -CUDART_INF_F;
        mx[rr] = fmaxf(mx[rr], s[nt][e]);
      }
    float alpha[2], m_use[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
      const float m_new = fmaxf(m[rr], mx[rr]);
      alpha[rr] = m[rr] == -CUDART_INF_F ? 0.f : exp2f(m[rr] - m_new);
      m_use[rr] = m_new == -CUDART_INF_F ? 0.f : m_new;
      m[rr] = m_new;
      l[rr] *= alpha[rr];
    }
#pragma unroll
    for (int nt = 0; nt < NN; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[nt][e] - m_use[e >> 1]);   // 0 off the mask
        s[nt][e] = p;
        l[e >> 1] += p;
      }
#pragma unroll
    for (int dn = 0; dn < DN; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[dn][e] *= alpha[e >> 1];

    // O += P V, P rounded to bf16 as the A operand
#pragma unroll
    for (int kk = 0; kk < KN / 16; ++kk) {
      const uint32_t pa[4] = {
          repro::pack_bf16(s[2 * kk][0], s[2 * kk][1]),
          repro::pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          repro::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          repro::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < DV / 16; ++dp) {
        uint32_t vb[4];
        repro::ldmatrix_x4_trans(
            vb, vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * VP +
                    dp * 16 + (lane >> 4) * 8);
        repro::mma_bf16(o[2 * dp], pa, vb[0], vb[1]);
        repro::mma_bf16(o[2 * dp + 1], pa, vb[2], vb[3]);
      }
    }

    if (emit && sub == TPB - 1) {     // the block's last sub-tile: uniform
      ssum = repro::group_sum<32>(ssum);
      scnt = repro::group_sum_int<32>(scnt);
      const int w = i / TPB;
      if (lane == 0) {
        red_sum[w & 1][warp] = ssum;
        red_cnt[w & 1][warp] = scnt;
      }
      ssum = 0.f;
      scnt = 0;
      pend_w = w;
      pend_j = j;
    }
  }
  repro::cp_async_wait<0>();
  __syncthreads();
  if (pend_w >= 0 && tid == 0) flush();

  // out = O / max(l, 1e-30): a row with nothing visited writes zeros
  float inv[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 1);
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 2);
    inv[rr] = 1.f / fmaxf(l[rr], 1e-30f);
  }
  bf16* ob = out + (bh * a.N + (size_t)row * BQ + warp * 16 + gq) * DV;
#pragma unroll
  for (int dn = 0; dn < DN; ++dn)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)rr * 8 * DV + dn * 8 +
                                         2 * tq) =
          __floats2bfloat162_rn(o[dn][2 * rr] * inv[rr],
                                o[dn][2 * rr + 1] * inv[rr]);
}

// The Hopper body (header comment): shared memory from a 1024-byte aligned
// base.  Every tile is two 16 KB halves of 128 rows x 64 bf16 columns in
// the TMA's 128-byte swizzle (one box each).
namespace wg {
constexpr int THREADS = 384;          // producer warpgroup + 2 consumers
constexpr int HALF = 128 * 64 * 2;    // bytes of one 128 x 64 box
constexpr int TILE = 2 * HALF;        // a 128 x 128 bf16 tile
constexpr int Q_OFF = 0;
constexpr int K_OFF = TILE;           // 2 stages
constexpr int V_OFF = 3 * TILE;       // 2 stages
constexpr int BAR_OFF = 5 * TILE;     // 9 mbarriers
constexpr int RED_OFF = BAR_OFF + 128;  // float [4][8]: Ã per warp
constexpr int CNT_OFF = RED_OFF + 128;  // int [4]: warps arrived
constexpr int SMEM = CNT_OFF + 16 + 1024;  // + slack for the alignment
}  // namespace wg

// One 128-key block of a consumer thread's two query rows (rl and rl + 8
// of the tile): s holds its 64 raw logits, which are only read (a write to
// an accumulator register waits for every wgmma in flight, the PV of the
// previous block among them).  Applies the causal mask where MASK (the
// block crosses the diagonal: valid iff key column <= query row; none if
// dead, above it), steps the online softmax (m, l in base 2; alpha the
// rescale of O) and writes P, rounded to bf16, into p as PV's A fragments
// (p[4kk..4kk+3] for keys 16kk..16kk+15).  Returns the sum of the raw
// valid logits for Ã (0 unless EMIT).  The sums and maxima run over 4
// and 2 partial accumulators to shorten their dependency chains.
template <bool EMIT, bool MASK>
__device__ __forceinline__ float softmax_block(
    const float (&s)[64], uint32_t (&p)[32], float (&m)[2], float (&l)[2],
    float (&alpha)[2], float sl2, bool dead, int rl, int tq) {
  auto valid = [&](int i) {
    return !MASK || (!dead && 8 * (i >> 2) + 2 * tq + (i & 1) <=
                                  rl + 8 * ((i >> 1) & 1));
  };
  float part[4] = {0.f, 0.f, 0.f, 0.f};
  float mx[2][2] = {{-CUDART_INF_F, -CUDART_INF_F},
                    {-CUDART_INF_F, -CUDART_INF_F}};
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const bool ok = valid(i);
    if constexpr (EMIT) part[i & 3] += ok ? s[i] : 0.f;
    mx[(i >> 1) & 1][i >> 5] =
        fmaxf(mx[(i >> 1) & 1][i >> 5], ok ? s[i] : -CUDART_INF_F);
  }
  float m_use[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float x = fmaxf(mx[rr][0], mx[rr][1]);
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
    x *= sl2;                  // max(s) * c == max(s * c): rounding is monotone
    const float m_new = fmaxf(m[rr], x);
    alpha[rr] = m[rr] == -CUDART_INF_F ? 0.f : exp2f(m[rr] - m_new);
    m_use[rr] = m_new == -CUDART_INF_F ? 0.f : m_new;
    m[rr] = m_new;
  }
  float ls[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
  for (int k = 0; k < 32; ++k) {      // entries 2k, 2k + 1: one row
    const int rr = k & 1;
    const float p0 = valid(2 * k)
        ? repro::ex2_ftz(fmaf(s[2 * k], sl2, -m_use[rr])) : 0.f;
    const float p1 = valid(2 * k + 1)
        ? repro::ex2_ftz(fmaf(s[2 * k + 1], sl2, -m_use[rr])) : 0.f;
    ls[rr][k >> 4] += p0 + p1;
    p[k] = repro::pack_bf16(p0, p1);
  }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr)
    l[rr] = l[rr] * alpha[rr] + (ls[rr][0] + ls[rr][1]);
  return EMIT ? (part[0] + part[1]) + (part[2] + part[3]) : 0.f;
}

template <int BQ, int D, int MODE>
__global__ void __launch_bounds__(wg::THREADS, 1)
bsa_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 const int* __restrict__ indices,
                 const int* __restrict__ counts,
                 const int* __restrict__ gate,
                 __nv_bfloat16* __restrict__ out, float* __restrict__ stats,
                 Dims a, float scale) {
  static_assert(BQ == 128 && D == 128 && MODE == BATCHED,
                "the Hopper body has one instance");
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  unsigned char* sm =
      wg_smem + ((1024 - (repro::smem_addr(wg_smem) & 1023)) & 1023);
  unsigned char* q_s = sm + wg::Q_OFF;
  unsigned char* k_s = sm + wg::K_OFF;
  unsigned char* v_s = sm + wg::V_OFF;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + wg::BAR_OFF);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;        // [2]
  uint64_t* k_empty = bars + 3;       // [2]
  uint64_t* v_full = bars + 5;        // [2]
  uint64_t* v_empty = bars + 7;       // [2]
  float* red = reinterpret_cast<float*>(sm + wg::RED_OFF);   // [4][8]
  int* arrived = reinterpret_cast<int*>(sm + wg::CNT_OFF);    // [4]

  const int H = a.H, G = H / a.Hkv, W = a.W, NBkv = a.NBkv;
  const int NBq = a.N / BQ;
  // launch order: g fastest, then kv head, batch, and the rows reversed
  int t = blockIdx.x;
  const int g = t % G;
  t /= G;
  const int hk = t % a.Hkv;
  t /= a.Hkv;
  const int b = t % a.B;
  const int row = NBq - 1 - t / a.B;
  const int h = hk * G + g;
  const int tid = threadIdx.x;
  const size_t bh = (size_t)b * H + h;
  const size_t trow = bh * NBq + row;        // table row
  const int n = visited<MODE>(a, counts[trow], row);
  __nv_bfloat16* ob = out + (bh * a.N + (size_t)row * BQ) * D;

  if (n == 0) {                    // nothing visited: zeros (uniform)
    for (int c = tid; c < BQ * D / 8; c += wg::THREADS)
      reinterpret_cast<uint4*>(ob)[c] = make_uint4(0, 0, 0, 0);
    return;
  }
  if (tid == 0) {
    repro::mbar_init(q_full, 1);
    for (int s = 0; s < 2; ++s) {
      repro::mbar_init(k_full + s, 1);
      repro::mbar_init(v_full + s, 1);
      repro::mbar_init(k_empty + s, 8);   // lane 0 of each consumer warp
      repro::mbar_init(v_empty + s, 8);
    }
    for (int e = 0; e < 4; ++e) arrived[e] = 0;
    repro::mbar_fence_init();
  }
  __syncthreads();

  if (tid < 128) {
    // ---- producer: one thread issues every TMA load
    repro::regs_dealloc<40>();
    if (tid != 0) return;
    const int kv0 = (b * a.Hkv + hk) * NBkv * BQ;   // first K/V row
    const int* tab = indices + trow * W;
    const int q_row = (int)(bh * a.N) + row * BQ;
    repro::mbar_expect_tx(q_full, wg::TILE);
    repro::tma_load_2d(q_s, &tq, q_full, 0, q_row);
    repro::tma_load_2d(q_s + wg::HALF, &tq, q_full, 64, q_row);
    auto load = [&](const CUtensorMap* map, unsigned char* ring,
                    uint64_t* full, uint64_t* empty, int i, int r) {
      const int s = i & 1, use = i >> 1;
      if (use > 0) repro::mbar_wait(empty + s, (use - 1) & 1);
      unsigned char* dst = ring + s * wg::TILE;
      repro::mbar_expect_tx(full + s, wg::TILE);
      repro::tma_load_2d(dst, map, full + s, 0, r);
      repro::tma_load_2d(dst + wg::HALF, map, full + s, 64, r);
    };
    // K runs one block ahead of V: K_{i+1} is needed (QK^T of block i+1)
    // before V_i (PV of block i)
    int r_next = kv0 + tab[0] * BQ;
    load(&tk, k_s, k_full, k_empty, 0, r_next);
    for (int i = 0; i < n; ++i) {
      const int r = r_next;
      if (i + 1 < n) {
        r_next = kv0 + tab[i + 1] * BQ;
        load(&tk, k_s, k_full, k_empty, i + 1, r_next);
      }
      load(&tv, v_s, v_full, v_empty, i, r);
    }
    return;
  }

  // ---- consumers: warpgroup cw owns the tile's query rows [64cw, 64cw+64)
  repro::regs_alloc<232>();
  const int ct = tid - 128;                  // 0..255
  const int cw = ct >> 7, warp = (ct >> 5) & 3, lane = tid & 31;
  const int gq = lane >> 2, tq4 = lane & 3;  // fragment row / column group
  const int rl = 64 * cw + 16 * warp + gq;   // rows rl, rl + 8 of the tile
  const int* tab = indices + trow * W;
  const bool emit = gate[bh] != 0;
  const int qb = a.q_block_offset + row;     // the row's block position
  const float sl2 = scale * 1.4426950408889634f;   // logits in base 2
  const uint32_t q_addr = repro::smem_addr(q_s) + cw * 64 * 128;
  const uint32_t k_addr = repro::smem_addr(k_s);
  const uint32_t v_addr = repro::smem_addr(v_s);

  float o[64], s[64];
  uint32_t pa[32], pb[32];   // P of alternate blocks (see step)
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
  int emitted = 0;                           // Ã reductions so far

  // S = Q K^T of the block in K stage ks: 8 k-steps of 16 columns, each a
  // 32-byte step inside a 128-byte swizzled row, the second four in the
  // tile's second half
  auto issue_qk = [&](int ks) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk >> 2) * wg::HALF + (kk & 3) * 32;
      repro::wgmma_m64n128k16_ss(
          s, repro::sw128_desc(q_addr + off, 16, 1024),
          repro::sw128_desc(k_addr + ks * wg::TILE + off, 16, 1024), kk > 0);
    }
    repro::wgmma_commit();
  };
  // O += P V of the block in V stage vs: 8 k-steps of 16 keys (2 KB of
  // rows each); V's 128 columns are the tile's two halves (LBO 16 KB),
  // its 8-key groups 1 KB apart (SBO)
  auto issue_pv = [&](int vs, const uint32_t (&p)[32]) {
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      repro::wgmma_m64n128k16_rs(
          o, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3],
          repro::sw128_desc(v_addr + vs * wg::TILE + kk * 2048, wg::HALF,
                            1024));
    repro::wgmma_commit();
  };
  // block j's softmax into p (softmax_block); returns its Ã sum
  auto softmax = [&](int j, uint32_t (&p)[32], float (&alpha)[2]) {
    const bool full = !a.causal || j < qb;
    const bool dead = a.causal && j > qb;
    if (emit)
      return full ? softmax_block<true, false>(s, p, m, l, alpha, sl2, dead,
                                               rl, tq4)
                  : softmax_block<true, true>(s, p, m, l, alpha, sl2, dead,
                                              rl, tq4);
    return full ? softmax_block<false, false>(s, p, m, l, alpha, sl2, dead,
                                              rl, tq4)
                : softmax_block<false, true>(s, p, m, l, alpha, sl2, dead,
                                             rl, tq4);
  };
  // Ã of block j (uniform)
  auto stat = [&](int j, float sum) {
    const bool full = !a.causal || j < qb;
    if (!emit || (a.causal && j > qb)) return;
    sum = repro::group_sum<32>(sum);
    const int cnt = full ? BQ * BQ : BQ * (BQ + 1) / 2;
    // the last of the 8 consumer warps to arrive sums their slots in warp
    // order; 4 slots: a warp at block i waited for the K stage that every
    // warp freed after its QK^T of block i - 2, so every warp has finished
    // the Ã of block i - 3 and at most 3 slots are in use
    const int e = emitted++ & 3;
    if (lane == 0) {
      volatile float* slot = red + e * 8;
      slot[ct >> 5] = sum;
      // release: the slot's store before the count; acquire: the other
      // warps' slots after it
      if (repro::atomic_add_acq_rel(arrived + e, 1) == 7) {
        float tot = 0.f;
#pragma unroll
        for (int x = 0; x < 8; ++x) tot += slot[x];
        arrived[e] = 0;
        stats[trow * NBkv + j] = tot * scale / (float)cnt;
      }
    }
  };
  repro::mbar_wait(q_full, 0);
  // block 0: QK^T, then its softmax (O is still zero)
  int j = tab[0];
  repro::mbar_wait(k_full, 0);
  repro::wgmma_fence();
  issue_qk(0);
  repro::wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < 64; ++i) repro::keep(s[i]);
  if (lane == 0) repro::mbar_arrive(k_empty);
  {
    float alpha[2];
    const float sum = softmax(j, pa, alpha);
    stat(j, sum);
  }
  // block i: QK^T of block i and PV of block i - 1 (P in pin) in flight
  // together; block i's softmax runs while the tensor cores do PV.  Its P
  // goes to the other array, pout: a write to pin's registers would wait
  // for the PV that reads them (ptxas serialises the two), so P alternates
  // between pa and pb and the loop is unrolled by two
  auto step = [&](int i, const uint32_t (&pin)[32], uint32_t (&pout)[32]) {
    const int jb = tab[i];
    const int ks = i & 1, vs = (i - 1) & 1;
    repro::mbar_wait(k_full + ks, (i >> 1) & 1);
    repro::mbar_wait(v_full + vs, ((i - 1) >> 1) & 1);
    repro::wgmma_fence();
    issue_qk(ks);
    issue_pv(vs, pin);
    repro::wgmma_wait<1>();                 // S of block i is done
#pragma unroll
    for (int x = 0; x < 64; ++x) repro::keep(s[x]);
    if (lane == 0) repro::mbar_arrive(k_empty + ks);
    float alpha[2];
    const float sum = softmax(jb, pout, alpha);
    stat(jb, sum);                          // also in the shadow of PV
    repro::wgmma_wait<0>();                 // PV of block i - 1 is done
#pragma unroll
    for (int x = 0; x < 64; ++x) repro::keep(o[x]);
    if (lane == 0) repro::mbar_arrive(v_empty + vs);
#pragma unroll
    for (int x = 0; x < 64; ++x) o[x] *= alpha[(x >> 1) & 1];
  };
  // PV of the last block
  auto last_pv = [&](const uint32_t (&p)[32]) {
    const int vs = (n - 1) & 1;
    repro::mbar_wait(v_full + vs, ((n - 1) >> 1) & 1);
    repro::wgmma_fence();
    issue_pv(vs, p);
    repro::wgmma_wait<0>();
#pragma unroll
    for (int x = 0; x < 64; ++x) repro::keep(o[x]);
  };
  int i = 1;
  for (; i + 1 < n; i += 2) {
    step(i, pa, pb);
    step(i + 1, pb, pa);
  }
  if (i < n) {
    step(i, pa, pb);
    last_pv(pb);
  } else {
    last_pv(pa);
  }

  // out = O / max(l, 1e-30)
  float inv[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 1);
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 2);
    inv[rr] = 1.f / fmaxf(l[rr], 1e-30f);
  }
  __nv_bfloat16* orow = ob + (size_t)rl * D;
#pragma unroll
  for (int jj = 0; jj < D / 8; ++jj)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
      *reinterpret_cast<__nv_bfloat162*>(orow + (size_t)rr * 8 * D +
                                         jj * 8 + 2 * tq4) =
          __floats2bfloat162_rn(o[4 * jj + 2 * rr] * inv[rr],
                                o[4 * jj + 2 * rr + 1] * inv[rr]);
}

template <int BQ, int DQK, int DV, int MODE>
int launch_f32(const Args& a, void* stream) {
  constexpr int QS = DQK + 1;
  const size_t smem =
      (size_t)(BQ * QS + KT * QS + KT * DV + BQ * (KT + 1)) * sizeof(float);
  const cudaError_t e = cudaFuncSetAttribute(
      bsa_f32_kernel<BQ, DQK, DV, MODE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(a.d.N / BQ, a.d.H, a.d.B);
  bsa_f32_kernel<BQ, DQK, DV, MODE>
      <<<grid, 2 * BQ, smem, (cudaStream_t)stream>>>(
          (const float*)a.q, (const float*)a.k, (const float*)a.v,
          a.page_table, a.indices, a.counts, a.gate, (float*)a.out, a.stats,
          a.d, 1.0f / sqrtf((float)DQK));
  return (int)cudaGetLastError();
}

template <int BQ, int DQK, int DV, int MODE>
int launch_tc(const Args& a, void* stream) {
  const size_t smem =
      ((size_t)(BQ + 2 * 64) * (DQK + 8) + (size_t)2 * 64 * (DV + 8)) *
      sizeof(__nv_bfloat16);
  const cudaError_t e = cudaFuncSetAttribute(
      bsa_tc_kernel<BQ, DQK, DV, MODE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const unsigned ctas = (unsigned)(a.d.N / BQ) * a.d.H * a.d.B;
  bsa_tc_kernel<BQ, DQK, DV, MODE>
      <<<ctas, 2 * BQ, smem, (cudaStream_t)stream>>>(
          (const __nv_bfloat16*)a.q, (const __nv_bfloat16*)a.k,
          (const __nv_bfloat16*)a.v, a.page_table, a.indices, a.counts,
          a.gate, (__nv_bfloat16*)a.out, a.stats, a.d,
          1.0f / sqrtf((float)DQK));
  return (int)cudaGetLastError();
}

// cuTensorMapEncodeTiled, from the driver through the runtime's entry
// point (no -lcuda at build time); nullptr where the driver has none.
using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(f)
               : nullptr;
  }();
  return fn;
}

// A (rows, 128) bf16 matrix as 128 x 64 boxes in the 128-byte swizzle.
bool tile_map(CUtensorMap* map, const void* base, long long rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {128, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {128 * sizeof(__nv_bfloat16)};
  const cuuint32_t box[2] = {64, 128};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The Hopper body at bs = 128, Dqk = Dv = 128, BATCHED, bf16.  The tensor
// maps are built at each launch (the pointers change from layer to layer);
// TMA coordinates are 32-bit, so q's and K/V's rows must stay below 2^31.
int launch_wgmma(const Args& a, void* stream) {
  const Dims& d = a.d;
  const long long q_rows = (long long)d.B * d.H * d.N;
  const long long kv_rows = (long long)d.B * d.Hkv * d.NBkv * 128;
  if (q_rows >= (1ll << 31) || kv_rows >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  if (!tile_map(&tq, a.q, q_rows) || !tile_map(&tk, a.k, kv_rows) ||
      !tile_map(&tv, a.v, kv_rows))
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      bsa_wgmma_kernel<128, 128, BATCHED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, wg::SMEM);
  if (e != cudaSuccess) return (int)e;
  const unsigned ctas = (unsigned)(d.N / 128) * d.H * d.B;
  bsa_wgmma_kernel<128, 128, BATCHED>
      <<<ctas, wg::THREADS, wg::SMEM, (cudaStream_t)stream>>>(
          tq, tk, tv, a.indices, a.counts, a.gate, (__nv_bfloat16*)a.out,
          a.stats, d, 1.0f / sqrtf(128.f));
  return (int)cudaGetLastError();
}

template <int BQ, int DQK, int DV, int MODE>
int launch(bool tc, const Args& a, void* stream) {
  return tc ? launch_tc<BQ, DQK, DV, MODE>(a, stream)
            : launch_f32<BQ, DQK, DV, MODE>(a, stream);
}

// bfloat16 takes the tensor-core body (the Hopper body for BATCHED at bs =
// 128 and D = 128: the shape and dtype alone choose), float32 the
// CUDA-core one; bs in
// {64, 128} and equal Q/K and V widths D in {64, 96, 128}, or, for BATCHED
// and SINGLE, D = 256 or (Dqk, Dv) = (192, 128) (DeepSeek-V2's MLA
// prefill: qk_nope 128 + qk_rope 64 against v 128); anything else is
// refused.  D = 96
// (phi3-mini) divides both bodies' tiles: 6 k-steps of QK^T and 12 n-tiles
// of O on the tensor cores, 12 output columns a thread on CUDA cores; its
// padded row of 104 bf16 (208 bytes) keeps ldmatrix's 16-byte row
// addresses aligned and its eight rows on distinct bank quads.  At 192/128
// the tensor-core body takes 12 k-steps of QK^T and 16 n-tiles of O (the
// Q fragments 48 registers); the Q tile and K ring rows are padded to 200
// bf16 (400 bytes: eight rows at 16 r mod 128 bytes, distinct bank quads)
// and the V ring to 136, 137 KB of shared memory at bs = 128; the float32
// body holds Q and K at 193 floats a row, 157 KB at bs = 128.  The scale is
// 1 / sqrt(Dqk) and Ã the block mean of Q K^T, whatever Dv.  D = 256
// (RecurrentGemma's local attention: 16 query heads over one kv head),
// BATCHED and SINGLE only: 16 k-steps of QK^T and 32 n-tiles of O, whose
// 128 float32 accumulators leave no room for Q's 64 fragment registers, so
// the tensor-core body reads each k-step's fragment from the Q tile
// (QREG false; the same arithmetic); rows padded to 264 bf16 (528 bytes:
// eight rows at 16 r mod 128 bytes), 198 KB of shared memory at bs = 128
// and 165 KB at 64; the float32 body 209 KB at bs = 128.
template <int BQ, int MODE>
int by_dim(bool tc, int D, int Dv, const Args& a, void* stream) {
  if (D == Dv) {
    if constexpr (BQ == 128 && MODE == BATCHED) {
      if (D == 128)       // bf16 takes the Hopper body (header comment)
        return tc ? launch_wgmma(a, stream)
                  : launch_f32<128, 128, 128, BATCHED>(a, stream);
    }
    if (D == 128) return launch<BQ, 128, 128, MODE>(tc, a, stream);
    if (D == 96) return launch<BQ, 96, 96, MODE>(tc, a, stream);
    if (D == 64) return launch<BQ, 64, 64, MODE>(tc, a, stream);
  }
  if constexpr (MODE != PAGED) {
    if (D == 256 && Dv == 256)
      return launch<BQ, 256, 256, MODE>(tc, a, stream);
    if (D == 192 && Dv == 128)
      return launch<BQ, 192, 128, MODE>(tc, a, stream);
  }
  return (int)cudaErrorInvalidValue;
}

template <int MODE>
int dispatch(int dtype, int bs, int D, int Dv, const Args& a, void* stream) {
  const bool tc = dtype == REPRO_BF16;
  if (bs == 128) return by_dim<128, MODE>(tc, D, Dv, a, stream);
  if (bs == 64) return by_dim<64, MODE>(tc, D, Dv, a, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q (B, H, N, D); k (B, Hkv, Nkv, D); v (B, Hkv, Nkv, Dv); out (B, H, N,
// Dv); tables (B, H, N / bs, W); gate (B, H); a_tilde (B, H, N / bs,
// Nkv / bs), filled with -inf.
extern "C" int repro_block_sparse_attn(
    const void* q, const void* k, const void* v, const int* indices,
    const int* counts, const int* gate, void* out, float* a_tilde, int dtype,
    int B, int H, int Hkv, int N, int Nkv, int D, int Dv, int bs, int W,
    int q_block_offset, int causal, void* stream) {
  const Args a{q, k, v, nullptr, indices, counts, gate, out, a_tilde,
               {B, H, Hkv, N, Nkv / bs, W, q_block_offset, causal, 0}};
  return dispatch<BATCHED>(dtype, bs, D, Dv, a, stream);
}

// pool_k / pool_v (P, Hkv, bs, D); page_table (B, NBkv); the rest as above,
// with a_tilde (B, H, N / bs, NBkv) in logical block coordinates.
extern "C" int repro_block_sparse_attn_paged(
    const void* q, const void* pool_k, const void* pool_v,
    const int* page_table, const int* indices, const int* counts,
    const int* gate, void* out, float* a_tilde, int dtype, int B, int H,
    int Hkv, int N, int NBkv, int D, int bs, int W, int q_block_offset,
    int causal, int P, void* stream) {
  const Args a{q, pool_k, pool_v, page_table, indices, counts, gate, out,
               a_tilde, {B, H, Hkv, N, NBkv, W, q_block_offset, causal, P}};
  return dispatch<PAGED>(dtype, bs, D, D, a, stream);
}

// q (H, N, D); k (Hkv, N, D); v (Hkv, N, Dv); out (H, N, Dv); tables
// (H, N / bs, W); stats (H, N / bs, W), filled with -inf.
extern "C" int repro_block_sparse_attn_single(
    const void* q, const void* k, const void* v, const int* indices,
    const int* counts, void* out, float* stats, int dtype, int H, int Hkv,
    int N, int D, int Dv, int bs, int W, int causal, void* stream) {
  const Args a{q, k, v, nullptr, indices, counts, nullptr, out, stats,
               {1, H, Hkv, N, N / bs, W, 0, causal, 0}};
  return dispatch<SINGLE>(dtype, bs, D, Dv, a, stream);
}
