// Block-sparse prefill attention with fused block-mean QK stats: one kernel
// body, three instances.
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
// nothing visited write zeros.
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
// bitwise the BATCHED instance run on the gathered pages.  A page id outside
// [0, P) is never read: its block is skipped.
// SINGLE is the reference's single-sample oracle kernel: B = 1, offset 0,
// a uniform n = min(counts, W) steps per row with no causal bound, no stats
// gate, and compact stats: step w of the row writes stats[h, row, w] (the
// wrapper fills -inf, which stays for w >= n).  A listed block above the
// diagonal is visited, contributes nothing to the output and gets -inf.
//
// Bound on an H100: the products, 4 * bs^2 * D flops per visited block.  One
// llama3-8b layer at N = 8192, B = 2 and ~0.93 block density visits ~124k
// blocks of 8.4 MFLOP each, ~1 TFLOP, 1.05 ms at the bf16 tensor-core rate,
// far above its bytes (q, out, K and V once: ~0.34 GB, 0.1 ms).  This first
// version runs the products on CUDA cores in float32, so it is bound by
// those operations at a lower rate; wgmma/TMA are later work.
// Design: one CTA per (row, h, b), 2 * bs threads; the Q tile stays in
// shared memory in float32; each kv block streams through in 32-key
// sub-tiles (K, V and the probabilities P in shared memory, ~116 KB of
// dynamic shared memory at bs = D = 128); each thread owns 4 query rows x 4
// keys of S and 4 rows x D/8 columns of the output accumulator in registers.
// The online-softmax guards are those of the TPU kernel: alpha = 0 while the
// running max is -inf, p = 0 off the mask, and denominator max(l, 1e-30).
#include "common.cuh"

namespace {

constexpr int KT = 32;   // keys per sub-tile

enum Mode { BATCHED = 0, PAGED = 1, SINGLE = 2 };

struct Dims {
  int B, H, Hkv, N, NBkv, W, q_block_offset, causal, P;
};

// Everything a launch needs.  k / v are (B, Hkv, NBkv * bs, D) for BATCHED
// and SINGLE and the pools (P, Hkv, bs, D) for PAGED; stats is a_tilde
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

// The pointers stay __restrict__ kernel parameters (read-only loads).
template <typename T, int BQ, int D, int MODE>
__global__ void __launch_bounds__(2 * BQ)
bsa_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const int* __restrict__ page_table,
           const int* __restrict__ indices, const int* __restrict__ counts,
           const int* __restrict__ gate, T* __restrict__ out,
           float* __restrict__ stats, Dims a, float scale) {
  constexpr int NT = 2 * BQ;          // threads
  constexpr int QS = D + 1;           // padded row stride of Q and K tiles
  constexpr int PS = KT + 1;          // padded row stride of P
  constexpr int DC = D / 8;           // output columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;                  // BQ x QS
  float* k_s = q_s + BQ * QS;         // KT x QS
  float* v_s = k_s + KT * QS;         // KT x D
  float* p_s = v_s + KT * D;          // BQ x PS
  __shared__ float red_sum[NT / 32], red_cnt[NT / 32];

  const int H = a.H, W = a.W, NBkv = a.NBkv;
  const int NBq = a.N / BQ;
  const int row = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;
  const int hk = h / (H / a.Hkv);
  const size_t bh = (size_t)b * H + h;
  const size_t trow = bh * NBq + row;  // table row
  const T* qb = q + (bh * a.N + (size_t)row * BQ) * D;
  // K/V of this (batch, kv head) in the contiguous instances
  const size_t kv0 = ((size_t)b * a.Hkv + hk) * (size_t)NBkv * BQ * D;

  int n;
  if constexpr (MODE == SINGLE) {
    n = min(counts[trow], W);         // uniform W steps, no causal bound
  } else {
    // the TPU kernel's ragged schedule gave this row min(causal bound, W)
    // steps; visiting min(counts, steps) keeps its exact semantics
    int steps = a.causal ? min(a.q_block_offset + row + 1, W) : W;
    steps = max(1, min(steps, NBkv));
    n = min(counts[trow], steps);
  }
  bool emit;
  if constexpr (MODE == SINGLE) emit = true;
  else emit = gate[bh] != 0;

  for (int i = tid; i < BQ * D; i += NT)
    q_s[(i / D) * QS + (i % D)] = repro::to_f(qb[i]);

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
    // K/V rows from the base kb / vb: the cache's (row j * bs on) or the
    // block's page (row 0 on)
    const T* kb = k + kv0;
    const T* vb = v + kv0;
    size_t jrow = (size_t)j * BQ;
    if constexpr (MODE == PAGED) {
      const int page = page_table[(size_t)b * NBkv + j];
      if (page < 0 || page >= a.P) continue;    // uniform across the CTA
      const size_t tile = ((size_t)page * a.Hkv + hk) * (size_t)BQ * D;
      kb = k + tile;
      vb = v + tile;
      jrow = 0;
    }
    float s_sum = 0.f, s_cnt = 0.f;
    for (int t0 = 0; t0 < BQ; t0 += KT) {
      __syncthreads();                // previous sub-tile fully consumed
      for (int i = tid; i < KT * D; i += NT) {
        int r = i / D, c = i - r * D;
        size_t off = (jrow + t0 + r) * D + c;
        k_s[r * QS + c] = repro::to_f(kb[off]);
        v_s[r * D + c] = repro::to_f(vb[off]);
      }
      __syncthreads();

      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[i][c] = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
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
          const float vv = v_s[kk * D + tx + 8 * c];
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
    T* ob = out + (bh * a.N + (size_t)row * BQ + 4 * ty + i) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      ob[tx + 8 * c] = repro::from_f<T>(acc[i][c] * inv);
  }
}

template <typename T, int BQ, int D, int MODE>
int launch(const Args& a, void* stream) {
  constexpr int QS = D + 1;
  const size_t smem =
      (size_t)(BQ * QS + KT * QS + KT * D + BQ * (KT + 1)) * sizeof(float);
  cudaFuncSetAttribute(bsa_kernel<T, BQ, D, MODE>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  dim3 grid(a.d.N / BQ, a.d.H, a.d.B);
  bsa_kernel<T, BQ, D, MODE><<<grid, 2 * BQ, smem, (cudaStream_t)stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, a.page_table, a.indices,
      a.counts, a.gate, (T*)a.out, a.stats, a.d, 1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

template <typename T, int MODE>
int by_shape(int bs, int D, const Args& a, void* stream) {
  if (bs == 128 && D == 128) return launch<T, 128, 128, MODE>(a, stream);
  if (bs == 64 && D == 128) return launch<T, 64, 128, MODE>(a, stream);
  if (bs == 128 && D == 64) return launch<T, 128, 64, MODE>(a, stream);
  if (bs == 64 && D == 64) return launch<T, 64, 64, MODE>(a, stream);
  return (int)cudaErrorInvalidValue;
}

template <int MODE>
int dispatch(int dtype, int bs, int D, const Args& a, void* stream) {
  if (dtype == REPRO_BF16)
    return by_shape<__nv_bfloat16, MODE>(bs, D, a, stream);
  return by_shape<float, MODE>(bs, D, a, stream);
}

}  // namespace

// q (B, H, N, D); k / v (B, Hkv, Nkv, D); tables (B, H, N / bs, W);
// gate (B, H); a_tilde (B, H, N / bs, Nkv / bs), filled with -inf.
extern "C" int repro_block_sparse_attn(
    const void* q, const void* k, const void* v, const int* indices,
    const int* counts, const int* gate, void* out, float* a_tilde, int dtype,
    int B, int H, int Hkv, int N, int Nkv, int D, int bs, int W,
    int q_block_offset, int causal, void* stream) {
  const Args a{q, k, v, nullptr, indices, counts, gate, out, a_tilde,
               {B, H, Hkv, N, Nkv / bs, W, q_block_offset, causal, 0}};
  return dispatch<BATCHED>(dtype, bs, D, a, stream);
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
  return dispatch<PAGED>(dtype, bs, D, a, stream);
}

// q (H, N, D); k / v (Hkv, N, D); tables (H, N / bs, W); stats (H, N / bs,
// W), filled with -inf.
extern "C" int repro_block_sparse_attn_single(
    const void* q, const void* k, const void* v, const int* indices,
    const int* counts, void* out, float* stats, int dtype, int H, int Hkv,
    int N, int D, int bs, int W, int causal, void* stream) {
  const Args a{q, k, v, nullptr, indices, counts, nullptr, out, stats,
               {1, H, Hkv, N, N / bs, W, 0, causal, 0}};
  return dispatch<SINGLE>(dtype, bs, D, a, stream);
}
