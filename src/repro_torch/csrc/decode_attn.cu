// GQA flash decode: one kernel body, four instances.
//
// Replaces the TPU kernels of repro/kernels/decode_attn.py:
//   PLAN        flash_decode_sparse_batched (_batched_kernel)
//   PAGED       flash_decode_sparse_batched_paged (_paged_kernel)
//   MASK_DENSE  flash_decode (_kernel)
//   MASK_TABLE  flash_decode_sparse (_sparse_kernel)
// PLAN and PAGED decode over DecodePlan tables.  One query token per
// sequence: for every (batch b, kv head h) the CTA holds the G query vectors
// of that kv head's group and walks indices[b, h, :counts[b, h]]; in block
// j, key t is visible to query head g only if keep_heads[b, h, j, g] and
// valid[b, j * bs + t].  Online softmax with the TPU kernel's -inf-safe max
// (a fully masked step leaves the state untouched), and a slot with
// counts == 0 writes exact zeros (the inert-slot contract).
//
// Bound on an H100: bytes.  Each visited block's K and V are read once
// (2 * bs * D elements) for 4 * G * bs * D flops, far below the card's
// ~295 flops per byte in bf16; the cache read at the memory rate is the
// bound.  Design: the plan is built once per batch, so the CTA reads its
// table row directly (no per-step argsort) and streams K/V in 32-key tiles
// through shared memory with coalesced loads; warp g computes head g's 32
// logits and its softmax update, and every thread owns one (or two) output
// columns of all G heads.  The grid is only B * Hkv CTAs (16 for llama3-8b
// at B = 2), far too few to saturate the memory system: splitting the table
// across CTAs (split-K) is later work.
//
// Paged instance (PAGED): K/V live in a pool (P, Hkv, ps, D) and the
// tile of table entry j for slot b, kv head hk starts at
// pool + ((page_table[b * NB + j] * Hkv + hk) * ps) * D, in size_t (a whole
// pool comes near 2^31 elements).  That address is the only difference: the
// body, the keep bits, validity, counts and the running max stay in logical
// coordinates, so the paged instance is bitwise the contiguous one run on
// the gathered pages.  A page id outside [0, P) is never read: its block is
// skipped.
//
// Token-mask instances (MASK_DENSE, MASK_TABLE): the reference's single-
// sample kernels take a per-(query head, token) mask (H, S) instead of keep
// bits x slot validity; key t of block j is visible to head g of kv head hk
// only if mask[b, hk * G + g, j * bs + t] (uint8).  MASK_DENSE walks all
// S / bs blocks in order; MASK_TABLE walks the per-kv-head union table that
// the wrapper stages on the device (the reference's argsort of the blocks
// with any kept token, padded with the last id).  A head whose mask is all
// false writes exact zeros, by the same -inf-safe max.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int KT = 32;     // keys per tile (one per lane)
constexpr int NT = 128;    // threads
constexpr int GMAX = 8;    // largest GQA group
constexpr int DMAX = 256;  // largest head dim (two columns per thread)

enum Mode { PLAN = 0, PAGED = 1, MASK_DENSE = 2, MASK_TABLE = 3 };

// keep / valid are read by PLAN and PAGED, mask by MASK_DENSE and
// MASK_TABLE, indices / counts by all but MASK_DENSE, page_table by PAGED.
template <typename T, int MODE>
__global__ void __launch_bounds__(NT)
decode_kernel(const T* __restrict__ q, const T* __restrict__ ck,
              const T* __restrict__ cv, const int* __restrict__ page_table,
              const int* __restrict__ indices,
              const int* __restrict__ counts,
              const uint8_t* __restrict__ keep,
              const uint8_t* __restrict__ valid,
              const uint8_t* __restrict__ mask, T* __restrict__ out, int H,
              int Hkv, int S, int D, int NB, int W, int P, float scale) {
  constexpr bool BY_PLAN = MODE == PLAN || MODE == PAGED;
  extern __shared__ float smem[];
  const int G = H / Hkv;
  float* q_s = smem;                    // G x D
  float* k_s = q_s + G * D;             // KT x (D + 1)
  float* v_s = k_s + KT * (D + 1);      // KT x D
  float* p_s = v_s + KT * D;            // G x KT
  __shared__ float m_s[GMAX], l_s[GMAX], alpha_s[GMAX];
  __shared__ int keep_s[GMAX];

  const int hk = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bs = S / NB;
  const size_t bk = (size_t)b * Hkv + hk;
  const uint8_t* vrow = BY_PLAN ? valid + (size_t)b * S : nullptr;
  // the token mask's rows of this kv head's G query heads
  const uint8_t* mrow =
      BY_PLAN ? nullptr : mask + ((size_t)b * H + (size_t)hk * G) * S;

  for (int i = tid; i < G * D; i += NT)
    q_s[i] = repro::to_f(q[((size_t)b * H + (size_t)hk * G) * D + i]);
  if (tid < G) { m_s[tid] = -CUDART_INF_F; l_s[tid] = 0.f; }
  float acc[GMAX][2];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) { acc[g][0] = 0.f; acc[g][1] = 0.f; }

  const int n = MODE == MASK_DENSE ? NB : counts[bk];
  for (int w = 0; w < n; ++w) {
    const int j = MODE == MASK_DENSE ? w : indices[bk * W + w];
    // the block's first key, in the cache or in its page
    size_t tile;
    if constexpr (MODE == PAGED) {
      const int page = page_table[(size_t)b * NB + j];
      if (page < 0 || page >= P) continue;    // uniform across the CTA
      tile = ((size_t)page * Hkv + hk) * (size_t)bs * D;
    } else {
      tile = (bk * (size_t)S + (size_t)j * bs) * D;
    }
    const T* kb = ck + tile;
    const T* vb = cv + tile;
    for (int t0 = 0; t0 < bs; t0 += KT) {
      __syncthreads();                  // previous tile fully consumed
      if (BY_PLAN && t0 == 0 && tid < G)
        keep_s[tid] = keep[(bk * NB + j) * G + tid];
      for (int i = tid; i < KT * D; i += NT) {
        int r = i / D, c = i - r * D;
        size_t off = (size_t)(t0 + r) * D + c;
        k_s[r * (D + 1) + c] = repro::to_f(kb[off]);
        v_s[r * D + c] = repro::to_f(vb[off]);
      }
      __syncthreads();
      const int key = j * bs + t0 + lane;
      const bool tok = BY_PLAN ? vrow[key] != 0 : false;
      for (int g = warp; g < G; g += NT / 32) {
        float s = 0.f;
        for (int d = 0; d < D; ++d)
          s = fmaf(q_s[g * D + d], k_s[lane * (D + 1) + d], s);
        s *= scale;
        const bool ok = BY_PLAN ? tok && keep_s[g] != 0
                                : mrow[(size_t)g * S + key] != 0;
        const float mx = repro::group_max<32>(ok ? s : -CUDART_INF_F);
        const float m_prev = m_s[g];
        const float m_new = fmaxf(m_prev, mx);
        const float safe = (m_new == -CUDART_INF_F) ? 0.f : m_new;
        const float alpha = (m_prev == -CUDART_INF_F) ? 0.f
                                                      : expf(m_prev - safe);
        const float p = ok ? expf(s - safe) : 0.f;
        p_s[g * KT + lane] = p;
        const float ps = repro::group_sum<32>(p);
        __syncwarp();
        if (lane == 0) {
          l_s[g] = l_s[g] * alpha + ps;
          m_s[g] = m_new;
          alpha_s[g] = alpha;
        }
      }
      __syncthreads();
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int d = tid + c * NT;
        if (d >= D) break;
#pragma unroll
        for (int g = 0; g < GMAX; ++g) {
          if (g >= G) break;
          float a = acc[g][c] * alpha_s[g];
          for (int kk = 0; kk < KT; ++kk)
            a = fmaf(p_s[g * KT + kk], v_s[kk * D + d], a);
          acc[g][c] = a;
        }
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int d = tid + c * NT;
    if (d >= D) break;
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g >= G) break;
      out[((size_t)b * H + (size_t)hk * G + g) * D + d] =
          repro::from_f<T>(acc[g][c] / fmaxf(l_s[g], 1e-30f));
    }
  }
}

template <typename T, int MODE>
int launch(const void* q, const void* ck, const void* cv,
           const int* page_table, const int* indices, const int* counts,
           const uint8_t* keep, const uint8_t* valid, const uint8_t* mask,
           void* out, int B, int H, int Hkv, int S, int D, int NB, int W,
           int P, void* stream) {
  const int G = H / Hkv;
  const size_t smem =
      (size_t)(G * D + KT * (D + 1) + KT * D + G * KT) * sizeof(float);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(decode_kernel<T, MODE>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  dim3 grid(Hkv, B);
  decode_kernel<T, MODE><<<grid, NT, smem, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)ck, (const T*)cv, page_table, indices, counts,
      keep, valid, mask, (T*)out, H, Hkv, S, D, NB, W, P,
      1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

template <int MODE>
int dispatch(const void* q, const void* ck, const void* cv,
             const int* page_table, const int* indices, const int* counts,
             const uint8_t* keep, const uint8_t* valid, const uint8_t* mask,
             void* out, int dtype, int B, int H, int Hkv, int S, int D,
             int NB, int W, int P, void* stream) {
  if (H % Hkv || H / Hkv > GMAX || D > DMAX || S % NB || (S / NB) % KT)
    return (int)cudaErrorInvalidValue;
  if (dtype == REPRO_BF16)
    return launch<__nv_bfloat16, MODE>(q, ck, cv, page_table, indices,
                                       counts, keep, valid, mask, out, B, H,
                                       Hkv, S, D, NB, W, P, stream);
  return launch<float, MODE>(q, ck, cv, page_table, indices, counts, keep,
                             valid, mask, out, B, H, Hkv, S, D, NB, W, P,
                             stream);
}

}  // namespace

extern "C" int repro_decode_attn(const void* q, const void* ck,
                                 const void* cv, const int* indices,
                                 const int* counts, const uint8_t* keep,
                                 const uint8_t* valid, void* out, int dtype,
                                 int B, int H, int Hkv, int S, int D, int NB,
                                 int W, void* stream) {
  return dispatch<PLAN>(q, ck, cv, nullptr, indices, counts, keep, valid,
                        nullptr, out, dtype, B, H, Hkv, S, D, NB, W, 0,
                        stream);
}

// pool_k / pool_v: one layer's (P, Hkv, ps, D) pool; page_table (B, NB);
// the plan and valid (B, NB * ps) in logical block coordinates.
extern "C" int repro_decode_attn_paged(const void* q, const void* pool_k,
                                       const void* pool_v,
                                       const int* page_table,
                                       const int* indices, const int* counts,
                                       const uint8_t* keep,
                                       const uint8_t* valid, void* out,
                                       int dtype, int B, int H, int Hkv,
                                       int ps, int D, int NB, int W, int P,
                                       void* stream) {
  return dispatch<PAGED>(q, pool_k, pool_v, page_table, indices, counts,
                         keep, valid, nullptr, out, dtype, B, H, Hkv, NB * ps,
                         D, NB, W, P, stream);
}

// q (B, H, D); cache_k / cache_v (B, Hkv, S, D); mask (B, H, S) uint8 with
// S = NB * bs.  table = 0 walks every block (flash_decode); table = 1 walks
// indices[b, hk, :counts[b, hk]] of the (B, Hkv, NB) union table
// (flash_decode_sparse).
extern "C" int repro_decode_attn_mask(const void* q, const void* ck,
                                      const void* cv, const int* indices,
                                      const int* counts, const uint8_t* mask,
                                      void* out, int dtype, int B, int H,
                                      int Hkv, int S, int D, int NB,
                                      int table, void* stream) {
  if (table)
    return dispatch<MASK_TABLE>(q, ck, cv, nullptr, indices, counts, nullptr,
                                nullptr, mask, out, dtype, B, H, Hkv, S, D,
                                NB, NB, 0, stream);
  return dispatch<MASK_DENSE>(q, ck, cv, nullptr, nullptr, nullptr, nullptr,
                              nullptr, mask, out, dtype, B, H, Hkv, S, D, NB,
                              NB, 0, stream);
}
