// GQA flash decode, split-K: one kernel body, four instances, and a combine.
//
// Replaces the TPU kernels of repro/kernels/decode_attn.py:
//   PLAN        flash_decode_sparse_batched (_batched_kernel)
//   PAGED       flash_decode_sparse_batched_paged (_paged_kernel)
//   MASK_DENSE  flash_decode (_kernel)
//   MASK_TABLE  flash_decode_sparse (_sparse_kernel)
// PLAN and PAGED decode over DecodePlan tables.  One query token per
// sequence: for every (batch b, kv head h) the G query vectors of that kv
// head's group attend over indices[b, h, :counts[b, h]]; in block j, key t
// is visible to query head g only if keep_heads[b, h, j, g] and
// valid[b, j * bs + t].  Online softmax with the TPU kernel's -inf-safe max
// (a fully masked step leaves the state untouched), and a slot with
// counts == 0 writes exact zeros (the inert-slot contract).
//
// Bound on an H100: bytes.  Each visited block's K and V are read once
// (2 * bs * D elements) for 4 * G * bs * D flops, far below the card's
// ~295 flops per byte in bf16; the cache read at the memory rate is the
// bound, so the design keeps enough bytes in flight:
//   * Split-K.  The grid is (splits, Hkv, B).  A (b, kv head) row's n
//     table entries (n = counts, or NB for MASK_DENSE) are n * bs / 32
//     tiles of 32 keys; split c takes the contiguous tiles [c * N / splits,
//     (c + 1) * N / splits) of those N, so chunks differ by at most one
//     tile and a chunk may be empty.  The wrapper picks `splits` from
//     (B, Hkv, NB) and the SM count (kernels/decode_attn.py::decode_splits),
//     the same rule for every instance; never from the table width W, so
//     a row's split stays when a refresh narrows the table.  Each split keeps the G query heads
//     of its kv head together (K/V read once for the group) and writes a
//     partial (m, l, acc) per query head to scratch: an empty chunk writes
//     (-inf, 0, 0).
//   * decode_combine_kernel merges a row's partials in split order under
//     the same -inf-safe rule: each partial weighs exp(m_s - M) against the
//     largest partial max M, a partial at -inf weighs 0, and the sum is
//     divided by max(l, 1e-30), so an empty slot and an all-false head
//     (every M = -inf) still write exact zeros.  No atomics: the result
//     does not depend on which CTA finishes first.
//   * K/V stream through a three-stage shared-memory ring of 32-key tiles
//     in their own type, as 16-byte cp.async vectors: two tiles are in
//     flight while one is computed.  A key's logit takes 16 lanes (one
//     16-byte vector each, the lane's slice of the G query vectors held in
//     registers) and a shuffle reduction; warp g then runs head g's
//     softmax over the tile's 32 keys (one per lane); for P V each thread
//     owns two output columns of every head over a contiguous share of the
//     tile's keys (P read as float4), summed across threads once at the
//     end.  G is padded to a power of 2 at compile time so that the
//     per-head loops unroll without branches and the heads' dependency
//     chains interleave: at decode sizes the body's compute latency, not
//     its loads, is what this saves.  GP runs up to 16 (mistral-large's
//     G = 12); at GP = 16 a logit lane holds 16 query slices of one
//     16-byte vector (128 registers at D = 128 in bfloat16), and ptxas's
//     report (<stem>.ptxas.txt beside the library) shows what spills.
//
// Paged instance (PAGED): K/V live in a pool (P, Hkv, ps, D) and the
// tile of table entry j for slot b, kv head hk starts at
// pool + ((page_table[b * NB + j] * Hkv + hk) * ps) * D, in size_t (a whole
// pool comes near 2^31 elements).  That address is the only difference: the
// split, the body, the keep bits, validity, counts and the running max stay
// in logical coordinates, so the paged instance is bitwise the contiguous
// one run on the gathered pages.  A page id outside [0, P) is never read:
// its block is skipped.
//
// Head slices (PLAN and PAGED): the K/V addresses step over Hc heads per
// batch row (per page), Hc >= Hkv, so a launch reads kv heads
// [h0, h0 + Hkv) of a cache or pool of Hc heads in place, its pointers at
// head h0 (a head shard of a heads-sharded serve).  Only the K/V address
// sees Hc; the plan, the split and the output are the launch's own.
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

constexpr int KT = 32;     // keys per tile (one per lane in the softmax)
constexpr int STAGES = 3;  // tiles in the shared-memory ring
constexpr int NT = 128;    // threads
constexpr int NW = NT / 32;
constexpr int LPK = 16;    // lanes per key in the logit dot product
constexpr int GMAX = 16;   // largest GQA group
constexpr int DMAX = 256;  // largest head dim

enum Mode { PLAN = 0, PAGED = 1, MASK_DENSE = 2, MASK_TABLE = 3 };

// Key groups of P V: the largest power of 2 <= min(NT / (D / 2), 8), so
// that each group's share of a tile is a multiple of 4 keys.
__host__ __device__ inline int key_groups(int D) {
  int kh = 1;
  while (kh * 2 <= NT / (D / 2) && kh < 8) kh *= 2;
  return kh;
}

// 16-byte vectors of T widened to float, and pairs of adjacent elements.
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float (&f)[8]) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    f[0] = x.x; f[1] = x.y; f[2] = x.z; f[3] = x.w;
  }
  __device__ static float2 pair(const float* p) {
    return *reinterpret_cast<const float2*>(p);
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* p, float (&f)[8]) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
  __device__ static float2 pair(const __nv_bfloat16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
};

// keep / valid are read by PLAN and PAGED, mask by MASK_DENSE and
// MASK_TABLE, indices / counts by all but MASK_DENSE, page_table by PAGED.
// Partials: part_m / part_l (B, H, splits), part_acc (B, H, splits, D).
// GP: the group size G padded to a power of 2 (heads G..GP-1 compute on
// zero queries and are never written), so that the per-head loops unroll
// without branches; CH: 16-byte vectors of a key row per logit lane
// (D * sizeof(T) <= CH * LPK * 16).
template <typename T, int MODE, int GP, int CH>
__global__ void __launch_bounds__(NT)
decode_kernel(const T* __restrict__ q, const T* __restrict__ ck,
              const T* __restrict__ cv, const int* __restrict__ page_table,
              const int* __restrict__ indices,
              const int* __restrict__ counts,
              const uint8_t* __restrict__ keep,
              const uint8_t* __restrict__ valid,
              const uint8_t* __restrict__ mask, float* __restrict__ part_m,
              float* __restrict__ part_l, float* __restrict__ part_acc,
              int H, int Hkv, int Hc, int S, int D, int NB, int W, int P,
              float scale) {
  constexpr bool BY_PLAN = MODE == PLAN || MODE == PAGED;
  constexpr int VEC = Vec<T>::N;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int G = H / Hkv;
  const int tile_elems = KT * D;
  float* p_s = reinterpret_cast<float*>(smem_raw);          // GP x KT
  T* kv_s = reinterpret_cast<T*>(p_s + GP * KT);            // STAGES x (K, V)
  __shared__ float m_s[GMAX], l_s[GMAX], alpha_s[GMAX];

  const int split = blockIdx.x, splits = gridDim.x;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bs = S / NB;
  const int tpb = bs / KT;                    // tiles per block
  const size_t bk = (size_t)b * Hkv + hk;
  const size_t ckv = (size_t)b * Hc + hk;      // the K/V row's head
  const size_t head0 = (size_t)b * H + (size_t)hk * G;   // first query head
  const uint8_t* vrow = BY_PLAN ? valid + (size_t)b * S : nullptr;
  // the token mask's rows of this kv head's G query heads
  const uint8_t* mrow = BY_PLAN ? nullptr : mask + head0 * S;

  // this split's contiguous share of the row's tiles: n table entries of
  // tpb tiles each
  const int n = (MODE == MASK_DENSE ? NB : counts[bk]) * tpb;
  const int tb = (int)((long long)split * n / splits);
  const int ntiles = (int)((long long)(split + 1) * n / splits) - tb;

  // tile i of the chunk: its block id and first key, and its K/V source;
  // false for a block on a page outside [0, P) (uniform across the CTA)
  auto source = [&](int i, int& j, int& t0, size_t& off) -> bool {
    const int w = (tb + i) / tpb;
    t0 = ((tb + i) % tpb) * KT;
    j = MODE == MASK_DENSE ? w : indices[bk * W + w];
    if constexpr (MODE == PAGED) {
      const int page = page_table[(size_t)b * NB + j];
      if (page < 0 || page >= P) return false;
      off = (((size_t)page * Hc + hk) * (size_t)bs + t0) * D;
    } else {
      off = (ckv * (size_t)S + (size_t)j * bs + t0) * D;
    }
    return true;
  };
  // the KT rows of a tile are contiguous: KT * D elements of K and of V
  auto prefetch = [&](int i) {
    int j, t0;
    size_t off;
    if (i < ntiles && source(i, j, t0, off)) {
      T* ks = kv_s + (size_t)(i % STAGES) * 2 * tile_elems;
      T* vs = ks + tile_elems;
      for (int c = tid; c < tile_elems / VEC; c += NT) {
        repro::cp_async16(ks + c * VEC, ck + off + (size_t)c * VEC);
        repro::cp_async16(vs + c * VEC, cv + off + (size_t)c * VEC);
      }
    }
    repro::cp_async_commit();    // one group per tile, empty or not
  };

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) prefetch(i);
  if (tid < G) { m_s[tid] = -CUDART_INF_F; l_s[tid] = 0.f; }

  // logits: lane lk of a key's LPK lanes takes the key row's 16-byte
  // vectors lk, lk + LPK, ...; its slice of the GP query vectors stays in
  // registers
  const int nvk = D / VEC;                   // 16-byte vectors per key
  const int lk = lane % LPK;
  float qr[GP][CH * VEC];
#pragma unroll
  for (int g = 0; g < GP; ++g)
#pragma unroll
    for (int x = 0; x < CH; ++x) {
      const int c = lk + x * LPK;
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        qr[g][x * VEC + e] =
            g < G && c < nvk ? repro::to_f(q[(head0 + g) * D + c * VEC + e])
                             : 0.f;
    }

  // P V: thread (column pair cp, key group kh) of KH groups takes the KPG
  // keys [kh * KPG, (kh + 1) * KPG) of each tile
  const int KH = key_groups(D);
  const int KPG = KT / KH;
  const int cp = tid % (D / 2), kh = tid / (D / 2);
  float acc[GP][2];
#pragma unroll
  for (int g = 0; g < GP; ++g) { acc[g][0] = 0.f; acc[g][1] = 0.f; }

  for (int i = 0; i < ntiles; ++i) {
    repro::cp_async_wait<STAGES - 2>();
    __syncthreads();              // tile i landed; tile i - 1 fully consumed
    prefetch(i + STAGES - 1);        // into tile i - 1's stage
    int j, t0;
    size_t off;
    if (!source(i, j, t0, off)) continue;
    const T* ks = kv_s + (size_t)(i % STAGES) * 2 * tile_elems;
    const T* vs = ks + tile_elems;

    // logits: LPK lanes per key, NW * 32 / LPK keys per pass
    for (int key = warp * (32 / LPK) + lane / LPK; key < KT;
         key += NW * (32 / LPK)) {
      float part[GP];
#pragma unroll
      for (int g = 0; g < GP; ++g) part[g] = 0.f;
#pragma unroll
      for (int x = 0; x < CH; ++x) {
        const int c = lk + x * LPK;
        if (c < nvk) {
          float kf[8];
          Vec<T>::load(ks + key * D + c * VEC, kf);
#pragma unroll
          for (int g = 0; g < GP; ++g)
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              part[g] = fmaf(qr[g][x * VEC + e], kf[e], part[g]);
        }
      }
#pragma unroll
      for (int g = 0; g < GP; ++g) part[g] = repro::group_sum<LPK>(part[g]);
      if (lk == 0) {
#pragma unroll
        for (int g = 0; g < GP; ++g) p_s[g * KT + key] = part[g] * scale;
      }
    }
    __syncthreads();

    // softmax: warp g takes head g, one key per lane
    const int kpos = j * bs + t0 + lane;
    const bool tok = BY_PLAN ? vrow[kpos] != 0 : false;
    for (int g = warp; g < G; g += NW) {
      const float s = p_s[g * KT + lane];
      const bool ok = BY_PLAN ? tok && keep[(bk * NB + j) * G + g] != 0
                              : mrow[(size_t)g * S + kpos] != 0;
      const float mx = repro::group_max<32>(ok ? s : -CUDART_INF_F);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      const float safe = (m_new == -CUDART_INF_F) ? 0.f : m_new;
      const float alpha = (m_prev == -CUDART_INF_F) ? 0.f
                                                    : expf(m_prev - safe);
      const float p = ok ? expf(s - safe) : 0.f;
      p_s[g * KT + lane] = p;
      const float ps = repro::group_sum<32>(p);
      if (lane == 0) {
        l_s[g] = l_s[g] * alpha + ps;
        m_s[g] = m_new;
        alpha_s[g] = alpha;
      }
    }
    __syncthreads();

    // P V over this thread's keys
    if (kh < KH) {
#pragma unroll
      for (int g = 0; g < GP; ++g) {
        const float al = g < G ? alpha_s[g] : 0.f;
        acc[g][0] *= al;
        acc[g][1] *= al;
      }
      for (int k0 = kh * KPG; k0 < (kh + 1) * KPG; k0 += 4) {
        float2 vv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          vv[u] = Vec<T>::pair(vs + (k0 + u) * D + 2 * cp);
#pragma unroll
        for (int g = 0; g < GP; ++g) {
          const float4 p = *reinterpret_cast<const float4*>(p_s + g * KT + k0);
          float a0 = acc[g][0], a1 = acc[g][1];
          a0 = fmaf(p.x, vv[0].x, a0); a1 = fmaf(p.x, vv[0].y, a1);
          a0 = fmaf(p.y, vv[1].x, a0); a1 = fmaf(p.y, vv[1].y, a1);
          a0 = fmaf(p.z, vv[2].x, a0); a1 = fmaf(p.z, vv[2].y, a1);
          a0 = fmaf(p.w, vv[3].x, a0); a1 = fmaf(p.w, vv[3].y, a1);
          acc[g][0] = a0;
          acc[g][1] = a1;
        }
      }
    }
  }
  repro::cp_async_wait<0>();
  __syncthreads();

  // sum the KH key groups (in the tile buffers) and write the partials
  float* red = reinterpret_cast<float*>(kv_s);               // KH x G x D
  if (kh < KH) {
#pragma unroll
    for (int g = 0; g < GP; ++g) {
      if (g < G) {
        red[((size_t)kh * G + g) * D + 2 * cp] = acc[g][0];
        red[((size_t)kh * G + g) * D + 2 * cp + 1] = acc[g][1];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += NT) {
    const int g = i / D, d = i - g * D;
    float a = 0.f;
    for (int x = 0; x < KH; ++x) a += red[((size_t)x * G + g) * D + d];
    part_acc[((head0 + g) * splits + split) * D + d] = a;
  }
  if (tid < G) {
    part_m[(head0 + tid) * splits + split] = m_s[tid];
    part_l[(head0 + tid) * splits + split] = l_s[tid];
  }
}

// One CTA per (b, query head): merge the splits' partials in split order.
// MODE names the instance in profiles; the merge is the same for all.
template <typename T, int MODE>
__global__ void __launch_bounds__(NT)
decode_combine_kernel(const float* __restrict__ part_m,
                      const float* __restrict__ part_l,
                      const float* __restrict__ part_acc, T* __restrict__ out,
                      int splits, int D) {
  const size_t row = blockIdx.x;
  const float* pm = part_m + row * splits;
  const float* pl = part_l + row * splits;
  const float* pa = part_acc + row * splits * D;
  float m = -CUDART_INF_F;
#pragma unroll 8
  for (int s = 0; s < splits; ++s) m = fmaxf(m, pm[s]);
  for (int d = threadIdx.x; d < D; d += NT) {
    float l = 0.f, a = 0.f;
    if (m != -CUDART_INF_F) {
#pragma unroll 8
      for (int s = 0; s < splits; ++s) {
        const float ms = pm[s];
        const float w = (ms == -CUDART_INF_F) ? 0.f : expf(ms - m);
        l = fmaf(pl[s], w, l);
        a = fmaf(pa[(size_t)s * D + d], w, a);
      }
    }
    out[row * D + d] = repro::from_f<T>(a / fmaxf(l, 1e-30f));
  }
}

template <typename T, int MODE, int GP, int CH>
int launch(const void* q, const void* ck, const void* cv,
           const int* page_table, const int* indices, const int* counts,
           const uint8_t* keep, const uint8_t* valid, const uint8_t* mask,
           float* part, void* out, int B, int H, int Hkv, int Hc, int S,
           int D, int NB, int W, int P, int splits, void* stream) {
  const int G = H / Hkv;
  const size_t tiles = (size_t)STAGES * 2 * KT * D * sizeof(T);
  const size_t red = (size_t)key_groups(D) * G * D * sizeof(float);
  const size_t smem =
      (size_t)GP * KT * sizeof(float) + (tiles > red ? tiles : red);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_kernel<T, MODE, GP, CH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const size_t rows = (size_t)B * H * splits;
  float* part_m = part;
  float* part_l = part + rows;
  float* part_acc = part + 2 * rows;
  cudaStream_t st = (cudaStream_t)stream;
  decode_kernel<T, MODE, GP, CH><<<dim3(splits, Hkv, B), NT, smem, st>>>(
      (const T*)q, (const T*)ck, (const T*)cv, page_table, indices, counts,
      keep, valid, mask, part_m, part_l, part_acc, H, Hkv, Hc, S, D, NB, W,
      P, 1.0f / sqrtf((float)D));
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  decode_combine_kernel<T, MODE><<<B * H, NT, 0, st>>>(
      part_m, part_l, part_acc, (T*)out, splits, D);
  return (int)cudaGetLastError();
}

// The instance for T: CH from D, GP from G.
template <typename T, int MODE, int CH>
int by_group(int G, const void* q, const void* ck, const void* cv,
             const int* page_table, const int* indices, const int* counts,
             const uint8_t* keep, const uint8_t* valid, const uint8_t* mask,
             float* part, void* out, int B, int H, int Hkv, int Hc, int S,
             int D, int NB, int W, int P, int splits, void* stream) {
#define REPRO_LAUNCH(GP)                                                    \
  return launch<T, MODE, GP, CH>(q, ck, cv, page_table, indices, counts,    \
                                 keep, valid, mask, part, out, B, H, Hkv,   \
                                 Hc, S, D, NB, W, P, splits, stream)
  if (G == 1) REPRO_LAUNCH(1);
  if (G == 2) REPRO_LAUNCH(2);
  if (G <= 4) REPRO_LAUNCH(4);
  if (G <= 8) REPRO_LAUNCH(8);
  REPRO_LAUNCH(16);
#undef REPRO_LAUNCH
}

template <int MODE>
int dispatch(const void* q, const void* ck, const void* cv,
             const int* page_table, const int* indices, const int* counts,
             const uint8_t* keep, const uint8_t* valid, const uint8_t* mask,
             float* part, void* out, int dtype, int B, int H, int Hkv, int Hc,
             int S, int D, int NB, int W, int P, int splits, void* stream) {
  if (H % Hkv || H / Hkv > GMAX || D > DMAX || D % 8 || S % NB ||
      (S / NB) % KT || splits < 1 || Hc < Hkv)
    return (int)cudaErrorInvalidValue;
  const int G = H / Hkv;
  // 16-byte vectors of a key row per logit lane
  const int ch = (D * (dtype == REPRO_BF16 ? 2 : 4) / 16 + LPK - 1) / LPK;
#define REPRO_GROUP(T, CH)                                                  \
  return by_group<T, MODE, CH>(G, q, ck, cv, page_table, indices, counts,   \
                               keep, valid, mask, part, out, B, H, Hkv, Hc, \
                               S, D, NB, W, P, splits, stream)
  if (dtype == REPRO_BF16) {
    if (ch == 1) REPRO_GROUP(__nv_bfloat16, 1);
    REPRO_GROUP(__nv_bfloat16, 2);
  }
  if (ch == 1) REPRO_GROUP(float, 1);
  if (ch == 2) REPRO_GROUP(float, 2);
  REPRO_GROUP(float, 4);
#undef REPRO_GROUP
}

}  // namespace

// part: float32 scratch of B * H * splits * (D + 2) elements (the partials'
// m, l and acc); the wrapper allocates it.  ck / cv point at kv head h0 of a
// (B, Hc, S, D) cache, Hc >= Hkv (Hc = Hkv: the whole cache).
extern "C" int repro_decode_attn(const void* q, const void* ck,
                                 const void* cv, const int* indices,
                                 const int* counts, const uint8_t* keep,
                                 const uint8_t* valid, float* part, void* out,
                                 int dtype, int B, int H, int Hkv, int Hc,
                                 int S, int D, int NB, int W, int splits,
                                 void* stream) {
  return dispatch<PLAN>(q, ck, cv, nullptr, indices, counts, keep, valid,
                        nullptr, part, out, dtype, B, H, Hkv, Hc, S, D, NB, W,
                        0, splits, stream);
}

// pool_k / pool_v: one layer's (P, Hc, ps, D) pool from kv head h0 on
// (Hc = Hkv: the whole pool); page_table (B, NB); the plan and valid
// (B, NB * ps) in logical block coordinates.
extern "C" int repro_decode_attn_paged(const void* q, const void* pool_k,
                                       const void* pool_v,
                                       const int* page_table,
                                       const int* indices, const int* counts,
                                       const uint8_t* keep,
                                       const uint8_t* valid, float* part,
                                       void* out, int dtype, int B, int H,
                                       int Hkv, int Hc, int ps, int D, int NB,
                                       int W, int P, int splits,
                                       void* stream) {
  return dispatch<PAGED>(q, pool_k, pool_v, page_table, indices, counts,
                         keep, valid, nullptr, part, out, dtype, B, H, Hkv,
                         Hc, NB * ps, D, NB, W, P, splits, stream);
}

// q (B, H, D); cache_k / cache_v (B, Hkv, S, D); mask (B, H, S) uint8 with
// S = NB * bs.  table = 0 walks every block (flash_decode); table = 1 walks
// indices[b, hk, :counts[b, hk]] of the (B, Hkv, NB) union table
// (flash_decode_sparse).
extern "C" int repro_decode_attn_mask(const void* q, const void* ck,
                                      const void* cv, const int* indices,
                                      const int* counts, const uint8_t* mask,
                                      float* part, void* out, int dtype,
                                      int B, int H, int Hkv, int S, int D,
                                      int NB, int table, int splits,
                                      void* stream) {
  if (table)
    return dispatch<MASK_TABLE>(q, ck, cv, nullptr, indices, counts, nullptr,
                                nullptr, mask, part, out, dtype, B, H, Hkv,
                                Hkv, S, D, NB, NB, 0, splits, stream);
  return dispatch<MASK_DENSE>(q, ck, cv, nullptr, nullptr, nullptr, nullptr,
                              nullptr, mask, part, out, dtype, B, H, Hkv, Hkv,
                              S, D, NB, NB, 0, splits, stream);
}
