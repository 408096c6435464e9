// Strip scores of SharePrefill's pattern estimation (paper Algorithm 3).
//
// Replaces the TPU kernel repro/kernels/strip.py::strip_scores_pallas
// (_strip_ml_kernel + _strip_norm_kernel): for every (batch, query head) it
// computes softmax(Q_hat K^T / sqrt(D)) of the last `bs` queries against all
// N keys, causally masked (strip row r is global query N - bs + r), as a
// (B, H, bs, N) float32 strip.
//
// Bound on an H100: the bytes of the strip it writes, B*H*bs*N*4 (268 MB,
// 80 us at 3.35 TB/s, for llama3-8b at N = 8192, B = 2); the bs*N*D products
// per head take 17 us at the bf16 tensor-core rate.  This first version runs
// its products on CUDA cores in float32 (and twice, once per pass), so it is
// bound by those operations, not by the bytes; tensor-core products are
// later work.  The design keeps the strip the only large array that touches
// device memory.  Pass 1 streams K once to get
// each row's running max and denominator, kept per thread and merged by
// warp shuffles (no (bs, N) logits are written); pass 2 streams K again and
// writes exp(s - m) / l.  The grid is (bs / 16 row groups, B * H) so that
// bs/16 times more CTAs than heads are in flight; each CTA keeps its 16
// query rows in shared memory and reads kv head h / G (GQA, K never
// repeated).
#include "common.cuh"

namespace {

constexpr int ROWS = 16;      // strip rows per CTA
constexpr int KT = 32;        // keys per shared-memory tile (one per lane)
constexpr int NT = 128;       // threads: 4 warps x 4 rows each
constexpr int RPW = ROWS / (NT / 32);

template <typename T>
__device__ __forceinline__ void load_tile(float* k_s, const T* kb, int j0,
                                          int N, int D) {
  for (int i = threadIdx.x; i < KT * D; i += NT) {
    int r = i / D, c = i - r * D;
    int key = j0 + r;
    k_s[r * (D + 1) + c] = key < N ? repro::to_f(kb[(size_t)key * D + c])
                                   : 0.f;
  }
}

template <typename T>
__global__ void strip_kernel(const T* __restrict__ q,
                             const T* __restrict__ k,
                             float* __restrict__ out, int H, int Hkv, int Nq,
                             int N, int D, int bs, float scale) {
  extern __shared__ float smem[];
  float* q_s = smem;                    // ROWS x D
  float* k_s = q_s + ROWS * D;          // KT x (D + 1)
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H;
  const int hk = h / (H / Hkv);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * ROWS;   // first strip row of this CTA

  const T* qb = q + ((size_t)bh * Nq + (Nq - bs) + row0) * D;
  const T* kb = k + ((size_t)b * Hkv + hk) * (size_t)N * D;
  for (int i = threadIdx.x; i < ROWS * D; i += NT)
    q_s[i] = repro::to_f(qb[i]);

  float m[RPW], l[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) { m[i] = -CUDART_INF_F; l[i] = 0.f; }

  // pass 1: per-thread online max / denominator over its keys
  for (int j0 = 0; j0 < N; j0 += KT) {
    __syncthreads();
    load_tile(k_s, kb, j0, N, D);
    __syncthreads();
    const int key = j0 + lane;
    float s[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) s[i] = 0.f;
    for (int d = 0; d < D; ++d) {
      float kv = k_s[lane * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < RPW; ++i)
        s[i] = fmaf(q_s[(warp * RPW + i) * D + d], kv, s[i]);
    }
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int r = row0 + warp * RPW + i;
      if (key < N && key <= N - bs + r) {
        float x = s[i] * scale;
        float mn = fmaxf(m[i], x);
        l[i] = l[i] * expf(m[i] - mn) + expf(x - mn);
        m[i] = mn;
      }
    }
  }
  // merge the 32 lanes' partial (m, l) of each row
  float M[RPW], L[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    M[i] = repro::group_max<32>(m[i]);
    float part = (l[i] > 0.f) ? l[i] * expf(m[i] - M[i]) : 0.f;
    L[i] = fmaxf(repro::group_sum<32>(part), 1e-30f);
  }

  // pass 2: normalized probabilities, the only (bs, N) array written
  for (int j0 = 0; j0 < N; j0 += KT) {
    __syncthreads();
    load_tile(k_s, kb, j0, N, D);
    __syncthreads();
    const int key = j0 + lane;
    if (key >= N) continue;
    float s[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) s[i] = 0.f;
    for (int d = 0; d < D; ++d) {
      float kv = k_s[lane * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < RPW; ++i)
        s[i] = fmaf(q_s[(warp * RPW + i) * D + d], kv, s[i]);
    }
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int r = row0 + warp * RPW + i;
      float p = (key <= N - bs + r) ? expf(s[i] * scale - M[i]) / L[i] : 0.f;
      out[((size_t)bh * bs + r) * N + key] = p;
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, void* out, int B, int H, int Hkv,
           int Nq, int N, int D, int bs, void* stream) {
  size_t smem = (size_t)(ROWS * D + KT * (D + 1)) * sizeof(float);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(strip_kernel<T>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  dim3 grid(bs / ROWS, B * H);
  strip_kernel<T><<<grid, NT, smem, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (float*)out, H, Hkv, Nq, N, D, bs,
      1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int repro_strip(const void* q, const void* k, void* out,
                           int dtype, int B, int H, int Hkv, int Nq, int N,
                           int D, int bs, void* stream) {
  if (bs % ROWS != 0) return (int)cudaErrorInvalidValue;
  if (dtype == REPRO_BF16)
    return launch<__nv_bfloat16>(q, k, out, B, H, Hkv, Nq, N, D, bs,
                                 stream);
  return launch<float>(q, k, out, B, H, Hkv, Nq, N, D, bs, stream);
}
