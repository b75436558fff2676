// Flash-attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel `_fa_kernel` (texocr_tpu/ops/flash_attention.py),
// which keeps the whole K/V of one (batch, head) resident in many-MB VMEM and
// softmaxes each 128-query block against all keys at once. A Hopper block has at
// most 227 KB of shared memory: 631 x 64 float32 K+V alone is 323 KB. So this
// kernel walks K/V in 64-key tiles staged in shared memory, with an online softmax
// (running row max and row sum, both float32) and the output rescaled as the max
// moves. The (Nq, Nk) score matrix never reaches device memory.
//
// What bounds it: at the encoder's shapes (N = 631, dh = 64) the work is
// 4 * N^2 * dh operations against 4 * N * dh elements moved, about 160 operations
// per element, so the ideal kernel is bound by operations. This first version
// multiplies with plain float32 FMAs from shared memory (no tensor cores), so it
// sits far above that bound; wgmma/TMA is later work.
//
// Layout: one block per (64-query tile, head, batch); 256 threads as a 16 x 16
// grid, each thread owns 4 query rows x 4 key columns of a score tile and
// 4 rows x dh/16 columns of the output. Rows of one 16-thread half-warp share a
// query row set, so row reductions are 4 xor-shuffles.
//
// Semantics follow the plain math path (texocr_tpu_torch/ops/attention_core.py):
// logits and softmax in float32; a key is masked when col >= kv_lens[b] or, if
// causal, col > row (top-left aligned; callers only ask for causal with Nq == Nk);
// masked logits are filled with -FLT_MAX, so a row with no valid key softmaxes to
// uniform over all Nk keys. Keys past Nk are excluded outright (-inf). Inputs are
// float32 or bfloat16, accumulation is float32, and the output has q's type.
//
// One deliberate difference in precision: the TPU kernel and the math path round
// the normalised probabilities P to the input type before the PV product. Here P
// stays unnormalised float32 (an online softmax knows the normaliser only after
// the last key tile, so it cannot round the normalised P), and the output is
// divided by the row sum at the end. In float32 the two agree to rounding; in
// bfloat16 this kernel is the more exact of the two, and a greedy token chosen on
// a near tie may differ from the math path's.
//
// The launch allocates nothing, does not synchronise, runs on the given stream,
// and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

namespace {

constexpr int BLOCK_Q = 64;
constexpr int BLOCK_K = 64;
constexpr int THREADS = 256;  // a 16 x 16 grid of threads
constexpr int ROWS = BLOCK_Q / 16;  // query rows per thread
constexpr int COLS = BLOCK_K / 16;  // key columns per thread

struct Strides {
  long long b, h, n;  // the last (dh) stride is 1
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// Copies `rows_valid` rows of `dh` elements into a 64 x D float tile of shared
// memory (row pitch `pitch`), zero-filling the rest so ragged edges add nothing.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, int pitch, const T* src,
                                          long long row_stride, int rows_valid, int dh) {
  for (int idx = threadIdx.x; idx < 64 * D; idx += THREADS) {
    const int r = idx / D;
    const int c = idx % D;
    float val = 0.f;
    if (r < rows_valid && c < dh) val = to_float(src[r * row_stride + c]);
    dst[r * pitch + c] = val;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, const int* __restrict__ kv_lens, int nq, int nk, int dh,
                 Strides qs, Strides ks, Strides vs, Strides os, float scale, int causal) {
  constexpr int QK_PITCH = D + 1;  // odd pitch: 16 key rows read in one step hit 16 banks
  constexpr int V_PITCH = D;
  constexpr int P_PITCH = BLOCK_K + 1;
  constexpr int DC = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + BLOCK_Q * QK_PITCH;
  float* v_s = k_s + BLOCK_K * QK_PITCH;
  float* p_s = v_s + BLOCK_K * V_PITCH;

  const int q0 = blockIdx.x * BLOCK_Q;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  int kv_len = nk;
  if (kv_lens != nullptr) kv_len = min(max(kv_lens[b], 0), nk);
  // Key tiles that no row of this block may attend are skipped. A row with no
  // valid key (kv_len == 0) softmaxes to uniform over all nk keys, so it walks
  // every tile.
  int k_end = nk;
  if (kv_len > 0) {
    k_end = kv_len;
    if (causal) k_end = min(k_end, q0 + BLOCK_Q);
  }

  const T* qb = q + b * qs.b + h * qs.h + (long long)q0 * qs.n;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;
  load_tile<T, D>(q_s, QK_PITCH, qb, qs.n, min(BLOCK_Q, nq - q0), dh);

  float acc[ROWS][DC];
  float m_run[ROWS];
  float l_run[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < k_end; k0 += BLOCK_K) {
    __syncthreads();  // the previous tile's K, V and P are no longer read
    const int k_rows = min(BLOCK_K, nk - k0);
    load_tile<T, D>(k_s, QK_PITCH, kb + (long long)k0 * ks.n, ks.n, k_rows, dh);
    load_tile<T, D>(v_s, V_PITCH, vb + (long long)k0 * vs.n, vs.n, k_rows, dh);
    __syncthreads();

    float s[ROWS][COLS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < COLS; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[ROWS], kv[COLS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) qv[i] = q_s[(ty * ROWS + i) * QK_PITCH + d];
#pragma unroll
      for (int j = 0; j < COLS; ++j) kv[j] = k_s[(tx + 16 * j) * QK_PITCH + d];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int j = 0; j < COLS; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int row = q0 + ty * ROWS + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        const int col = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (col >= nk) {
          x = -INFINITY;
        } else if (col >= kv_len || (causal && col > row)) {
          x = -FLT_MAX;
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      // The tile's first key is < nk, so mx >= -FLT_MAX is finite and no
      // (-inf) - (-inf) arises; the first tile's alpha is exp(-inf) = 0.
      const float m_new = fmaxf(m_run[i], mx);
      const float alpha = expf(m_run[i] - m_new);
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        const float p = expf(s[i][j] - m_new);
        s[i][j] = p;
        row_sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) row_sum += __shfl_xor_sync(0xffffffffu, row_sum, off);
      l_run[i] = l_run[i] * alpha + row_sum;
      m_run[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
#pragma unroll
      for (int j = 0; j < COLS; ++j) p_s[(ty * ROWS + i) * P_PITCH + tx + 16 * j] = s[i][j];
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BLOCK_K; ++kk) {
      float pv[ROWS], vv[DC];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) pv[i] = p_s[(ty * ROWS + i) * P_PITCH + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = v_s[kk * V_PITCH + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

  T* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int row = q0 + ty * ROWS + i;
    if (row >= nq) continue;
    const float inv = 1.f / l_run[i];
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int col = tx + 16 * c;
      if (col < dh) store(ob + row * os.n + col, acc[i][c] * inv);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, const int* kv_lens,
                   int batch, int heads, int nq, int nk, int dh, Strides qs, Strides ks,
                   Strides vs, Strides os, float scale, int causal, cudaStream_t stream) {
  const int smem = ((BLOCK_Q + BLOCK_K) * (D + 1) + BLOCK_K * D + BLOCK_Q * (BLOCK_K + 1)) *
                   (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((nq + BLOCK_Q - 1) / BLOCK_Q, heads, batch);
  flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), kv_lens, nq, nk, dh, qs, ks, vs, os, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// q: (B, H, Nq, dh), k and v: (B, H, Nk, dh), o like q, each given by its batch,
// head and row strides in elements (the dh stride is 1). kv_lens: (B,) int32 on
// the device, or null for all keys valid. dtype: 0 = float32, 1 = bfloat16.
extern "C" int texocr_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, const int* kv_lens, int batch,
    int heads, int nq, int nk, int dh, long long q_sb, long long q_sh, long long q_sn,
    long long k_sb, long long k_sh, long long k_sn, long long v_sb, long long v_sh,
    long long v_sn, long long o_sb, long long o_sh, long long o_sn, float scale, int causal,
    int dtype, void* stream) {
  if (batch <= 0 || heads <= 0 || nq <= 0 || nk <= 0 || dh <= 0 || dh > 128 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const Strides qs{q_sb, q_sh, q_sn}, ks{k_sb, k_sh, k_sn}, vs{v_sb, v_sh, v_sn},
      os{o_sb, o_sh, o_sn};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dh <= 64) {
    err = dtype == 1 ? launch<__nv_bfloat16, 64>(q, k, v, o, kv_lens, batch, heads, nq, nk, dh,
                                                  qs, ks, vs, os, scale, causal, s)
                     : launch<float, 64>(q, k, v, o, kv_lens, batch, heads, nq, nk, dh, qs, ks,
                                         vs, os, scale, causal, s);
  } else {
    err = dtype == 1 ? launch<__nv_bfloat16, 128>(q, k, v, o, kv_lens, batch, heads, nq, nk, dh,
                                                   qs, ks, vs, os, scale, causal, s)
                     : launch<float, 128>(q, k, v, o, kv_lens, batch, heads, nq, nk, dh, qs, ks,
                                          vs, os, scale, causal, s);
  }
  return (int)err;
}
