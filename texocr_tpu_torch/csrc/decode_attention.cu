// Decode-step attention over cached K/V for Hopper (sm_90a), plain C interface
// for ctypes.
//
// Replaces no TPU kernel: the JAX package computes a decode step's attention
// as XLA einsums on bf16 operands with float32 results
// (texocr_tpu/models/attention.py, `preferred_element_type=float32`), and the
// port's plain version (ops/decode_attention.py) casts the whole cache to
// float32 and, for the cross cache's split-head views, copies it once more
// into a contiguous tensor before a float32 gemv, every step. At batch 256 that
// moves about 12 GB a step where the step needs one read of the cache. This
// kernel reads each cached byte once, in the type it is stored in, and keeps
// the float32 arithmetic in registers and shared memory.
//
// What bounds it: bytes. A query row meets each key once, 2 * dh operations
// on dh cached elements each of K and V: one operation per byte in bf16, two in
// int8, far below the ~295 operations per byte where the tensor cores would
// be the limit. The least time is the cache's bytes at 3.35 TB/s. At batch
// 256 on the (160, 1008) canvas (631 keys, 8 heads of 64) a layer's bf16 cross
// cache is 331 MB, 0.099 ms (int8: 165 MB and its scales, 0.049 ms); at the
// served batch of 16 it is 20.7 MB, 6.2 us. The self cache adds (t + 1)
// positions a layer at step t (at batch 256 and t = 255, 134 MB in bf16).
//
// Design: one block per (query-row group, head, batch row of the cache), its
// query rows the beam rows of an image (the cross cache: one K/V per image) or
// one row (the self cache: one per beam row). Three passes:
//   1. scores: each lane group of 8 lanes takes one key row (64 elements, 128
//      bytes in bf16), each lane 8 elements by one 16-byte load (8 bytes in
//      int8, two 16-byte loads in float32), so a warp instruction reads 4
//      whole rows; 4 keys a lane group are loaded before any is used (8 in
//      int8). The partial dot products meet by 3 shuffles, and the float32
//      logits of the block's rows stay in shared memory (at most 8 rows x 4096
//      keys), with their running max in registers;
//   2. softmax: the exact row max and row sum over the block, then P, rounded
//      to the compute type (and scaled there for the int8 self prefix), written
//      back over the logits;
//   3. P V: the same lane layout over the V rows, each lane summing its 8
//      columns in float32 over its keys; lanes, then warps, are summed in a
//      fixed order, and the result is rounded to the compute type.
// No online softmax: it would round unnormalised P, which the plain path does
// not. Only the order of the float32 sums differs from the plain version.
// The warps of a block follow the shape: 4 when batch x heads x row groups
// fills the SMs with at least 32 warps each (batch 256: 2048 blocks), up to 16
// when it does not (batch 16: 128 blocks of 16 warps, one an SM), and never
// more than the keys give work to. Rows of a key are read where they lie: the
// cross cache's (B, Nk, H, dh) buffer through its strides, each row 128
// contiguous bytes.
//
// Modes (one instantiation each, by compute type and row count):
//   PLAIN:  keys [0, n) in the compute type (cross or self cache);
//   CROSS8: keys [0, n) int8 with one scale per (batch, head, dh): q is
//           multiplied by K's scale in the compute type first, the output by
//           V's after its rounding;
//   SPLIT:  the int8 self cache: positions [0, n8) int8 with one scale per
//           position (the logit, after the softmax scale, by K's; P, after its
//           rounding, by V's, rounded again), positions [n8, n) in the compute
//           type, one softmax over both.
// Masked keys (an optional (batch, key) bool mask, cross modes) are filled with
// -FLT_MAX after scaling, so a row with every key masked averages V.
//
// The launch allocates nothing, does not synchronise, runs on the given stream,
// and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int D = 64;           // head dim, the only one the model has
constexpr int ELEMS = 8;        // elements of a row a lane holds
constexpr int LPK = D / ELEMS;  // lanes a key row: 8
constexpr int KPW = 32 / LPK;   // key rows a warp instruction reads: 4
constexpr int MAX_WARPS = 16;
constexpr int MAX_ROWS = 8;     // query rows a block; more take more blocks
constexpr int MAX_KEYS = 4096;
constexpr int SMEM_LIMIT = 232448;
constexpr unsigned FULL = 0xffffffffu;

enum Mode { PLAIN = 0, CROSS8 = 1, SPLIT = 2 };

struct Params {
  const void* q;
  long long q_b, q_h, q_r;
  void* o;
  long long o_b, o_h, o_r;
  const void* k;  // compute-type keys and values
  const void* v;
  long long kv_b, kv_h, kv_n;
  const int8_t* k8;  // int8 keys and values
  const int8_t* v8;
  long long k8_b, k8_h, k8_n;
  const void* sk;  // int8 scales: per (b, h, dh) in CROSS8, per (b, h, position) in SPLIT
  const void* sv;
  long long s_b, s_h;
  const uint8_t* mask;  // (batch, key) bool or null
  long long mask_b, mask_n;
  int heads, rows, group_rows, n, n8;
  float scale;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ float round_to(float x) {
  if constexpr (sizeof(T) == 2) return __bfloat162float(__float2bfloat16_rn(x));
  return x;
}

template <typename T>
__device__ __forceinline__ T from_f(float x) {
  if constexpr (sizeof(T) == 2) return __float2bfloat16_rn(x);
  return x;
}

// A lane's 8 elements of one cached row, loaded in their stored type.
template <typename KT>
struct Chunk;

template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int UNROLL = 4;
  uint4 raw = {0u, 0u, 0u, 0u};
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    raw = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void unpack(float* x) const {
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

template <>
struct Chunk<int8_t> {
  static constexpr int UNROLL = 8;
  uint2 raw = {0u, 0u};
  __device__ __forceinline__ void load(const int8_t* p) {
    raw = __ldg(reinterpret_cast<const uint2*>(p));
  }
  // Exact: each byte, made offset binary, becomes the low mantissa bits of
  // 2^23, and 2^23 + 128 is taken off again.
  __device__ __forceinline__ void unpack(float* x) const {
    const uint32_t w[2] = {raw.x ^ 0x80808080u, raw.y ^ 0x80808080u};
#pragma unroll
    for (int i = 0; i < 8; ++i)
      x[i] = __uint_as_float(__byte_perm(w[i / 4], 0x4B000000u, 0x7440 + (i % 4))) - 8388736.f;
  }
};

template <>
struct Chunk<float> {
  static constexpr int UNROLL = 2;
  float4 lo = {0.f, 0.f, 0.f, 0.f}, hi = {0.f, 0.f, 0.f, 0.f};
  __device__ __forceinline__ void load(const float* p) {
    lo = __ldg(reinterpret_cast<const float4*>(p));
    hi = __ldg(reinterpret_cast<const float4*>(p) + 1);
  }
  __device__ __forceinline__ void unpack(float* x) const {
    x[0] = lo.x, x[1] = lo.y, x[2] = lo.z, x[3] = lo.w;
    x[4] = hi.x, x[5] = hi.y, x[6] = hi.z, x[7] = hi.w;
  }
};

// Where this thread sits: its block's batch row, head and query rows, its
// warp, its key slot in the warp (`grp`) and its 8 columns (`sub`).
struct Ctx {
  int b, h, row0, nrows, warp, warps, grp, sub;
};

// Pass 1 over the keys [start, end) of one segment, read from `base` (this
// (b, h)'s rows, `stride` elements apart): the finished logit of every query
// row and key into `scores` (row-major, n a row), their max into `mx`.
template <typename T, int MODE, int R, typename KT>
__device__ __forceinline__ void score_keys(const Params& p, const Ctx& c, const KT* base,
                                           long long stride, int start, int end,
                                           const float (&qf)[R][ELEMS], float* scores,
                                           float (&mx)[R]) {
  constexpr int U = Chunk<KT>::UNROLL;
  constexpr bool PREFIX = MODE == SPLIT && sizeof(KT) == 1;  // per-position K scale
  const T* sk = PREFIX ? static_cast<const T*>(p.sk) + c.b * p.s_b + c.h * p.s_h : nullptr;
  const uint8_t* mask = MODE != SPLIT && p.mask ? p.mask + c.b * p.mask_b : nullptr;
  for (int tile = start + c.warp * KPW * U; tile < end; tile += c.warps * KPW * U) {
    Chunk<KT> ch[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int key = tile + u * KPW + c.grp;
      if (key < end) ch[u].load(base + key * stride + c.sub * ELEMS);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int key = tile + u * KPW + c.grp;
      float x[ELEMS];
      ch[u].unpack(x);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (R > 1 && r >= c.nrows) break;
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < ELEMS; ++e) dot = fmaf(qf[r][e], x[e], dot);
#pragma unroll
        for (int off = LPK / 2; off > 0; off >>= 1) dot += __shfl_xor_sync(FULL, dot, off);
        if (key < end && c.sub == 0) {
          float l = dot * p.scale;
          if (PREFIX) l *= to_f(sk[key]);
          if (mask && !mask[key * p.mask_n]) l = -FLT_MAX;
          scores[r * p.n + key] = l;
          mx[r] = fmaxf(mx[r], l);
        }
      }
    }
  }
}

// Pass 3 over the values [start, end) of one segment: acc[r] += P[r, key] V[key]
// over this lane's keys and 8 columns.
template <int R, typename KT>
__device__ __forceinline__ void weigh_values(const Params& p, const Ctx& c, const KT* base,
                                             long long stride, int start, int end,
                                             const float* probs, float (&acc)[R][ELEMS]) {
  constexpr int U = Chunk<KT>::UNROLL;
  for (int tile = start + c.warp * KPW * U; tile < end; tile += c.warps * KPW * U) {
    Chunk<KT> ch[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int key = tile + u * KPW + c.grp;
      if (key < end) ch[u].load(base + key * stride + c.sub * ELEMS);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int key = tile + u * KPW + c.grp;
      if (key >= end) continue;
      float x[ELEMS];
      ch[u].unpack(x);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (R > 1 && r >= c.nrows) break;
        const float pr = probs[r * p.n + key];
#pragma unroll
        for (int e = 0; e < ELEMS; ++e) acc[r][e] = fmaf(pr, x[e], acc[r][e]);
      }
    }
  }
}

// The block's reduction of one value a thread per query row (max or sum), in
// a fixed order; every thread gets the results. `red` holds MAX_WARPS * R.
template <int R, bool MAX>
__device__ __forceinline__ void block_reduce(float (&x)[R], float* red, const Ctx& c) {
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float y = __shfl_xor_sync(FULL, x[r], off);
      x[r] = MAX ? fmaxf(x[r], y) : x[r] + y;
    }
  if ((threadIdx.x & 31) == 0)
#pragma unroll
    for (int r = 0; r < R; ++r) red[c.warp * R + r] = x[r];
  __syncthreads();
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float y = red[r];
    for (int w = 1; w < c.warps; ++w) y = MAX ? fmaxf(y, red[w * R + r]) : y + red[w * R + r];
    x[r] = y;
  }
  __syncthreads();  // red is free again
}

template <typename T, int MODE, int R>
__global__ void __launch_bounds__(MAX_WARPS * 32) decode_attention_step(const Params p) {
  extern __shared__ float smem[];
  float* red = smem;                     // MAX_WARPS * R
  float* scores = smem + MAX_WARPS * R;  // nrows x n; then warps x nrows x D partial sums
  Ctx c;
  c.b = blockIdx.z;
  c.h = blockIdx.y;
  c.row0 = blockIdx.x * p.group_rows;
  c.nrows = min(p.group_rows, p.rows - c.row0);
  c.warp = threadIdx.x >> 5;
  c.warps = blockDim.x >> 5;
  c.grp = (threadIdx.x & 31) / LPK;
  c.sub = (threadIdx.x & 31) % LPK;

  // This lane's 8 columns of each query row (for CROSS8 times K's scale,
  // rounded to the compute type as the plain path's product is).
  float qf[R][ELEMS];
  {
    const T* q = static_cast<const T*>(p.q) + c.b * p.q_b + c.h * p.q_h + c.sub * ELEMS;
    const T* sk = MODE == CROSS8
                      ? static_cast<const T*>(p.sk) + c.b * p.s_b + c.h * p.s_h + c.sub * ELEMS
                      : nullptr;
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int e = 0; e < ELEMS; ++e) {
        float x = 0.f;
        if (r < c.nrows) {
          x = to_f(q[(c.row0 + r) * p.q_r + e]);
          if (MODE == CROSS8) x = round_to<T>(x * to_f(sk[e]));
        }
        qf[r][e] = x;
      }
  }

  // 1. logits
  float mx[R];
#pragma unroll
  for (int r = 0; r < R; ++r) mx[r] = -INFINITY;
  if (MODE != PLAIN)
    score_keys<T, MODE, R>(p, c, p.k8 + c.b * p.k8_b + c.h * p.k8_h, p.k8_n, 0, p.n8, qf,
                           scores, mx);
  if (MODE != CROSS8)
    score_keys<T, MODE, R>(p, c, static_cast<const T*>(p.k) + c.b * p.kv_b + c.h * p.kv_h,
                           p.kv_n, p.n8, p.n, qf, scores, mx);
  __syncthreads();
  block_reduce<R, true>(mx, red, c);

  // 2. softmax: exact max and sum, P rounded to the compute type
  float sum[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    sum[r] = 0.f;
    if (r >= c.nrows) continue;
    for (int j = threadIdx.x; j < p.n; j += blockDim.x) {
      const float e = expf(scores[r * p.n + j] - mx[r]);
      scores[r * p.n + j] = e;
      sum[r] += e;
    }
  }
  block_reduce<R, false>(sum, red, c);
  {
    const T* sv = MODE == SPLIT ? static_cast<const T*>(p.sv) + c.b * p.s_b + c.h * p.s_h
                                : nullptr;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r >= c.nrows) continue;
      for (int j = threadIdx.x; j < p.n; j += blockDim.x) {
        float pr = round_to<T>(scores[r * p.n + j] / sum[r]);
        if (MODE == SPLIT && j < p.n8) pr = round_to<T>(pr * to_f(sv[j]));
        scores[r * p.n + j] = pr;
      }
    }
  }
  __syncthreads();

  // 3. P V
  float acc[R][ELEMS];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int e = 0; e < ELEMS; ++e) acc[r][e] = 0.f;
  if (MODE != PLAIN)
    weigh_values<R>(p, c, p.v8 + c.b * p.k8_b + c.h * p.k8_h, p.k8_n, 0, p.n8, scores, acc);
  if (MODE != CROSS8)
    weigh_values<R>(p, c, static_cast<const T*>(p.v) + c.b * p.kv_b + c.h * p.kv_h, p.kv_n,
                    p.n8, p.n, scores, acc);
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int e = 0; e < ELEMS; ++e)
#pragma unroll
      for (int off = LPK; off < 32; off <<= 1) acc[r][e] += __shfl_xor_sync(FULL, acc[r][e], off);
  __syncthreads();  // every warp has read P
  float* part = scores;
  if (c.grp == 0)
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r >= c.nrows) continue;
#pragma unroll
      for (int e = 0; e < ELEMS; ++e)
        part[(c.warp * c.nrows + r) * D + c.sub * ELEMS + e] = acc[r][e];
    }
  __syncthreads();
  const T* sv = MODE == CROSS8 ? static_cast<const T*>(p.sv) + c.b * p.s_b + c.h * p.s_h
                               : nullptr;
  T* o = static_cast<T*>(p.o) + c.b * p.o_b + c.h * p.o_h;
  for (int i = threadIdx.x; i < c.nrows * D; i += blockDim.x) {
    const int r = i / D, d = i % D;
    float s = part[r * D + d];
    for (int w = 1; w < c.warps; ++w) s += part[(w * c.nrows + r) * D + d];
    float out = round_to<T>(s);
    if (MODE == CROSS8) out = round_to<T>(out * to_f(sv[d]));
    o[(c.row0 + r) * p.o_r + d] = from_f<T>(out);
  }
}

// Lets `kernel` use up to SMEM_LIMIT bytes of dynamic shared memory, once per
// instantiation and device (`done` holds a bit a device).
cudaError_t allow_dynamic_smem(std::atomic<unsigned long long>& done, const void* kernel) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (device & 63);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

int sm_count() {
  static std::atomic<int> cached[64];
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess) return 132;
  int n = cached[device & 63].load(std::memory_order_relaxed);
  if (n <= 0) {
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) != cudaSuccess ||
        n <= 0)
      return 132;
    cached[device & 63].store(n, std::memory_order_relaxed);
  }
  return n;
}

// Warps a block: enough for at least 32 warps an SM over the whole grid (4 to
// 16), and no more than the keys give a 16-key tile each.
int warps_for(long long blocks, int n) {
  const long long target = 32LL * sm_count();
  int w = 4;
  while (w < MAX_WARPS && blocks * w < target) w *= 2;
  const int tiles = (n + KPW * 4 - 1) / (KPW * 4);
  while (w > 1 && w > tiles) w /= 2;
  return w;
}

template <typename T, int MODE, int R>
cudaError_t launch(const Params& p, int batch, int groups, cudaStream_t stream) {
  const int warps = warps_for((long long)batch * p.heads * groups, p.n);
  const int part = warps * p.group_rows * D;
  const int floats = MAX_WARPS * R + (p.group_rows * p.n > part ? p.group_rows * p.n : part);
  const int smem = floats * (int)sizeof(float);
  if (smem > SMEM_LIMIT) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    static std::atomic<unsigned long long> done{0};
    const cudaError_t err =
        allow_dynamic_smem(done, reinterpret_cast<const void*>(decode_attention_step<T, MODE, R>));
    if (err != cudaSuccess) return err;
  }
  decode_attention_step<T, MODE, R>
      <<<dim3(groups, p.heads, batch), warps * 32, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_mode(const Params& p, int mode, int batch, int groups, cudaStream_t s) {
  const bool one = p.group_rows == 1;
  switch (mode) {
    case PLAIN:
      return one ? launch<T, PLAIN, 1>(p, batch, groups, s)
                 : launch<T, PLAIN, MAX_ROWS>(p, batch, groups, s);
    case CROSS8:
      return one ? launch<T, CROSS8, 1>(p, batch, groups, s)
                 : launch<T, CROSS8, MAX_ROWS>(p, batch, groups, s);
    default:
      return one ? launch<T, SPLIT, 1>(p, batch, groups, s) : cudaErrorInvalidValue;
  }
}

}  // namespace

// One decode step's attention. q: (batch, heads, rows, 64) and o alike, by
// their batch, head and row strides in elements; k, v: compute-type rows by
// batch, head and key strides; k8, v8: int8 rows likewise; sk, sv: the int8
// scales, by batch and head strides (unit stride along dh in CROSS8, along
// positions in SPLIT); mask: (batch, key) bool or null. Keys [0, n8) are the
// int8 ones (n8 = n in CROSS8, 0 in PLAIN). dtype: 0 = float32, 1 = bfloat16.
// mode: 0 PLAIN, 1 CROSS8, 2 SPLIT (rows 1 only).
extern "C" int texocr_decode_attention(
    int mode, int dtype, const void* q, long long q_b, long long q_h, long long q_r, void* o,
    long long o_b, long long o_h, long long o_r, const void* k, const void* v, long long kv_b,
    long long kv_h, long long kv_n, const void* k8, const void* v8, long long k8_b,
    long long k8_h, long long k8_n, const void* sk, const void* sv, long long s_b,
    long long s_h, const void* mask, long long mask_b, long long mask_n, int batch, int heads,
    int rows, int n, int n8, int dh, float scale, void* stream) {
  if (batch <= 0 || heads <= 0 || rows <= 0 || n <= 0 || n > MAX_KEYS || n8 < 0 || n8 > n ||
      dh != D || (dtype != 0 && dtype != 1) || mode < PLAIN || mode > SPLIT ||
      (mode == PLAIN && n8 != 0) || (mode == CROSS8 && n8 != n) || (mode == SPLIT && rows != 1))
    return (int)cudaErrorInvalidValue;
  const int groups = (rows + MAX_ROWS - 1) / MAX_ROWS;
  const int group_rows = (rows + groups - 1) / groups;
  const Params p{q,    q_b,  q_h,   q_r,   o,    o_b,  o_h,  o_r,
                 k,    v,    kv_b,  kv_h,  kv_n, static_cast<const int8_t*>(k8),
                 static_cast<const int8_t*>(v8),   k8_b, k8_h, k8_n,
                 sk,   sv,   s_b,   s_h,   static_cast<const uint8_t*>(mask),
                 mask_b, mask_n, heads, rows, group_rows, n, n8, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 0 ? launch_mode<float>(p, mode, batch, groups, s)
                          : launch_mode<__nv_bfloat16>(p, mode, batch, groups, s));
}
