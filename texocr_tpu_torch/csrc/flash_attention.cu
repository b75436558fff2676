// Flash attention for Hopper (sm_90a), plain C interface for ctypes: the
// forward in bfloat16 and float32, and the bfloat16 backward (its own note
// below, at `flash_bwd_dq_bf16`, replaces no Pallas kernel).
//
// Replaces the Pallas TPU kernel `_fa_kernel` (texocr_tpu/ops/flash_attention.py),
// which keeps the whole K/V of one (batch, head) resident in many-MB VMEM and
// softmaxes each 128-query block against all keys at once. A Hopper block has at
// most 227 KB of shared memory, and several blocks per SM are needed to hide
// latency, so both kernels here walk K/V in 64-key tiles with an online softmax
// (running row max and row sum, both float32) and rescale the output as the max
// moves. The (Nq, Nk) score matrix never reaches device memory.
//
// What bounds it: at the encoder's shapes (N = 631, dh = 64) the work is
// 4 * N^2 * dh operations against 4 * N * dh elements moved, about 160 operations
// per element, so the ideal kernel is bound by operations, in both types by the
// tensor cores: bfloat16 at 989 TFLOP/s, float32 as three TF32 products at
// 495 TFLOP/s (0.0066 and 0.0395 ms at (8, 8, 631, 64) on an H100 SXM).
//
// Two kernels, chosen by the input type:
//
// bfloat16 (the serving path): `flash_fwd_bf16`, both products on the tensor
// cores with `wgmma.mma_async` m64n64k16 (bf16 in, float32 accumulate). One block
// of one warpgroup (128 threads) per (64-query tile, head, batch). Q (64 x D) and
// a double-buffered ring of K and V tiles (64 keys x D each) sit in shared memory
// as bf16, written by 16-byte `cp.async` copies (zero-filled past Nq, Nk and dh)
// into the 128-byte-swizzled layout the wgmma descriptors name; tile j+1's copies
// are issued before tile j's products. S = Q K^T reads both operands from shared
// memory, K-major. The online softmax runs in registers on the accumulator
// layout (each row's 64 columns spread over the 4 threads of a quad), in base 2
// with one `ex2.approx` per element. P, rounded to bf16, is fed back from
// registers as the A operand of O += P V (the accumulator fragment of S is the
// register A fragment of the second product), with V read from shared memory as
// an MN-major B operand (transpose bit set). Shared memory: 5 tiles of 64 x D
// bf16 = 40 KB for D = 64, 80 KB for D = 128; at D = 64 registers (about 140 a
// thread), not shared memory, hold an SM to three blocks.
// Loads are `cp.async`, not TMA: the split-head layout has strides
// (N*H*dh, dh, H*dh, 1), so a TMA map would be 4-D and built on the host per
// call. TMA, 128-query tiles (each 64-query block reads the whole of its
// head's K and V from L2) and a persistent, warp-specialised schedule are
// later work.
//
// float32: `flash_fwd_f32`, both products on the tensor cores with
// `wgmma.mma_async` m64n64k8 (TF32 in, float32 accumulate), each split into
// three TF32 products (3xTF32): x = big + small, big = tf32(x) and
// small = tf32(x - big) (`cvt.rna`), and A B = As Bb + Ab Bs + Ab Bb, summed in
// that order in float32. The dropped As Bs is about 2^-22 of A B, so the result
// keeps float32-level accuracy: the float32 golden check needs exact greedy
// tokens, which one TF32 product would not give. One warpgroup per (64-query
// tile, head, batch), as in bfloat16. TF32 wgmma reads both shared-memory
// operands K-major only (PTX gives the transpose bit to 16-bit types alone), so
// - K tiles (and Q's at D = 128) are stored as 64-row x 32-float sub-tiles with
//   the 128-byte swizzle above (a k8 step is 32 bytes, like a bfloat16 k16
//   step), each as its big and its small part. At D = 64 Q's parts live in
//   registers instead, as the A operand of S = Q K^T (64 registers a thread; at
//   D = 128 they would take 128), which halves what S reads from shared memory;
// - V is stored transposed (dh x keys), big and small. Within every 8 keys,
//   positions 0-3 hold keys 0, 2, 4, 6 and positions 4-7 keys 1, 3, 5, 7: the TF32
//   register A fragment gives quad lane c columns (c, c + 4) where S's
//   accumulator fragment holds (2c, 2c + 1), so with V's keys in that order P is
//   split in registers and fed back as the A operand of O += P V unshuffled.
// Raw tiles land by 16-byte `cp.async` (zero-filled past Nq, Nk and dh; rows off
// 16 bytes element by element, chosen at launch). K lands in place of its big
// part and is split in place once per tile (Q once per block); V lands in a raw
// buffer that a split pass turns into V^T. The split passes overlap the tensor
// cores: V's runs while they form S = Q K^T, and the next tile's K's (its copies
// issued once S is done, when K's and raw V's buffers are free) while they form
// P V. Shared memory: 5 tiles of 64 x D float32 at D = 64, 80 KB (registers,
// 254 a thread, hold an SM to two blocks), and 7 at D = 128, 224 KB (one
// block). The online softmax is the bfloat16 kernel's (base 2, `ex2.approx`,
// scale * log2 e folded into the logits); P stays unnormalised and unrounded
// beyond its split. Each tile's P V is summed from zero on the tensor cores
// and added to O with an FMA, and the output is scaled by 1 / (the float32 row
// sum) at the end.
//
// Tried on an H100 and not kept (PERF.md): two warpgroups on a 128-query tile
// sharing one split pass of K and V (5% slower at batch 8, 26% at one image).
//
// Semantics follow the plain math path (texocr_tpu_torch/ops/attention_core.py):
// logits and softmax in float32; a key is masked when col >= kv_lens[b] or, if
// causal, col > row (top-left aligned; callers only ask for causal with Nq == Nk);
// masked logits are filled with -FLT_MAX, so a row with no valid key softmaxes to
// uniform over all Nk keys. Keys past Nk are excluded outright (-inf). Key tiles
// that no row of a block may attend are skipped only when some key is valid.
// Accumulation is float32 and the output has q's type and q's strides.
//
// One deliberate difference in precision: the TPU kernel and the math path round
// the normalised probabilities P to the input type before the PV product (an
// online softmax knows the normaliser only after the last key tile). In float32
// the kernel keeps P unnormalised and unrounded (beyond its 3xTF32 split), and
// agrees with the math path to rounding. In bfloat16 the tensor-core kernel
// rounds P to bf16 unnormalised, against the running max, and divides by the
// float32 row sum (of the unrounded P) at the end; its error against float32 is
// of the size of the math path's.
//
// bfloat16 rows of any alignment: when q, k and v all start on 16 bytes and
// their batch, head and row strides are multiples of 8 elements, the tiles load
// with 16-byte `cp.async` (the last chunk of a row copies only its 2 (dh - 8c)
// bytes and zero-fills the rest). Otherwise (dh or a stride off the 8-element
// grid, a pointer off 16 bytes) a second instantiation reads each chunk element
// by element and stores it to the same swizzled place; those loads do not
// overlap the math. The launch picks one; both give the same bits.
//
// The bfloat16 forward has a third template switch, LSE: the instantiation that
// also writes each row's base-2 log-sum-exp for the backward. Only a call that
// will be differentiated launches it (dh <= 64); every other call launches the
// instantiation without it.
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

constexpr int BLOCK_Q = 64;
constexpr int BLOCK_K = 64;

struct Strides {
  long long b, h, n;  // the last (dh) stride is 1
};

struct Args {
  const void *q, *k, *v;
  void* o;
  const int* kv_lens;
  int batch, heads, nq, nk, dh;
  Strides qs, ks, vs, os;
  float scale;
  int causal;
  cudaStream_t stream;
  float* lse;  // (B, H, lse_rows(Nq)) float32, or null: the forward's row statistics
};

// Lets `kernel` use `bytes` of dynamic shared memory. `done` (one bit per
// device) belongs to the kernel's instantiation, so cudaFuncSetAttribute runs
// once per instantiation and device, not on every launch.
cudaError_t allow_dynamic_smem(std::atomic<unsigned long long>& done, const void* kernel,
                               int bytes) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (device & 63);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

// ---------------------------------------------------------------------------
// bfloat16: wgmma kernel
// ---------------------------------------------------------------------------

constexpr int WG_THREADS = 128;  // one warpgroup
constexpr int SUB_BYTES = 64 * 128;  // 64 rows x 64 bf16: one 128-byte-swizzle sub-tile

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy global -> shared; src_bytes = 0 zero-fills.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Tile rows [row0, row0 + 64) of a (rows, dh) bf16 matrix (row stride
// `row_stride`, unit column stride) into shared memory at `dst` as D/64
// sub-tiles of 64 rows x 128 bytes, each 1024-byte aligned, with the 16-byte
// chunk c of row r stored at chunk c ^ (r % 8): the 128-byte swizzle that the
// wgmma descriptors below name. Rows >= rows_total and columns >= dh read as 0.
// VEC: rows start on 16 bytes, each chunk is one asynchronous copy. Otherwise
// each chunk is read element by element and stored synchronously.
template <int D, bool VEC>
__device__ __forceinline__ void load_tile_bf16(uint32_t dst, const __nv_bfloat16* src,
                                               long long row_stride, int row0, int rows_total,
                                               int dh) {
  constexpr int CHUNKS = D / 8;  // 16-byte chunks per row
  constexpr int PER_THREAD = 64 * CHUNKS / WG_THREADS;
  // The element-wise loop stays rolled: unrolled, all its loads would be in
  // flight at once and spill registers at D = 128.
#pragma unroll(VEC ? PER_THREAD : 1)
  for (int i = 0; i < PER_THREAD; ++i) {
    const int idx = threadIdx.x + WG_THREADS * i;
    const int r = idx / CHUNKS;
    const int c = idx % CHUNKS;
    const int row = row0 + r;
    const int n = row < rows_total ? min(max(dh - 8 * c, 0), 8) : 0;  // elements to read
    const __nv_bfloat16* g = n > 0 ? src + row * row_stride + c * 8 : src;
    const uint32_t s = dst + (c / 8) * SUB_BYTES + r * 128 + (((c % 8) ^ (r % 8)) << 4);
    if constexpr (VEC) {
      cp_async16(s, g, 2 * n);
    } else {
      const unsigned short* e = reinterpret_cast<const unsigned short*>(g);
      uint32_t w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t lo = 2 * j < n ? e[2 * j] : 0u;
        const uint32_t hi = 2 * j + 1 < n ? e[2 * j + 1] : 0u;
        w[j] = lo | (hi << 16);
      }
      asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(s), "r"(w[0]), "r"(w[1]),
                   "r"(w[2]), "r"(w[3])
                   : "memory");
    }
  }
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lead_bytes,
                                              uint32_t stride_bytes) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lead_bytes >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((stride_bytes >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pins the registers of an asynchronous wgmma operand in program order, so the
// compiler neither reads an accumulator before the wait nor writes one after
// the fence.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define WG_ACC32                                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define WG_ACC32_ARGS(d)                                                                      \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),         \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),           \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),           \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

// d (64 x 64, f32) = A B (+ d if accumulate): A and B from shared memory, both
// K-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_ACC32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_ACC32_ARGS(d)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (64 x 64, f32) += A B: A (64 x 16 bf16) from registers, B from shared
// memory, MN-major (transposed).
__device__ __forceinline__ void wgmma_rs_bt(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_ACC32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_ACC32_ARGS(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// 2^x in one MUFU instruction (relative error <= 2^-22; 2^-inf = 0). exp2f
// without --use_fast_math adds range handling around it, and the softmax's
// exponentials are a large share of the kernel's instructions.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Stores a 64 x 64 float32 accumulator fragment, each of this thread's two rows
// (row_lo, row_lo + 8) times its factor in `mul`, as bf16 into the (rows, dh)
// matrix at `base` (row stride `stride`); rows >= rows_total and columns >= dh
// are not written. Column pairs store as one 4-byte word where rows start on 4
// bytes and dh is even (col is even, so col < dh then covers col + 1). One
// test per block: a test per pair made the 17-query call 11% slower on an H100.
__device__ __forceinline__ void store_tile_bf16(const float (&acc)[32], __nv_bfloat16* base,
                                                long long stride, int row_lo, int rows_total,
                                                int dh, const float (&mul)[2]) {
  const int col_q = 2 * (threadIdx.x % 4);
  const bool pairs =
      reinterpret_cast<uintptr_t>(base) % 4 == 0 && stride % 2 == 0 && dh % 2 == 0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_lo + 8 * r;
    if (row >= rows_total) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 8 * j + col_q;
      const float lo = acc[4 * j + 2 * r] * mul[r];
      const float hi = acc[4 * j + 2 * r + 1] * mul[r];
      __nv_bfloat16* dst = base + row * stride + col;
      if (pairs) {
        if (col < dh) *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(lo, hi);
      } else {
        if (col < dh) dst[0] = __float2bfloat16_rn(lo);
        if (col + 1 < dh) dst[1] = __float2bfloat16_rn(hi);
      }
    }
  }
}

// Accumulator layout of wgmma m64nNk16 (f32): thread t of the warpgroup holds,
// for register i, row 16 * (t / 32) + (t % 32) / 4 + 8 * ((i / 2) % 2) and
// column 8 * (i / 4) + 2 * (t % 4) + i % 2. So each thread holds two rows, and
// each row's columns are spread over the 4 threads of a quad.
//
// LSE: also writes each row's log-sum-exp in base 2, m + log2(l) of the
// scaled logits, to lse[(b, h, row)] for every row of the block's 64 (rows
// past Nq included: their zero queries give finite values), in a
// (B, H, gridDim.x * 64) float32 buffer. The backward's P is exp2 of the
// scaled logit less it.
template <int D, bool VEC, bool LSE>
__global__ void __launch_bounds__(WG_THREADS)
flash_fwd_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
               const int* __restrict__ kv_lens, int nq, int nk, int dh, Strides qs, Strides ks,
               Strides vs, Strides os, float scale_log2, int causal, float* __restrict__ lse) {
  constexpr int SUB = D / 64;  // 64-column sub-tiles per row
  constexpr int TILE = SUB * SUB_BYTES;  // one 64 x D tile
  constexpr int KSTEPS = D / 16;  // k16 steps of Q K^T
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // The swizzle acts on address bits, so every sub-tile starts on 1024 bytes.
  const uint32_t q_s = (smem_addr(smem_raw) + 1023u) & ~1023u;
  // Stage s of the ring: K at q_s + TILE * (1 + 2 s), V right after it.

  const int q0 = blockIdx.x * BLOCK_Q;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row_lo = q0 + 16 * warp + lane / 4;  // rows row_lo and row_lo + 8
  const int col_q = 2 * (lane % 4);

  int kv_len = nk;
  if (kv_lens != nullptr) kv_len = min(max(kv_lens[b], 0), nk);
  int k_end = nk;
  if (kv_len > 0) {
    k_end = kv_len;
    if (causal) k_end = min(k_end, q0 + BLOCK_Q);
  }
  const int n_tiles = (k_end + BLOCK_K - 1) / BLOCK_K;

  const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* kb = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + h * vs.h;
  load_tile_bf16<D, VEC>(q_s, qb, qs.n, q0, nq, dh);
  load_tile_bf16<D, VEC>(q_s + TILE, kb, ks.n, 0, nk, dh);
  load_tile_bf16<D, VEC>(q_s + 2 * TILE, vb, vs.n, 0, nk, dh);
  cp_async_commit();

  float s[32];
  float acc[SUB][32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    s[i] = 0.f;
#pragma unroll
    for (int n = 0; n < SUB; ++n) acc[n][i] = 0.f;
  }
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};  // this thread's partial row sums

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BLOCK_K;
    if (t + 1 < n_tiles) {  // the next tile's copies fly during this tile's math
      const uint32_t next = q_s + TILE * (1 + 2 * ((t + 1) & 1));
      load_tile_bf16<D, VEC>(next, kb, ks.n, k0 + BLOCK_K, nk, dh);
      load_tile_bf16<D, VEC>(next + TILE, vb, vs.n, k0 + BLOCK_K, nk, dh);
    }
    cp_async_commit();  // possibly empty, so that one wait count fits every step
    cp_async_wait<1>();  // this tile's copies (and Q's) have landed
    // Written by this thread's copies (or stores), read by the tensor cores:
    // make the writes visible to the async proxy, then to the whole warpgroup.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    const uint32_t k_s = q_s + TILE * (1 + 2 * (t & 1));
    const uint32_t v_s = k_s + TILE;

    // S = Q K^T
    pin(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      const uint32_t off = (kk / 4) * SUB_BYTES + (kk % 4) * 32;
      wgmma_ss(s, smem_desc(q_s + off, 16, 1024), smem_desc(k_s + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    pin(s);

    // Online softmax on the accumulator layout, base 2.
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] *= scale_log2;
    if (k0 + BLOCK_K > kv_len || (causal && k0 + BLOCK_K - 1 > q0)) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int row = row_lo + 8 * ((i / 2) % 2);
        const int col = k0 + 8 * (i / 4) + col_q + i % 2;
        if (col >= nk) {
          s[i] = -INFINITY;
        } else if (col >= kv_len || (causal && col > row)) {
          s[i] = -FLT_MAX;
        }
      }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 32; ++i) mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], s[i]);
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // The tile's first key is < nk, so mx >= -FLT_MAX is finite and no
      // (-inf) - (-inf) arises; the first tile's alpha is exp2(-inf) = 0.
      const float m_new = fmaxf(m_run[r], mx[r]);
      alpha[r] = exp2_approx(m_run[r] - m_new);
      m_run[r] = m_new;
    }
    float row_sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i / 2) % 2;
      s[i] = exp2_approx(s[i] - m_run[r]);
      row_sum[r] += s[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + row_sum[r];
#pragma unroll
    for (int n = 0; n < SUB; ++n)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[n][i] *= alpha[(i / 2) % 2];

    // P in bf16 as the register A operand: keys 16 kk .. 16 kk + 15 are S's
    // accumulator registers 8 kk .. 8 kk + 7, in order.
    uint32_t p[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) p[kk][j] = pack_bf16(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1]);

    // O += P V
#pragma unroll
    for (int n = 0; n < SUB; ++n) pin(acc[n]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) pin(p[kk]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int n = 0; n < SUB; ++n)
        wgmma_rs_bt(acc[n], p[kk], smem_desc(v_s + n * SUB_BYTES + kk * 16 * 128, SUB_BYTES, 1024));
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int n = 0; n < SUB; ++n) pin(acc[n]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) pin(p[kk]);
    __syncthreads();  // this stage is free for tile t + 2's copies
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[r] = 1.f / l;
    if constexpr (LSE) {
      if (lane % 4 == 0)
        lse[((long long)b * gridDim.y + h) * gridDim.x * BLOCK_Q + row_lo + 8 * r] =
            m_run[r] + log2f(l);
    }
  }
  __nv_bfloat16* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int n = 0; n < SUB; ++n)
    store_tile_bf16(acc[n], ob + 64 * n, os.n, row_lo, nq, dh - 64 * n, inv);
}

template <int D, bool VEC, bool LSE>
cudaError_t launch_bf16(const Args& a) {
  constexpr int smem = 5 * 64 * D * 2 + 1024;  // Q, 2 x (K, V), alignment slack
  static std::atomic<unsigned long long> smem_set{0};
  cudaError_t err = allow_dynamic_smem(
      smem_set, reinterpret_cast<const void*>(flash_fwd_bf16<D, VEC, LSE>), smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.nq + BLOCK_Q - 1) / BLOCK_Q, a.heads, a.batch);
  flash_fwd_bf16<D, VEC, LSE><<<grid, WG_THREADS, smem, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v), static_cast<__nv_bfloat16*>(a.o), a.kv_lens, a.nq,
      a.nk, a.dh, a.qs, a.ks, a.vs, a.os, a.scale * 1.4426950408889634f, a.causal, a.lse);
  return cudaGetLastError();
}

// Whether an operand's rows all start on 16 bytes (`per16` elements).
bool rows_aligned16(const void* p, const Strides& st, int per16 = 8) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && st.b % per16 == 0 && st.h % per16 == 0 &&
         st.n % per16 == 0;
}

// ---------------------------------------------------------------------------
// bfloat16 backward: two wgmma kernels, dQ and then dK with dV
// ---------------------------------------------------------------------------
//
// Replaces no Pallas kernel: the JAX package differentiates its flash forward
// through XLA's VJP of the math path (`_fad_bwd`), and the port did the same
// until this kernel, materialising the (B, H, Nq, Nk) float32 scores and their
// gradients off the tensor cores. What bounds it: five products of
// 2 Nq Nk dh per (batch, head) (S = Q K^T for P, dP = dO V^T, dV = P^T dO,
// dQ = dS K, dK = dS^T Q) on (4 Nq + 4 Nk) dh elements moved, so at the
// encoder's N = 631, dh = 64 it is bound by operations, 10 Nq Nk dh at
// 989 TFLOP/s: 0.264 ms at (128, 8, 631, 64) on an H100 SXM.
//
// The design answers it as the forward does: every product on the tensor cores
// (`wgmma` m64n64k16, bf16 in, float32 accumulate), 64-row tiles in 128-byte
// swizzled shared memory filled by 16-byte `cp.async` copies through a
// double-buffered ring, and no score tile ever in device memory or shared
// memory. P is recomputed from the forward's saved base-2 row log-sum-exp (the
// LSE instantiation of `flash_fwd_bf16`) as exp2(S scale log2 e - LSE), one
// `ex2.approx` each. Two launches and no atomics, so the gradients are
// bit-reproducible and need no float32 scratch:
//
// A, `flash_bwd_dq_bf16`, one warpgroup per (64-query tile, head, batch): Q and
// dO stay in shared memory; the block first writes D = rowsum(dO o O) in
// float32 (for launch B too), then walks K and V in 64-key tiles:
// S = Q K^T and dP = dO V^T from shared memory, P, dS = P o (dP - D) in
// registers, and dQ += dS K with dS rounded to bf16 and fed from registers as
// the A operand (the accumulator fragment is the register A fragment, as the
// forward feeds P) and K read MN-major with the transpose bit, as the forward
// reads V.
//
// B, `flash_bwd_dkdv_bf16`, one warpgroup per (64-key tile, head, batch): K and
// V stay in shared memory; it walks Q, dO, LSE and D in 64-query tiles and forms
// the transposed products S^T = K Q^T and dP^T = V dO^T, so that P^T and dS^T
// come out in the accumulator layout, which is the register A fragment of
// dV += P^T dO and dK += dS^T Q (dO and Q read MN-major).
//
// So S and dP are formed twice (7 products in place of 5). Precision: sums,
// LSE and D in float32; P rounded to bf16 for dV as the math path rounds its
// probabilities; dS rounded to bf16 as the A operand of dQ and dK, the one
// rounding the math path does not make (its dP is rounded to bf16 instead).
// Outputs in bf16 with their own strides. dh <= 64 (zero-filled as the
// forward does), causal only with Nq == Nk (top-left aligned). The LSE and D
// buffers are (B, H, Npad) float32 with Npad = Nq rounded up to 64, so every
// query tile reads them whole with 16-byte copies; rows past Nq hold finite
// values (zero queries) and meet zero dO rows, so they add nothing.

// Two bf16 from one 32-bit word, as float32.
__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// d (64 x 64) = A B^T over D = 64 (4 k16 steps), both 64 x 64 bf16 tiles in
// shared memory, K-major (the forward's S = Q K^T).
__device__ __forceinline__ void wgmma_abt(float (&d)[32], uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_ss(d, smem_desc(a + kk * 32, 16, 1024), smem_desc(b + kk * 32, 16, 1024), kk > 0);
}

// d (64 x 64) += A B: A (64 x 64) in registers as four k16 fragments, B a
// 64 x 64 bf16 tile in shared memory read MN-major (the forward's O += P V).
__device__ __forceinline__ void wgmma_ab(float (&d)[32], const uint32_t (&a)[4][4], uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs_bt(d, a[kk], smem_desc(b + kk * 16 * 128, SUB_BYTES, 1024));
}

// A 64 x 64 fragment rounded to bf16 as four register A fragments: keys (or
// queries) 16 kk .. 16 kk + 15 are registers 8 kk .. 8 kk + 7, in order.
__device__ __forceinline__ void pack_a(const float (&x)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) a[kk][j] = pack_bf16(x[8 * kk + 2 * j], x[8 * kk + 2 * j + 1]);
}

struct BwdArgs {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  float* delta;
  void *dq, *dk, *dv;
  int batch, heads, nq, nk, dh, npad;
  Strides qs, ks, vs, os, dos, dqs, dks, dvs;
  float scale;
  int causal;
  cudaStream_t stream;
};

constexpr int BWD_TILE = SUB_BYTES;  // one 64 x 64 bf16 tile
constexpr int BWD_SMEM = 6 * BWD_TILE + 2 * 2 * 64 * 4 + 1024;  // 6 tiles, row floats, slack

template <bool VEC>
__global__ void __launch_bounds__(WG_THREADS)
flash_bwd_dq_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ o,
                  const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                  float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int nq, int nk, int dh,
                  int npad, Strides qs, Strides ks, Strides vs, Strides os, Strides dos,
                  Strides dqs, float scale, float scale_log2, int causal) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  uint8_t* const base_ptr = smem_raw + (base - smem_addr(smem_raw));
  // Q, dO, then stage s of the ring: K at base + TILE * (2 + 2 s), V right
  // after it. O lands in stage 1's K slot for D, before the ring needs it.
  const uint32_t q_s = base, do_s = base + BWD_TILE, o_s = base + 4 * BWD_TILE;
  float* const d_rows = reinterpret_cast<float*>(base_ptr + 6 * BWD_TILE);

  const int q0 = blockIdx.x * BLOCK_Q;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row_lo = q0 + 16 * warp + lane / 4;  // rows row_lo and row_lo + 8
  const int col_q = 2 * (lane % 4);
  const long long stat = ((long long)b * gridDim.y + h) * npad;  // this head's LSE and D rows

  const int k_end = causal ? min(nk, q0 + BLOCK_Q) : nk;
  const int n_tiles = (k_end + BLOCK_K - 1) / BLOCK_K;

  const __nv_bfloat16* kb = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + h * vs.h;
  load_tile_bf16<64, VEC>(q_s, q + b * qs.b + h * qs.h, qs.n, q0, nq, dh);
  load_tile_bf16<64, VEC>(do_s, dout + b * dos.b + h * dos.h, dos.n, q0, nq, dh);
  load_tile_bf16<64, VEC>(o_s, o + b * os.b + h * os.h, os.n, q0, nq, dh);
  load_tile_bf16<64, VEC>(base + 2 * BWD_TILE, kb, ks.n, 0, nk, dh);
  load_tile_bf16<64, VEC>(base + 3 * BWD_TILE, vb, vs.n, 0, nk, dh);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // D = rowsum(dO o O): thread t sums half a row (4 of the 8 16-byte chunks).
  {
    const int r = threadIdx.x / 2;
    float sum = 0.f;
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const int c = 4 * (threadIdx.x % 2) + cc;
      const uint32_t off = r * 128 + ((c ^ (r % 8)) << 4);
      uint32_t x[4], y[4];
      asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                   : "=r"(x[0]), "=r"(x[1]), "=r"(x[2]), "=r"(x[3])
                   : "r"(do_s + off));
      asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                   : "=r"(y[0]), "=r"(y[1]), "=r"(y[2]), "=r"(y[3])
                   : "r"(o_s + off));
#pragma unroll
      for (int j = 0; j < 4; ++j)
        sum += bf16_lo(x[j]) * bf16_lo(y[j]) + bf16_hi(x[j]) * bf16_hi(y[j]);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if (threadIdx.x % 2 == 0) {
      d_rows[r] = sum;
      delta[stat + q0 + r] = sum;
    }
  }
  __syncthreads();  // D is in shared memory, and O's slot is free for the ring
  float d_row[2], lse_row[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    d_row[r] = d_rows[row_lo - q0 + 8 * r];
    lse_row[r] = lse[stat + row_lo + 8 * r];
  }

  float s[32], dp[32], acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = acc[i] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BLOCK_K;
    if (t + 1 < n_tiles) {  // the next tile's copies fly during this tile's math
      const uint32_t next = base + BWD_TILE * (2 + 2 * ((t + 1) & 1));
      load_tile_bf16<64, VEC>(next, kb, ks.n, k0 + BLOCK_K, nk, dh);
      load_tile_bf16<64, VEC>(next + BWD_TILE, vb, vs.n, k0 + BLOCK_K, nk, dh);
    }
    cp_async_commit();
    cp_async_wait<1>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const uint32_t k_s = base + BWD_TILE * (2 + 2 * (t & 1));
    const uint32_t v_s = k_s + BWD_TILE;

    // S = Q K^T, then dP = dO V^T, two groups: P is formed while dP runs.
    pin(s);
    pin(dp);
    wgmma_fence();
    wgmma_abt(s, q_s, k_s);
    wgmma_commit();
    wgmma_abt(dp, do_s, v_s);
    wgmma_commit();
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    pin(s);
    const bool edge = k0 + BLOCK_K > nk || (causal && k0 + BLOCK_K - 1 > q0);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i / 2) % 2;
      s[i] = exp2_approx(s[i] * scale_log2 - lse_row[r]);
      if (edge) {
        const int col = k0 + 8 * (i / 4) + col_q + i % 2;
        if (col >= nk || (causal && col > row_lo + 8 * r)) s[i] = 0.f;
      }
    }
    wgmma_wait_all();
    pin(dp);
    // dS = P o (dP - D), the gradient of the scaled logits.
#pragma unroll
    for (int i = 0; i < 32; ++i) dp[i] = s[i] * (dp[i] - d_row[(i / 2) % 2]);
    uint32_t ds[4][4];
    pack_a(dp, ds);

    // dQ += dS K
    pin(acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) pin(ds[kk]);
    wgmma_fence();
    wgmma_ab(acc, ds, k_s);
    wgmma_commit();
    wgmma_wait_all();
    pin(acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) pin(ds[kk]);
    __syncthreads();  // this stage is free for tile t + 2's copies
  }
  const float mul[2] = {scale, scale};
  store_tile_bf16(acc, dq + b * dqs.b + h * dqs.h, dqs.n, row_lo, nq, dh, mul);
}

template <bool VEC>
__global__ void __launch_bounds__(WG_THREADS)
flash_bwd_dkdv_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int nq, int nk,
                    int dh, int npad, Strides qs, Strides ks, Strides vs, Strides dos,
                    Strides dks, Strides dvs, float scale, float scale_log2, int causal) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  uint8_t* const base_ptr = smem_raw + (base - smem_addr(smem_raw));
  // K, V, then stage s of the ring: Q at base + TILE * (2 + 2 s), dO right
  // after it; the stage's 64 LSE and 64 D values at base + 6 TILE + 512 s.
  const uint32_t k_s = base, v_s = base + BWD_TILE;

  const int k0 = blockIdx.x * BLOCK_K;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row_lo = k0 + 16 * warp + lane / 4;  // keys row_lo and row_lo + 8
  const int col_q = 2 * (lane % 4);
  const long long stat = ((long long)b * gridDim.y + h) * npad;

  // Causal (Nq == Nk): queries before the tile's first key attend none of it.
  const int t0 = causal ? k0 / BLOCK_Q : 0;
  const int n_tiles = (nq + BLOCK_Q - 1) / BLOCK_Q;

  const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* dob = dout + b * dos.b + h * dos.h;
  // Stage (t - t0) & 1's tiles of query tile t, and its LSE and D (16 16-byte
  // copies each, by the first 32 threads).
  auto load_stage = [&](int t) {
    const int st = (t - t0) & 1;
    const uint32_t q_dst = base + BWD_TILE * (2 + 2 * st);
    load_tile_bf16<64, VEC>(q_dst, qb, qs.n, t * BLOCK_Q, nq, dh);
    load_tile_bf16<64, VEC>(q_dst + BWD_TILE, dob, dos.n, t * BLOCK_Q, nq, dh);
    if (threadIdx.x < 32) {
      const int c = threadIdx.x % 16;
      const float* src = (threadIdx.x < 16 ? lse : delta) + stat + t * BLOCK_Q + 4 * c;
      cp_async16(base + 6 * BWD_TILE + 512 * st + 256 * (threadIdx.x / 16) + 16 * c, src, 16);
    }
  };
  load_tile_bf16<64, VEC>(k_s, k + b * ks.b + h * ks.h, ks.n, k0, nk, dh);
  load_tile_bf16<64, VEC>(v_s, v + b * vs.b + h * vs.h, vs.n, k0, nk, dh);
  load_stage(t0);
  cp_async_commit();

  float s[32], dp[32], dk_acc[32], dv_acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = dk_acc[i] = dv_acc[i] = 0.f;

  for (int t = t0; t < n_tiles; ++t) {
    const int q0 = t * BLOCK_Q;
    const int st = (t - t0) & 1;
    if (t + 1 < n_tiles) load_stage(t + 1);
    cp_async_commit();
    cp_async_wait<1>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const uint32_t q_st = base + BWD_TILE * (2 + 2 * st);
    const uint32_t do_st = q_st + BWD_TILE;
    const float* lse_st = reinterpret_cast<const float*>(base_ptr + 6 * BWD_TILE + 512 * st);
    const float* d_st = lse_st + 64;

    // S^T = K Q^T, then dP^T = V dO^T.
    pin(s);
    pin(dp);
    wgmma_fence();
    wgmma_abt(s, k_s, q_st);
    wgmma_commit();
    wgmma_abt(dp, v_s, do_st);
    wgmma_commit();
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    pin(s);
    // P^T: column c is query q0 + c, with its LSE.
    const bool edge = q0 + BLOCK_Q > nq || (causal && q0 < k0 + BLOCK_K - 1);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(lse_st + 8 * j + col_q);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e;
        s[i] = exp2_approx(s[i] * scale_log2 - (e % 2 ? l2.y : l2.x));
        if (edge) {
          const int col = q0 + 8 * j + col_q + e % 2;
          if (col >= nq || (causal && row_lo + 8 * (e / 2) > col)) s[i] = 0.f;
        }
      }
    }
    uint32_t pa[4][4];
    pack_a(s, pa);
    // dV += P^T dO runs while dS^T is formed.
    pin(dv_acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) pin(pa[kk]);
    wgmma_fence();
    wgmma_ab(dv_acc, pa, do_st);
    wgmma_commit();
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");  // dP^T is done
    pin(dp);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 d2 = *reinterpret_cast<const float2*>(d_st + 8 * j + col_q);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e;
        dp[i] = s[i] * (dp[i] - (e % 2 ? d2.y : d2.x));
      }
    }
    uint32_t dsa[4][4];
    pack_a(dp, dsa);
    // dK += dS^T Q
    pin(dk_acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) pin(dsa[kk]);
    wgmma_fence();
    wgmma_ab(dk_acc, dsa, q_st);
    wgmma_commit();
    wgmma_wait_all();
    pin(dv_acc);
    pin(dk_acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pin(pa[kk]);
      pin(dsa[kk]);
    }
    __syncthreads();  // this stage is free for tile t + 2's copies
  }
  const float dk_mul[2] = {scale, scale}, dv_mul[2] = {1.f, 1.f};
  store_tile_bf16(dk_acc, dk + b * dks.b + h * dks.h, dks.n, row_lo, nk, dh, dk_mul);
  store_tile_bf16(dv_acc, dv + b * dvs.b + h * dvs.h, dvs.n, row_lo, nk, dh, dv_mul);
}

template <bool VEC>
cudaError_t launch_bwd(const BwdArgs& a) {
  static std::atomic<unsigned long long> dq_set{0}, dkdv_set{0};
  cudaError_t err = allow_dynamic_smem(
      dq_set, reinterpret_cast<const void*>(flash_bwd_dq_bf16<VEC>), BWD_SMEM);
  if (err != cudaSuccess) return err;
  err = allow_dynamic_smem(dkdv_set, reinterpret_cast<const void*>(flash_bwd_dkdv_bf16<VEC>),
                           BWD_SMEM);
  if (err != cudaSuccess) return err;
  using bf = __nv_bfloat16;
  const float scale_log2 = a.scale * 1.4426950408889634f;
  const dim3 grid_q(a.npad / BLOCK_Q, a.heads, a.batch);
  flash_bwd_dq_bf16<VEC><<<grid_q, WG_THREADS, BWD_SMEM, a.stream>>>(
      static_cast<const bf*>(a.q), static_cast<const bf*>(a.k), static_cast<const bf*>(a.v),
      static_cast<const bf*>(a.o), static_cast<const bf*>(a.dout), a.lse, a.delta,
      static_cast<bf*>(a.dq), a.nq, a.nk, a.dh, a.npad, a.qs, a.ks, a.vs, a.os, a.dos, a.dqs,
      a.scale, scale_log2, a.causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_k((a.nk + BLOCK_K - 1) / BLOCK_K, a.heads, a.batch);
  flash_bwd_dkdv_bf16<VEC><<<grid_k, WG_THREADS, BWD_SMEM, a.stream>>>(
      static_cast<const bf*>(a.q), static_cast<const bf*>(a.k), static_cast<const bf*>(a.v),
      static_cast<const bf*>(a.dout), a.lse, a.delta, static_cast<bf*>(a.dk),
      static_cast<bf*>(a.dv), a.nq, a.nk, a.dh, a.npad, a.qs, a.ks, a.vs, a.dos, a.dks, a.dvs,
      a.scale, scale_log2, a.causal);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// float32: 3xTF32 wgmma kernel
// ---------------------------------------------------------------------------

__device__ __forceinline__ float4 ld_shared_f4(uint32_t addr) {
  float4 x;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(x.x), "=f"(x.y), "=f"(x.z), "=f"(x.w)
               : "r"(addr)
               : "memory");
  return x;
}
__device__ __forceinline__ void st_shared_u4(uint32_t addr, uint32_t a, uint32_t b, uint32_t c,
                                             uint32_t d) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(a), "r"(b), "r"(c),
               "r"(d)
               : "memory");
}

// x = big + small + O(2^-22 |x|): big = tf32(x) (10 mantissa bits, ties away
// from zero, low 13 bits zero), small = tf32(x - big); x - big is exact.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(big) : "f"(x));
  big &= 0xffffe000u;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(small) : "f"(x - __uint_as_float(big)));
}

// Byte offset of 16-byte chunk c (floats 4c .. 4c + 3) of row r in a raw
// 64 x D float32 tile. Q and K (V_RAW false): the wgmma K-major layout, 64-row x
// 32-float sub-tiles, 128-byte swizzle, as in bfloat16. V (V_RAW true): rows of
// 4D bytes, chunk c at c ^ 2 ((r / 8) % 4), so that the transposing split pass
// reads 8 different banks in each quarter warp.
template <int D, bool V_RAW>
__device__ __forceinline__ uint32_t f32_chunk(uint32_t r, uint32_t c) {
  if constexpr (V_RAW) return r * (4 * D) + ((c ^ (2 * ((r / 8) % 4))) << 4);
  return (c / 8) * SUB_BYTES + r * 128 + (((c % 8) ^ (r % 8)) << 4);
}

// Rows [row0, row0 + 64) of a (rows, dh) float32 matrix into a raw tile at
// `dst`; rows >= rows_total and columns >= dh read as 0. vec: rows start on 16
// bytes, each chunk is one asynchronous copy (a row's last chunk copies only its
// floats inside dh). Otherwise each chunk is read element by element and stored
// synchronously. Thread `tid` copies chunk tid % (D / 4) of every
// (128 / (D / 4))-th row.
//
// `tid` is threadIdx.x made opaque to the compiler once per key tile by the
// caller: from threadIdx.x itself the compiler hoists every loader's and split
// pass's addresses out of the key loop and holds them in registers, which
// spilled at D = 128.
template <int D, bool V_RAW>
__device__ __forceinline__ void load_tile_f32(uint32_t dst, const float* src, long long row_stride,
                                              int row0, int rows_total, int dh, bool vec,
                                              uint32_t tid) {
  constexpr uint32_t CHUNKS = D / 4;  // 16-byte chunks per row
  constexpr uint32_t STEP = WG_THREADS / CHUNKS;  // rows apart of one thread's chunks
  const uint32_t c = tid % CHUNKS;
  const uint32_t r0 = tid / CHUNKS;
  const int n = min(max(dh - 4 * (int)c, 0), 4);  // floats of the chunk inside dh
  const float* g = src + (long long)(row0 + (int)r0) * row_stride + 4 * c;
  if (vec) {
#pragma unroll
    for (uint32_t i = 0; i < 64 / STEP; ++i) {
      const uint32_t r = r0 + STEP * i;
      const bool in = row0 + (int)r < rows_total && n > 0;
      cp_async16(dst + f32_chunk<D, V_RAW>(r, c), in ? g : src, in ? 4 * n : 0);
      g += STEP * row_stride;
    }
  } else {
#pragma unroll 1
    for (uint32_t i = 0; i < 64 / STEP; ++i) {
      const uint32_t r = r0 + STEP * i;
      const int m = row0 + (int)r < rows_total ? n : 0;
      const uint32_t* e = reinterpret_cast<const uint32_t*>(m > 0 ? g : src);
      uint32_t w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) w[j] = j < m ? e[j] : 0u;
      st_shared_u4(dst + f32_chunk<D, V_RAW>(r, c), w[0], w[1], w[2], w[3]);
      g += STEP * row_stride;
    }
  }
}

// Splits a 64 x D tile in place into its big part, and writes its small part
// to `small` at the same offsets (the split is element-wise, so any order of
// the chunks serves; this one is free of bank conflicts).
template <int D>
__device__ __forceinline__ void split_tile(uint32_t big, uint32_t small, uint32_t tid) {
  constexpr int PER_THREAD = 64 * D / 4 / WG_THREADS;
#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i) {
    const uint32_t off = 16 * (tid + WG_THREADS * i);
    const float4 x = ld_shared_f4(big + off);
    uint32_t b[4], s[4];
    split_tf32(x.x, b[0], s[0]);
    split_tf32(x.y, b[1], s[1]);
    split_tf32(x.z, b[2], s[2]);
    split_tf32(x.w, b[3], s[3]);
    st_shared_u4(big + off, b[0], b[1], b[2], b[3]);
    st_shared_u4(small + off, s[0], s[1], s[2], s[3]);
  }
}

// Splits the raw V tile (64 keys x D, `f32_chunk<D, true>`) into V^T big and
// small: D rows (dh) x 64 keys, K-major, row n of key sub-tile ks (keys
// 32 ks .. 32 ks + 31) in 64-row x 128-byte sub-tile 2 (n / 64) + ks, with the
// 128-byte swizzle; within each 8 keys, positions 0-3 hold keys 0, 2, 4, 6 and
// positions 4-7 keys 1, 3, 5, 7. Each thread moves 8 keys x 4 columns per pass:
// 8 reads and 8 + 8 writes of 16 bytes, each hitting 8 different bank groups
// in every quarter warp.
template <int D>
__device__ __forceinline__ void split_v_transposed(uint32_t raw, uint32_t vt_big,
                                                   uint32_t vt_small, uint32_t tid) {
  const uint32_t bit = tid & 1;
  const uint32_t grp = (tid >> 1) & 3;  // 8-key group g = 4 * half + grp
  const uint32_t half = (tid >> 3) & 1;  // key sub-tile
  const uint32_t hc = tid >> 4;
#pragma unroll
  for (uint32_t pass = 0; pass < D / 64; ++pass) {
    const uint32_t cg = 16 * pass + 2 * hc + bit;  // columns 4 cg .. 4 cg + 3
    float x[8][4];
#pragma unroll
    for (uint32_t key = 0; key < 8; ++key) {
      const float4 r = ld_shared_f4(raw + f32_chunk<D, true>(8 * (4 * half + grp) + key, cg));
      x[key][0] = r.x;
      x[key][1] = r.y;
      x[key][2] = r.z;
      x[key][3] = r.w;
    }
#pragma unroll
    for (uint32_t j = 0; j < 4; ++j) {
      const uint32_t n = 4 * cg + j;
      const uint32_t row = ((n / 64) * 2 + half) * SUB_BYTES + (n % 64) * 128;
#pragma unroll
      for (uint32_t s = 0; s < 2; ++s) {
        const uint32_t parity = s ^ bit;  // even keys or odd keys
        const uint32_t off = row + (((2 * grp + parity) ^ (n % 8)) << 4);
        uint32_t b[4], sm[4];
        // A select, not x[2 e + parity]: a register array takes no runtime index.
#pragma unroll
        for (int e = 0; e < 4; ++e)
          split_tf32(parity ? x[2 * e + 1][j] : x[2 * e][j], b[e], sm[e]);
        st_shared_u4(vt_big + off, b[0], b[1], b[2], b[3]);
        st_shared_u4(vt_small + off, sm[0], sm[1], sm[2], sm[3]);
      }
    }
  }
}

// d (64 x 64, f32) = A B (+ d if accumulate), TF32: A and B from shared memory,
// both K-major.
__device__ __forceinline__ void wgmma_ss_tf32(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " WG_ACC32 ", %32, %33, p, 1, 1;\n}\n"
      : WG_ACC32_ARGS(d)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (64 x 64, f32) = A B (+ d if accumulate), TF32: A (64 x 8) from
// registers, B from shared memory, K-major.
__device__ __forceinline__ void wgmma_rs_tf32(float (&d)[32], uint32_t a0, uint32_t a1,
                                              uint32_t a2, uint32_t a3, uint64_t desc_b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " WG_ACC32
      ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : WG_ACC32_ARGS(d)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(accumulate));
}

// O += P V for one part of P (registers, as S's accumulator fragment) and one
// part of V^T. The TF32 A fragment of k-step kk (keys 8 kk .. 8 kk + 7) gives
// thread t rows r and r + 8 (r = 16 (t / 32) + (t % 32) / 4) at columns c and
// c + 4 (c = t % 4), in the order (r, c), (r + 8, c), (r, c + 4), (r + 8, c + 4);
// S's registers 4 kk .. 4 kk + 3 hold (r, 2c), (r, 2c + 1), (r + 8, 2c),
// (r + 8, 2c + 1), which are those places once V^T's keys are in the order
// `split_v_transposed` stores them.
template <int SUB>
__device__ __forceinline__ void wgmma_pv_tf32(float (&acc)[SUB][32], const uint32_t (&p)[32],
                                              uint32_t vt) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int n = 0; n < SUB; ++n)
      wgmma_rs_tf32(acc[n], p[4 * kk], p[4 * kk + 2], p[4 * kk + 1], p[4 * kk + 3],
                    smem_desc(vt + (2 * n + kk / 4) * SUB_BYTES + (kk % 4) * 32, 16, 1024), 1);
}

template <int D>
__global__ void __launch_bounds__(WG_THREADS)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o,
              const int* __restrict__ kv_lens, int nq, int nk, int dh, Strides qs, Strides ks,
              Strides vs, Strides os, float scale_log2, int causal, int vec) {
  constexpr int SUB = D / 64;  // 64-column blocks of O
  constexpr int TILE = 64 * D * 4;  // one 64 x D float32 tile
  constexpr int KSTEPS = D / 8;  // k8 steps of Q K^T
  // At D = 64 Q's parts live in registers (the note at the top). Tile offsets
  // from the base; Q's raw tile lands at Q_RAW.
  constexpr bool Q_REGS = D == 64;
  constexpr int Q_TILES = Q_REGS ? 0 : 2;
  constexpr int Q_SMALL = TILE, K_BIG = Q_TILES * TILE, K_SMALL = K_BIG + TILE,
                VT_BIG = K_BIG + 2 * TILE, VT_SMALL = K_BIG + 3 * TILE, V_RAW = K_BIG + 4 * TILE,
                Q_RAW = Q_REGS ? VT_BIG : 0;  // V^T is written first after Q is read
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // The swizzle acts on address bits, so every sub-tile starts on 1024 bytes.
  const uint32_t smem = (smem_addr(smem_raw) + 1023u) & ~1023u;

  const int q0 = blockIdx.x * BLOCK_Q;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row_lo = q0 + 16 * warp + lane / 4;  // rows row_lo and row_lo + 8
  const int col_q = 2 * (lane % 4);

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
  const int n_tiles = (k_end + BLOCK_K - 1) / BLOCK_K;

  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;
  load_tile_f32<D, false>(smem + Q_RAW, qb, qs.n, q0, nq, dh, vec, threadIdx.x);
  load_tile_f32<D, false>(smem + K_BIG, kb, ks.n, 0, nk, dh, vec, threadIdx.x);
  load_tile_f32<D, true>(smem + V_RAW, vb, vs.n, 0, nk, dh, vec, threadIdx.x);
  cp_async_commit();

  float s[32];
  float acc[SUB][32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    s[i] = 0.f;
#pragma unroll
    for (int n = 0; n < SUB; ++n) acc[n][i] = 0.f;
  }
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};  // this thread's partial row sums
  // Q's A fragments (Q_REGS): k-step kk in registers 4 kk .. 4 kk + 3, as in
  // `wgmma_pv_tf32`'s note: (r, c), (r + 8, c), (r, c + 4), (r + 8, c + 4) of
  // columns 8 kk .. 8 kk + 7.
  uint32_t qa_big[Q_REGS ? 4 * KSTEPS : 1], qa_small[Q_REGS ? 4 * KSTEPS : 1];

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BLOCK_K;
    uint32_t tid = threadIdx.x;
    asm volatile("" : "+r"(tid));  // see load_tile_f32
    const uint32_t q_big = smem, q_small = smem + Q_SMALL, k_big = smem + K_BIG,
                   k_small = smem + K_SMALL, vt_big = smem + VT_BIG, vt_small = smem + VT_SMALL,
                   v_raw = smem + V_RAW;
    if (t == 0) {
      cp_async_wait<0>();  // Q and the first K and V have landed
      __syncthreads();
      if constexpr (Q_REGS) {
#pragma unroll
        for (int i = 0; i < 4 * KSTEPS; ++i) {
          const uint32_t row = 16 * warp + lane / 4 + 8 * (i % 2);
          const uint32_t col = 8 * (i / 4) + lane % 4 + 4 * ((i / 2) % 2);
          float x;
          asm volatile("ld.shared.f32 %0, [%1];\n"
                       : "=f"(x)
                       : "r"(smem + Q_RAW + f32_chunk<D, false>(row, col / 4) + 4 * (col % 4)));
          split_tf32(x, qa_big[i], qa_small[i]);
        }
        __syncthreads();  // Q's raw tile lies where V^T's big part goes
      } else {
        split_tile<D>(q_big, q_small, tid);
      }
      split_tile<D>(k_big, k_small, tid);  // later tiles' K is split during P V
    }
    // Written by this thread's stores, read by the tensor cores: make the
    // writes visible to the async proxy, then to the whole warpgroup.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    // S = Q K^T = Qs Kb + Qb Ks + Qb Kb
    pin(s);
    wgmma_fence();
#pragma unroll
    for (int part = 0; part < 3; ++part) {
      const uint32_t qp = part == 0 ? q_small : q_big;
      const uint32_t kp = part == 1 ? k_small : k_big;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        const uint32_t off = (kk / 4) * SUB_BYTES + (kk % 4) * 32;
        if constexpr (Q_REGS) {
          const uint32_t(&qa)[4 * KSTEPS] = part == 0 ? qa_small : qa_big;
          wgmma_rs_tf32(s, qa[4 * kk], qa[4 * kk + 1], qa[4 * kk + 2], qa[4 * kk + 3],
                        smem_desc(kp + off, 16, 1024), part > 0 || kk > 0);
        } else {
          wgmma_ss_tf32(s, smem_desc(qp + off, 16, 1024), smem_desc(kp + off, 16, 1024),
                        part > 0 || kk > 0);
        }
      }
    }
    wgmma_commit();
    // V's split pass runs while the tensor cores form S.
    split_v_transposed<D>(v_raw, vt_big, vt_small, tid);
    wgmma_wait_all();
    pin(s);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // no warp reads K or raw V any more, and V^T is written
    if (t + 1 < n_tiles) {  // the next K and V fly during the softmax and P V
      load_tile_f32<D, false>(k_big, kb, ks.n, k0 + BLOCK_K, nk, dh, vec, tid);
      load_tile_f32<D, true>(v_raw, vb, vs.n, k0 + BLOCK_K, nk, dh, vec, tid);
      cp_async_commit();
    }

    // Online softmax on the accumulator layout, as in bfloat16, base 2.
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] *= scale_log2;
    if (k0 + BLOCK_K > kv_len || (causal && k0 + BLOCK_K - 1 > q0)) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int row = row_lo + 8 * ((i / 2) % 2);
        const int col = k0 + 8 * (i / 4) + col_q + i % 2;
        if (col >= nk) {
          s[i] = -INFINITY;
        } else if (col >= kv_len || (causal && col > row)) {
          s[i] = -FLT_MAX;
        }
      }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 32; ++i) mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], s[i]);
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // The tile's first key is < nk, so mx >= -FLT_MAX is finite and no
      // (-inf) - (-inf) arises; the first tile's alpha is exp2(-inf) = 0.
      const float m_new = fmaxf(m_run[r], mx[r]);
      alpha[r] = exp2_approx(m_run[r] - m_new);
      m_run[r] = m_new;
    }
    float row_sum[2] = {0.f, 0.f};
    uint32_t p_big[32], p_small[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i / 2) % 2;
      const float p = exp2_approx(s[i] - m_run[r]);
      row_sum[r] += p;
      split_tf32(p, p_big[i], p_small[i]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + row_sum[r];
    // P V = Ps Vb + Pb Vs + Pb Vb, summed from zero and added to O with an FMA:
    // the tensor cores' float32 sums round less exactly than an FMA, and
    // accumulating into the running O tile after tile put the output 3.8e-6
    // from float64 at (8, 8, 631, 64) on an H100, against 7.8e-7 this way.
    float pv[SUB][32];
#pragma unroll
    for (int n = 0; n < SUB; ++n)
#pragma unroll
      for (int i = 0; i < 32; ++i) pv[n][i] = 0.f;
#pragma unroll
    for (int n = 0; n < SUB; ++n) pin(pv[n]);
    pin(p_big);
    pin(p_small);
    wgmma_fence();
    wgmma_pv_tf32<SUB>(pv, p_small, vt_big);
    wgmma_pv_tf32<SUB>(pv, p_big, vt_small);
    wgmma_pv_tf32<SUB>(pv, p_big, vt_big);
    wgmma_commit();
    if (t + 1 < n_tiles) {  // the next K's split pass runs while the tensor cores form P V
      cp_async_wait<0>();  // the next K and V have landed
      __syncthreads();
      split_tile<D>(k_big, k_small, tid);
    }
    wgmma_wait_all();
#pragma unroll
    for (int n = 0; n < SUB; ++n) pin(pv[n]);
#pragma unroll
    for (int n = 0; n < SUB; ++n)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[n][i] = fmaf(acc[n][i], alpha[(i / 2) % 2], pv[n][i]);
    pin(p_big);
    pin(p_small);
  }

  float* ob = o + b * os.b + h * os.h;
  // Column pairs store as one 8-byte word where o's rows start on 8 bytes and
  // dh is even (col is even, so col < dh then covers col + 1).
  const bool pairs = reinterpret_cast<uintptr_t>(ob) % 8 == 0 && os.n % 2 == 0 && dh % 2 == 0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.f / l;
    const int row = row_lo + 8 * r;
    if (row >= nq) continue;
#pragma unroll
    for (int n = 0; n < SUB; ++n)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * n + 8 * j + col_q;
        const float lo = acc[n][4 * j + 2 * r] * inv;
        const float hi = acc[n][4 * j + 2 * r + 1] * inv;
        float* dst = ob + row * os.n + col;
        if (pairs) {
          if (col < dh) *reinterpret_cast<float2*>(dst) = make_float2(lo, hi);
        } else {
          if (col < dh) dst[0] = lo;
          if (col + 1 < dh) dst[1] = hi;
        }
      }
  }
}

template <int D>
constexpr int f32_smem_bytes() {
  // K, V^T big and small, raw V, Q big and small at D = 128, alignment slack
  return (D == 64 ? 5 : 7) * 64 * D * 4 + 1024;
}

template <int D>
cudaError_t launch_f32(const Args& a) {
  constexpr int smem = f32_smem_bytes<D>();
  static std::atomic<unsigned long long> smem_set{0};
  cudaError_t err =
      allow_dynamic_smem(smem_set, reinterpret_cast<const void*>(flash_fwd_f32<D>), smem);
  if (err != cudaSuccess) return err;
  const int vec = rows_aligned16(a.q, a.qs, 4) && rows_aligned16(a.k, a.ks, 4) &&
                  rows_aligned16(a.v, a.vs, 4);
  const dim3 grid((a.nq + BLOCK_Q - 1) / BLOCK_Q, a.heads, a.batch);
  flash_fwd_f32<D><<<grid, WG_THREADS, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o), a.kv_lens, a.nq, a.nk, a.dh,
      a.qs, a.ks, a.vs, a.os, a.scale * 1.4426950408889634f, a.causal, vec);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const Args& a, int dtype) {
  if (dtype == 0) return launch_f32<D>(a);
  const bool vec =
      rows_aligned16(a.q, a.qs) && rows_aligned16(a.k, a.ks) && rows_aligned16(a.v, a.vs);
  return vec ? launch_bf16<D, true, false>(a) : launch_bf16<D, false, false>(a);
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
  const Args a{q, k, v, o, kv_lens, batch, heads, nq, nk, dh,
               Strides{q_sb, q_sh, q_sn}, Strides{k_sb, k_sh, k_sn}, Strides{v_sb, v_sh, v_sn},
               Strides{o_sb, o_sh, o_sn}, scale, causal, static_cast<cudaStream_t>(stream),
               nullptr};
  return (int)(dh <= 64 ? launch<64>(a, dtype) : launch<128>(a, dtype));
}

// texocr_flash_attention_fwd for a bfloat16 call with dh <= 64 that is to be
// differentiated by texocr_flash_attention_bwd: the same output, and each
// row's base-2 log-sum-exp written to lse, a (B, H, Nq rounded up to 64)
// float32 buffer (rows past Nq included).
extern "C" int texocr_flash_attention_fwd_lse(
    const void* q, const void* k, const void* v, void* o, const int* kv_lens, int batch,
    int heads, int nq, int nk, int dh, long long q_sb, long long q_sh, long long q_sn,
    long long k_sb, long long k_sh, long long k_sn, long long v_sb, long long v_sh,
    long long v_sn, long long o_sb, long long o_sh, long long o_sn, float scale, int causal,
    int dtype, float* lse, void* stream) {
  if (batch <= 0 || heads <= 0 || nq <= 0 || nk <= 0 || dh <= 0 || dh > 64 || dtype != 1 ||
      lse == nullptr)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, o, kv_lens, batch, heads, nq, nk, dh,
               Strides{q_sb, q_sh, q_sn}, Strides{k_sb, k_sh, k_sn}, Strides{v_sb, v_sh, v_sn},
               Strides{o_sb, o_sh, o_sn}, scale, causal, static_cast<cudaStream_t>(stream), lse};
  const bool vec =
      rows_aligned16(a.q, a.qs) && rows_aligned16(a.k, a.ks) && rows_aligned16(a.v, a.vs);
  return (int)(vec ? launch_bf16<64, true, true>(a) : launch_bf16<64, false, true>(a));
}

// The bfloat16 backward (dh <= 64): dq, dk and dv of o = attention(q, k, v)
// from the forward's o and lse (texocr_flash_attention_fwd_lse) and the output
// gradient dout, each operand given by its batch, head and row strides in
// elements (dh stride 1). delta: a (B, H, Nq rounded up to 64) float32 scratch
// that the first launch fills with rowsum(dout o o) and the second reads.
extern "C" int texocr_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const float* lse, float* delta, void* dq, void* dk, void* dv, int batch, int heads, int nq,
    int nk, int dh, long long q_sb, long long q_sh, long long q_sn, long long k_sb,
    long long k_sh, long long k_sn, long long v_sb, long long v_sh, long long v_sn,
    long long o_sb, long long o_sh, long long o_sn, long long do_sb, long long do_sh,
    long long do_sn, long long dq_sb, long long dq_sh, long long dq_sn, long long dk_sb,
    long long dk_sh, long long dk_sn, long long dv_sb, long long dv_sh, long long dv_sn,
    float scale, int causal, void* stream) {
  if (batch <= 0 || heads <= 0 || nq <= 0 || nk <= 0 || dh <= 0 || dh > 64 ||
      (causal && nq != nk) || lse == nullptr || delta == nullptr)
    return (int)cudaErrorInvalidValue;
  const BwdArgs a{q, k, v, o, dout, lse, delta, dq, dk, dv, batch, heads, nq, nk, dh,
                  (nq + BLOCK_Q - 1) / BLOCK_Q * BLOCK_Q,
                  Strides{q_sb, q_sh, q_sn}, Strides{k_sb, k_sh, k_sn}, Strides{v_sb, v_sh, v_sn},
                  Strides{o_sb, o_sh, o_sn}, Strides{do_sb, do_sh, do_sn},
                  Strides{dq_sb, dq_sh, dq_sn}, Strides{dk_sb, dk_sh, dk_sn},
                  Strides{dv_sb, dv_sh, dv_sn}, scale, causal,
                  static_cast<cudaStream_t>(stream)};
  const bool vec = rows_aligned16(q, a.qs) && rows_aligned16(k, a.ks) &&
                   rows_aligned16(v, a.vs) && rows_aligned16(o, a.os) &&
                   rows_aligned16(dout, a.dos);
  return (int)(vec ? launch_bwd<true>(a) : launch_bwd<false>(a));
}

// How many blocks of the kernel that a call with this dtype and head dim
// launches (rows on 16 bytes) fit one SM at once, by the CUDA occupancy
// calculator; -1 on error.
extern "C" int texocr_flash_attention_blocks_per_sm(int dtype, int dh) {
  if (dh <= 0 || dh > 128 || (dtype != 0 && dtype != 1)) return -1;
  const bool d64 = dh <= 64;
  const void* kernel =
      dtype == 0 ? (d64 ? reinterpret_cast<const void*>(flash_fwd_f32<64>)
                        : reinterpret_cast<const void*>(flash_fwd_f32<128>))
                 : (d64 ? reinterpret_cast<const void*>(flash_fwd_bf16<64, true, false>)
                        : reinterpret_cast<const void*>(flash_fwd_bf16<128, true, false>));
  const int smem = dtype == 0 ? (d64 ? f32_smem_bytes<64>() : f32_smem_bytes<128>())
                              : 5 * 64 * (d64 ? 64 : 128) * 2 + 1024;
  int blocks = -1;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, WG_THREADS, smem) !=
          cudaSuccess)
    return -1;
  return blocks;
}
