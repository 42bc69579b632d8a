// GQA flash attention (forward) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:24
// (_flash_kernel, launched by flash_attention there):
//     out[b, j, t] = softmax_u(mask(q[b, j, t] . k[b, j / rep, u] * scale))
//                    @ v[b, j / rep]
// with rep = H / Hkv (GQA), an optional causal mask (kpos <= qpos), an
// optional sliding window (kpos > qpos - window) and absolute query
// positions qpos = q_offset + t. Inputs are f32 or bf16; the online-softmax
// statistics (m, l) and the output accumulator are f32, masked scores take
// the reference's finite NEG_INF = -1e30 (kv rows past Skv too, before the
// row max), the denominator is max(l, 1e-30), and the output is written in
// q's dtype.
//
// Three paths; the wrapper (kernels/flash_attention.py::plan) picks one by
// dtype and shape alone:
//
// 1. split_kv (both dtypes, rep * Sq <= 16 packed query rows: decode).
//    What bounds it: bytes. At the qwen3-1.7b decode shape (B 4, H 16,
//    Hkv 8, Sq 1, Skv 1056, D 128, bf16) the function reads 17.33 MB of
//    K/V once: 5.17 us at 3.35 TB/s. The design: one block per (batch, kv
//    head, split of 64 keys) loads the rep query rows that share its kv
//    head, so each K/V row is read once for the whole GQA group (the
//    earlier kernel read it once per query head, twice the bytes at rep 2);
//    the visible range [kv_begin, kv_end) is cut into splits so the grid
//    fills the SMs (32 x 17 = 544 blocks at the decode shape instead of 64)
//    and, with the rows' loops bounded at compile time by a power of two
//    R >= rows (shared memory 36 KB at R 2), every block is resident at
//    once; each block issues all its 16-byte K/V copies (cp.async) before
//    it computes. Products stay f32 on the CUDA cores (a few flops per byte
//    is far below the ridge). Each block writes f32 partials (m, l, acc) of
//    its split to a scratch tensor the wrapper allocates; a second kernel,
//    one block per (batch x kv head, row), merges them in split order
//    (rescale by exp(m_s - m), sum l and acc, divide by max(l, 1e-30)). An
//    empty split has m = NEG_INF and l = 0 and adds exactly zero. Two
//    launches, no atomics: bitwise repeatable.
//
// 2. wgmma (bf16, more packed rows: prefill). What bounds it: operations.
//    At the qwen3-1.7b prefill shape (B 4, H 16, Hkv 8, S 1024, D 128,
//    causal) the two products need 17.2 GFLOP: 17.39 us at the 989 TFLOP/s
//    bf16 tensor-core rate (the bytes take 15 us). The design follows
//    FlashAttention-2/3 on Hopper: a block of one warpgroup (4 warps) owns
//    64 query rows, the M of wgmma. Q stays in shared memory for the whole
//    kv loop; K and V tiles of 64 rows stay bf16 in shared memory, double
//    buffered. One thread issues every copy as TMA boxes of a (D, S, H, B)
//    tensor map (the model's strided views as they are), which land
//    128-byte swizzled, the layout the wgmma descriptors read, complete
//    on an mbarrier per buffer, and zero-fill rows past Sq or Skv; so the
//    next tile's copy overlaps this tile's products at no cost to the
//    other threads. QK^T runs as wgmma m64n64k16 bf16 x bf16 -> f32 with
//    both operands in shared memory. The online softmax runs in f32
//    registers on the raw scores: sm_scale (times log2 e) enters once per
//    score through the FMA that feeds exp2, so no extra rounding of q. P
//    is rounded to bf16 in registers and fed straight back as the register
//    A operand of the PV wgmma (m64nDk16), whose B operand is V read
//    MN-major (transposed) from shared memory; the sum stays in f32. Only
//    tiles that straddle the causal diagonal, the window edge or Skv take
//    the masked softmax; tiles hidden from every row are skipped. Query
//    tiles launch in reverse order so the heaviest causal tiles start
//    first, and two blocks share an SM. What holds it back: within a
//    warpgroup QK^T, softmax and PV run one after the other, and the two
//    blocks of an SM overlap them only by chance. On an H100 these were
//    each no faster: issuing the next tile's QK^T before this tile's
//    softmax; 48- or 32-key tiles for a third block per SM; and
//    FlashAttention-3's warp specialisation (a producer issuing the
//    copies, two consumer warpgroups of 64 rows sharing a 4-stage ring
//    through full/empty mbarriers), with the producer a cp.async warp or
//    one TMA thread, with or without ping-pong turns on named barriers.
//
// 3. f32 tile (f32, more packed rows). The reference computes f32 products
//    and the port's f32 tolerance is 1e-5, which TF32 tensor cores (about
//    10 mantissa bits) would miss, so this path keeps the earlier
//    CUDA-core kernel: f32 tiles in shared memory, scalar fmaf products
//    (its floor is near 0.26 ms at the prefill shape). It serves only the
//    f32 checks (the card-vs-CPU reduced serve, the f32 logits check), not
//    the bf16 serving configurations. A bf16 call never reaches it.
//
// Head dims: 64, 128 and (zamba2-7b's) 112, each path instantiated for
// all three. At D = 112 the wgmma path keeps its tiles 128 columns wide in
// shared memory (two 64-column swizzle blocks): TMA zero-fills columns
// 112..127, QK^T takes the 7 k-steps of the real columns, PV runs at
// n = 128 (its last 16 output columns are P . 0 and are not written), so
// the D = 112 kernel is the D = 128 kernel minus one QK^T k-step. The
// split kernel's P.V threads 112..127 have no column and sit out; the
// f32 tile's loads take a tail (16 rows x 28 vectors is no multiple of
// the 128-thread block).
//
// Common to all paths: q, k, v and out are addressed through (batch, head,
// position) strides with a contiguous head dim, so the model passes its
// (B, S, H, D) projections as transposed views without a copy; rows must
// start on 16-byte boundaries (the wrapper checks). Ragged Sq and Skv are
// masked in the kernels: rows past Sq are neither read nor written, kv
// rows past Skv load as zero, score NEG_INF and weigh zero. No caller pads.
//
// The launchers have a plain C interface (loaded with ctypes). They launch
// on the caller's stream, allocate nothing, do not synchronise, and return
// a cudaError_t (0 on success) so the caller can raise.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;    // the reference's finite NEG_INF
constexpr float kLog2e = 1.4426950408889634f;

enum DType { kF32 = 0, kBF16 = 1 };

struct Strides {                     // in elements; head dim stride is 1
  long long b, h, s;
};

__device__ __forceinline__ bool visible(int kpos, int qpos, int kv_end,
                                        int causal, int window) {
  return kpos < kv_end && (!causal || kpos <= qpos) &&
         (window <= 0 || kpos > qpos - window);
}

// 16-byte vectors: 8 bf16 or 4 f32 elements, widened exactly to f32
__device__ __forceinline__ void widen(const uint4& raw, float* out,
                                      const float*) {
  out[0] = __uint_as_float(raw.x);
  out[1] = __uint_as_float(raw.y);
  out[2] = __uint_as_float(raw.z);
  out[3] = __uint_as_float(raw.w);
}
__device__ __forceinline__ void widen(const uint4& raw, float* out,
                                      const __nv_bfloat16*) {
  const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {     // little-endian: element 2i is low
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// ---- asynchronous copies (PTX) ---------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-fills the destination when !valid
// (src-size 0 reads nothing; src must still be a valid address)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x (lo) low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// ===========================================================================
// Path 1: split_kv (decode)
// ===========================================================================

constexpr int kSplitThreads = 128;
constexpr int kSplit = 64;           // keys per split
constexpr int kMaxRows = 16;         // packed query rows (rep * Sq)

template <typename T, int D, int R>
constexpr size_t split_smem_bytes() {
  // K and V rows padded by 16 bytes (conflict-free row-per-lane reads),
  // R q rows (scaled f32) and their scores / weights
  return 2 * sizeof(T) * (size_t)kSplit * (D + 16 / sizeof(T)) +
         sizeof(float) * (size_t)R * (D + kSplit);
}

// One block per (split, batch x kv head); R >= rows is a power of two, so
// the loops over rows have a compile-time bound. Writes the split's
// partials: part_ml[bkv][split][r] = (m, l), part_acc[bkv][split][r][:D]
// = sum_u p v.
template <typename T, int D, int R>
__global__ void __launch_bounds__(kSplitThreads)
flash_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, float* __restrict__ part_acc,
                   float* __restrict__ part_ml, Strides qs, Strides ks,
                   Strides vs, int h, int hkv, int sq, int kv_begin,
                   int kv_end, int nsplit, int causal, int window,
                   int q_offset, float sm_scale) {
  constexpr int VE = 16 / sizeof(T);           // elements per 16 bytes
  constexpr int CH = D / VE;                   // 16-byte chunks per row
  constexpr int LDR = D + VE;                  // padded K/V row
  constexpr int KP = kSplitThreads / D;        // key parts in P.V (1 or 2)
  static_assert(KP >= 1 && KP * D <= kSplitThreads, "head dim > block");
  constexpr int RH = (R + 1) / 2;              // score rows per thread
  extern __shared__ __align__(16) unsigned char smem_split[];
  T* k_s = reinterpret_cast<T*>(smem_split);   // kSplit x LDR
  T* v_s = k_s + kSplit * LDR;                 // kSplit x LDR
  float* q_s = reinterpret_cast<float*>(v_s + kSplit * LDR);  // R x D
  float* p_s = q_s + R * D;                    // R x kSplit

  const int tid = threadIdx.x;
  const int split = blockIdx.x;
  const int bkv = blockIdx.y;
  const int b = bkv / hkv;
  const int hk = bkv % hkv;
  const int rep = h / hkv;
  const int rows = rep * sq;                   // row r: head hk*rep + r/sq
  const int u0 = kv_begin + split * kSplit;

  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;
  // every 16-byte K/V copy of the split in flight at once
  for (int i = tid; i < kSplit * CH; i += kSplitThreads) {
    const int r = i / CH, c = (i % CH) * VE;
    const bool ok = u0 + r < kv_end;
    const long long row = ok ? u0 + r : 0;
    cp_async16(smem_addr(k_s + r * LDR + c), kb + row * ks.s + c, ok);
    cp_async16(smem_addr(v_s + r * LDR + c), vb + row * vs.s + c, ok);
  }
  cp_async_commit();
  for (int i = tid; i < rows * D; i += kSplitThreads) {
    const int r = i / D, c = i % D;
    const T* qrow = q + b * qs.b + (hk * rep + r / sq) * qs.h +
                    (long long)(r % sq) * qs.s;
    q_s[i] = to_f32(qrow[c]) * sm_scale;
  }
  cp_async_wait<0>();
  __syncthreads();

  // scores: thread (key u, row half rh) dots K[u] with rows rh, rh + 2, ..
  {
    const int u = tid % kSplit, rh = tid / kSplit;
    float acc[RH];
#pragma unroll
    for (int i = 0; i < RH; ++i) acc[i] = 0.f;
    if (rh < rows) {
#pragma unroll 4
      for (int c = 0; c < CH; ++c) {
        float kf[VE];
        widen(*reinterpret_cast<const uint4*>(k_s + u * LDR + c * VE), kf,
              static_cast<const T*>(nullptr));
#pragma unroll
        for (int i = 0; i < RH; ++i) {
          const float* qr = q_s + (rh + 2 * i) * D + c * VE;
#pragma unroll
          for (int e = 0; e < VE; ++e) acc[i] = fmaf(qr[e], kf[e], acc[i]);
        }
      }
    }
    const int kpos = u0 + u;
#pragma unroll
    for (int i = 0; i < RH; ++i) {
      const int r = rh + 2 * i;
      if (r < rows) {
        const bool vis =
            visible(kpos, q_offset + r % sq, kv_end, causal, window);
        p_s[r * kSplit + u] = vis ? acc[i] : kNegInf;
      }
    }
  }
  __syncthreads();

  // softmax of the split: warp w takes rows w, w + 4, ..; lane keys
  // lane and lane + 32
  {
    const int warp = tid / 32, lane = tid % 32;
    float* ml = part_ml + ((long long)bkv * nsplit + split) * rows * 2;
    for (int r = warp; r < rows; r += kSplitThreads / 32) {
      const int qpos = q_offset + r % sq;
      float s0 = p_s[r * kSplit + lane], s1 = p_s[r * kSplit + lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float p0 =
          visible(u0 + lane, qpos, kv_end, causal, window) ? expf(s0 - mx)
                                                           : 0.f;
      const float p1 =
          visible(u0 + lane + 32, qpos, kv_end, causal, window)
              ? expf(s1 - mx)
              : 0.f;
      float sum = p0 + p1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      p_s[r * kSplit + lane] = p0;
      p_s[r * kSplit + lane + 32] = p1;
      if (lane == 0) {
        ml[2 * r] = mx;            // NEG_INF for a split the mask empties
        ml[2 * r + 1] = sum;
      }
    }
  }
  __syncthreads();

  // P.V: thread (column c, key part kp) sums its kSplit / KP keys in order
  // (rows past `rows` have zero weights: p_s is read only below rows);
  // threads past KP * D (16 of them at D = 112) have no column
  const int c = tid % D, kp = tid / D;
  float acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.f;
  constexpr int KU = kSplit / KP;
  const int nr = min(rows, R);
  if (kp < KP) {
#pragma unroll 8
    for (int j = 0; j < KU; ++j) {
      const int u = kp * KU + j;
      const float vf = to_f32(v_s[u * LDR + c]);
#pragma unroll
      for (int r = 0; r < R; ++r)
        acc[r] = fmaf(r < nr ? p_s[r * kSplit + u] : 0.f, vf, acc[r]);
    }
  }
  float* pa = part_acc + ((long long)bkv * nsplit + split) * rows * D;
  if (KP == 1) {
    if (kp == 0) {
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (r < rows) pa[r * D + c] = acc[r];
    }
  } else {                          // keys [0, 32) + keys [32, 64)
    float* red = q_s;               // q_s is free after the scores
    if (kp == 1) {
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (r < rows) red[r * D + c] = acc[r];
    }
    __syncthreads();
    if (kp == 0) {
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (r < rows) pa[r * D + c] = acc[r] + red[r * D + c];
    }
  }
}

// One block of D threads per (batch x kv head, packed row): merges the
// splits' partials in split order and writes out in q's dtype. The loops
// are unrolled so a thread has several independent loads in flight.
template <typename T, int D>
__global__ void __launch_bounds__(D)
flash_merge_kernel(const float* __restrict__ part_acc,
                   const float* __restrict__ part_ml, T* __restrict__ out,
                   Strides os, int h, int hkv, int sq, int nsplit) {
  const int bkv = blockIdx.x, r = blockIdx.y, c = threadIdx.x;
  const int b = bkv / hkv, hk = bkv % hkv;
  const int rep = h / hkv, rows = rep * sq;
  const long long base = (long long)bkv * nsplit * rows + r;
  const float* ml = part_ml + base * 2;          // split s at s * rows * 2
  const float* pa = part_acc + base * D + c;     // split s at s * rows * D
  float m = kNegInf;
#pragma unroll 8
  for (int s = 0; s < nsplit; ++s) m = fmaxf(m, ml[(long long)s * rows * 2]);
  float l = 0.f, acc = 0.f;
#pragma unroll 8
  for (int s = 0; s < nsplit; ++s) {
    const float w = expf(ml[(long long)s * rows * 2] - m);
    l = fmaf(w, ml[(long long)s * rows * 2 + 1], l);
    acc = fmaf(w, pa[(long long)s * rows * D], acc);
  }
  T* orow = out + b * os.b + (hk * rep + r / sq) * os.h +
            (long long)(r % sq) * os.s;
  store_f32(orow + c, acc / fmaxf(l, 1e-30f));
}

template <typename T, int D, int R>
int launch_split(const void* q, const void* k, const void* v, void* out,
                 const Strides* st, int b, int h, int hkv, int sq,
                 int kv_begin, int kv_end, int nsplit, int causal, int window,
                 int q_offset, float sm_scale, float* part_acc,
                 float* part_ml, cudaStream_t stream) {
  const size_t smem = split_smem_bytes<T, D, R>();
  static bool attr_set = false;      // once per instantiation and process
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_split_kernel<T, D, R>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  flash_split_kernel<T, D, R><<<dim3(nsplit, b * hkv), kSplitThreads, smem,
                                stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), part_acc, part_ml, st[0], st[1], st[2], h,
      hkv, sq, kv_begin, kv_end, nsplit, causal, window, q_offset, sm_scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flash_merge_kernel<T, D><<<dim3(b * hkv, (h / hkv) * sq), D, 0, stream>>>(
      part_acc, part_ml, static_cast<T*>(out), st[3], h, hkv, sq, nsplit);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_split_rows(const void* q, const void* k, const void* v,
                      void* out, const Strides* st, int b, int h, int hkv,
                      int sq, int kv_begin, int kv_end, int nsplit,
                      int causal, int window, int q_offset, float sm_scale,
                      float* pa, float* pm, cudaStream_t s) {
  const int rows = (h / hkv) * sq;
#define REPRO_SPLIT(R)                                                      \
  return launch_split<T, D, R>(q, k, v, out, st, b, h, hkv, sq, kv_begin,   \
                               kv_end, nsplit, causal, window, q_offset,    \
                               sm_scale, pa, pm, s)
  if (rows <= 1) REPRO_SPLIT(1);
  if (rows <= 2) REPRO_SPLIT(2);
  if (rows <= 4) REPRO_SPLIT(4);
  if (rows <= 8) REPRO_SPLIT(8);
  REPRO_SPLIT(16);
#undef REPRO_SPLIT
}

// ===========================================================================
// Path 2: wgmma (bf16 tiles on the warpgroup tensor cores)
// ===========================================================================

constexpr int kWgThreads = 128;          // one warpgroup
constexpr int kWgBQ = 64;                // query rows per block (wgmma M)
constexpr int kWgBK = 64;                // kv rows per tile

// the head dim as the wgmma path lays it out in shared memory: whole
// 64-column (128-byte) swizzle blocks, 128 at D = 112
__host__ __device__ constexpr int padded_dim(int d) {
  return (d + 63) / 64 * 64;
}

// Q, then K and V double-buffered, then three mbarriers
template <int D>
constexpr size_t wg_smem_bytes() {
  return sizeof(__nv_bfloat16) * (size_t)(kWgBQ + 4 * kWgBK) *
             padded_dim(D) +
         3 * sizeof(uint64_t);
}

// shared-memory matrix descriptor of wgmma, 128-byte swizzle; byte
// offsets: lbo between atoms along the leading (contiguous) dimension
// (used by MN-major operands), sbo between 8-row atoms
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) |
         (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | (uint64_t)1 << 62;
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// pins accumulator registers in place around an asynchronous wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// ---- mbarriers and TMA (PTX)
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}
// this thread's arrival, announcing `bytes` of copies to land on the bar
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
// waits for the phase of the given parity to complete; traps (the launch
// fails) instead of hanging if it never does
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  for (int i = 0;; ++i) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (i == (1 << 24)) __trap();
  }
}
// one bf16 box of a (D, S, H, B) tensor map -> shared memory,
// 128-byte swizzled; rows outside the tensor land as zeros
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map,
                                        int col, int row, int head,
                                        int batch, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(head),
      "r"(batch), "r"(smem_addr(bar))
      : "memory");
}

// d (64 x 64, f32) = A . B (+ d when scale_d): A (64 x 16) and B
// (16 x 64) bf16 in shared memory, both K-major, 128-byte swizzle
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t a, uint64_t b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 64, f32) += A . B: A (64 x 16) bf16 in registers (the
// accumulator layout of a m64nXk16 product, packed), B (16 x 64) bf16 in
// shared memory, MN-major (transposed), 128-byte swizzle
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 128, f32) += A . B: A (64 x 16) bf16 in registers (the
// accumulator layout of a m64nXk16 product, packed), B (16 x 128) bf16 in
// shared memory, MN-major (transposed), 128-byte swizzle
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// 2^x on the SFU (ex2.approx, relative error 2^-22; flushes subnormal
// results to zero, far below the bf16 rounding of P)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// online softmax of one 64 x 64 tile of raw f32 scores: the row max is
// taken on the raw scores (the scale is positive), and each weight is
// exp2(s * scale_log2 - m * scale_log2), one FMA and one exp2. MASKED
// tiles (those that straddle the causal diagonal, the window edge or
// Skv) score hidden keys NEG_INF before the max and weigh them exactly
// zero. Rescales o, updates m and l (m in raw score units), and returns
// P as the bf16 A fragments of the P V product.
template <int D, bool MASKED>
__device__ __forceinline__ void softmax_tile(
    float (&s)[kWgBK / 8][4], float (&o)[D / 8][4],
    uint32_t (&pa)[kWgBK / 16][4], float& m_lo, float& m_hi, float& l_lo,
    float& l_hi, float scale_log2, int k0, int qpos_lo, int qpos_hi, int tq,
    int skv, int causal, int window) {
  constexpr int NS = kWgBK / 8;
  uint32_t hidden = 0;                     // bit 4j+e: score s[j][e] masked
  if (MASKED) {
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + j * 8 + 2 * tq + (e & 1);
        if (!visible(kpos, e < 2 ? qpos_lo : qpos_hi, skv, causal,
                     window)) {
          s[j][e] = kNegInf;
          hidden |= 1u << (4 * j + e);
        }
      }
    }
  }
  float mx_lo = m_lo, mx_hi = m_hi;
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    mx_lo = fmaxf(mx_lo, fmaxf(s[j][0], s[j][1]));
    mx_hi = fmaxf(mx_hi, fmaxf(s[j][2], s[j][3]));
  }
#pragma unroll
  for (int o2 = 1; o2 <= 2; o2 <<= 1) {    // the 4 threads of a row
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, o2));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, o2));
  }
  const float corr_lo = exp2_approx((m_lo - mx_lo) * scale_log2);
  const float corr_hi = exp2_approx((m_hi - mx_hi) * scale_log2);
  m_lo = mx_lo;
  m_hi = mx_hi;
  const float off_lo = -mx_lo * scale_log2, off_hi = -mx_hi * scale_log2;
  float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    float p[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      p[e] = exp2_approx(fmaf(s[j][e], scale_log2, e < 2 ? off_lo : off_hi));
      if (MASKED && ((hidden >> (4 * j + e)) & 1u)) p[e] = 0.f;
    }
    sum_lo += p[0] + p[1];
    sum_hi += p[2] + p[3];
    pa[j / 2][(j & 1) * 2] = pack_bf16(p[0], p[1]);
    pa[j / 2][(j & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
  }
  l_lo = l_lo * corr_lo + sum_lo;          // per-thread partial row sums
  l_hi = l_hi * corr_hi + sum_hi;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    o[n][0] *= corr_lo;
    o[n][1] *= corr_lo;
    o[n][2] *= corr_hi;
    o[n][3] *= corr_hi;
  }
}

// S = Q K^T (64 x 64 per warpgroup), f32; k-step kk reads 32 bytes of
// column block kk / 4 of Q and K; D / 16 k-steps, so the zero-filled
// columns of a padded tile are never read
template <int D>
__device__ __forceinline__ void wgmma_qk(float (&s)[kWgBK / 8][4],
                                         uint64_t q_desc, uint64_t k_desc) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t qoff = (kk >> 2) * (kWgBQ * 128) + (kk & 3) * 32;
    const uint32_t koff = (kk >> 2) * (kWgBK * 128) + (kk & 3) * 32;
    wgmma_ss_n64(&s[0][0], q_desc + (qoff >> 4), k_desc + (koff >> 4),
                 kk > 0);
  }
  wgmma_commit();
  wgmma_wait0();
  fence_regs<kWgBK / 2>(&s[0][0]);
}

// O += P V: P (bf16 A fragments) from registers, V MN-major (transposed)
// from shared memory; k-step kk reads rows 16 kk .. 16 kk + 15 of every
// column block (the descriptor's lbo: the next column block, sbo: the
// next 8 rows)
template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 8][4],
                                         const uint32_t (&pa)[kWgBK / 16][4],
                                         uint64_t v_desc) {
  fence_regs<D / 2>(&o[0][0]);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kWgBK / 16; ++kk) {
    const uint64_t d = v_desc + ((kk * 16 * 128) >> 4);
    if constexpr (D == 128) wgmma_rs_n128(&o[0][0], pa[kk], d);
    else wgmma_rs_n64(&o[0][0], pa[kk], d);
  }
  wgmma_commit();
  wgmma_wait0();
  fence_regs<D / 2>(&o[0][0]);
}

// the rows [row, row + ROWS) of (batch, head) of a (D, S, H, B) tensor
// map with (64, ROWS) boxes, all DP / 64 column blocks, into a (ROWS, DP)
// tile (DP = padded_dim(D); columns past D land as zeros)
template <int DP, int ROWS>
__device__ __forceinline__ void tma_tile(__nv_bfloat16* dst,
                                         const CUtensorMap* map, int row,
                                         int head, int batch, uint64_t* bar) {
#pragma unroll
  for (int c = 0; c < DP / 64; ++c)
    tma_box(dst + c * ROWS * 64, map, c * 64, row, head, batch, bar);
}

template <int D>
__global__ void __launch_bounds__(kWgThreads, 2)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   __nv_bfloat16* __restrict__ out, Strides os, int h,
                   int hkv, int sq, int skv, int causal, int window,
                   int q_offset, float scale_log2) {
  constexpr int NS = kWgBK / 8;          // score n8 groups (8 keys each)
  constexpr int DP = padded_dim(D);    // head dim in shared memory
  constexpr int NO = D / 8;              // output n8 groups written
  constexpr int NP = DP / 8;             // accumulator n8 groups
  constexpr int TILE = kWgBK * DP;
  constexpr uint32_t kTileBytes = TILE * 2;
  constexpr uint32_t kTile16 = kTileBytes / 16;  // a tile in 16-byte units
  constexpr uint32_t kAtom = 1024;       // bytes of an 8-row atom
  extern __shared__ __align__(1024) unsigned char smem_wg[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_wg);
  __nv_bfloat16* k_s = q_s + kWgBQ * DP;   // 2 x TILE
  __nv_bfloat16* v_s = k_s + 2 * TILE;     // 2 x TILE
  uint64_t* bars = reinterpret_cast<uint64_t*>(v_s + 2 * TILE);
  uint64_t* q_bar = bars;                  // Q landed
  uint64_t* kv_bar = bars + 1;             // K/V tile of buffer 0 / 1 landed

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tq = lane & 3;  // accumulator row / column
  const int bh = blockIdx.y;
  const int b = bh / h;
  const int hq = bh % h;
  const int hk = hq / (h / hkv);           // GQA: the reference's kv_map
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kWgBQ;   // heaviest first
  const int nq = min(kWgBQ, sq - q0);

  // kv tiles t0 .. t0 + n - 1 hold every key any row of this tile can see
  const int qpos_first = q_offset + q0;
  const int qpos_last = q_offset + q0 + nq - 1;
  int kv_begin = 0, kv_end = skv;
  if (causal) kv_end = min(skv, qpos_last + 1);
  if (window > 0) kv_begin = max(0, qpos_first - window + 1);
  const int t0 = kv_begin / kWgBK;
  const int n = kv_end > kv_begin ? (kv_end + kWgBK - 1) / kWgBK - t0 : 0;

  // one thread issues every copy (TMA): K/V tile j into buffer j % 2 on
  // that buffer's mbarrier; the rest wait on the barriers. A buffer is
  // refilled only after the block barrier that ends the iteration which
  // read it.
  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(&bars[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto load_kv = [&](int j) {
    if (j < n) {
      uint64_t* bar = &kv_bar[j & 1];
      mbar_expect(bar, 2 * kTileBytes);
      tma_tile<DP, kWgBK>(k_s + (j & 1) * TILE, &tm_k, (t0 + j) * kWgBK, hk,
                          b, bar);
      tma_tile<DP, kWgBK>(v_s + (j & 1) * TILE, &tm_v, (t0 + j) * kWgBK, hk,
                          b, bar);
    }
  };
  if (tid == 0) {
    mbar_expect(q_bar, kWgBQ * DP * 2);   // zero-filled bytes count too
    tma_tile<DP, kWgBQ>(q_s, &tm_q, q0, hq, b, q_bar);
    load_kv(0);
  }

  // descriptors of each tile's first k-step (the 128-byte swizzle; sbo:
  // the next 8-row atom; V's lbo: the next (BK, 64) column block)
  const uint64_t q_desc = sw128_desc(q_s, 0, kAtom);
  const uint64_t k_desc = sw128_desc(k_s, 0, kAtom);
  const uint64_t v_desc = sw128_desc(v_s, kWgBK * 128, kAtom);

  const int row_lo = warp * 16 + g;        // accumulator rows g and g + 8
  const int qpos_lo = q_offset + q0 + row_lo;
  const int qpos_hi = qpos_lo + 8;
  float o[NP][4], s[NS][4];
#pragma unroll
  for (int i = 0; i < NP; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
#pragma unroll
  for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
  float m_lo = kNegInf, m_hi = kNegInf, l_lo = 0.f, l_hi = 0.f;

  mbar_wait(q_bar, 0);
  for (int j = 0; j < n; ++j) {
    if (tid == 0) load_kv(j + 1);          // the next tile streams in
    mbar_wait(&kv_bar[j & 1], (j >> 1) & 1);
    wgmma_qk<D>(s, q_desc, k_desc + (j & 1) * kTile16);
    const int k0 = (t0 + j) * kWgBK;
    const bool full = k0 + kWgBK <= skv &&
                      (!causal || k0 + kWgBK - 1 <= qpos_first) &&
                      (window <= 0 || k0 > qpos_last - window);
    uint32_t pa[kWgBK / 16][4];            // P as bf16 A fragments
    if (full)
      softmax_tile<DP, false>(s, o, pa, m_lo, m_hi, l_lo, l_hi, scale_log2,
                              k0, qpos_lo, qpos_hi, tq, skv, causal, window);
    else
      softmax_tile<DP, true>(s, o, pa, m_lo, m_hi, l_lo, l_hi, scale_log2,
                             k0, qpos_lo, qpos_hi, tq, skv, causal, window);
    wgmma_pv<DP>(o, pa, v_desc + (j & 1) * kTile16);
    __syncthreads();                       // buffer j % 2 is refilled next
  }

#pragma unroll
  for (int o2 = 1; o2 <= 2; o2 <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, o2);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, o2);
  }
  const float inv_lo = 1.f / fmaxf(l_lo, 1e-30f);
  const float inv_hi = 1.f / fmaxf(l_hi, 1e-30f);
  __nv_bfloat16* ob = out + b * os.b + hq * os.h;
  if (row_lo < nq) {
    __nv_bfloat16* orow = ob + (long long)(q0 + row_lo) * os.s + 2 * tq;
#pragma unroll
    for (int i = 0; i < NO; ++i)
      *reinterpret_cast<uint32_t*>(orow + i * 8) =
          pack_bf16(o[i][0] * inv_lo, o[i][1] * inv_lo);
  }
  if (row_lo + 8 < nq) {
    __nv_bfloat16* orow = ob + (long long)(q0 + row_lo + 8) * os.s + 2 * tq;
#pragma unroll
    for (int i = 0; i < NO; ++i)
      *reinterpret_cast<uint32_t*>(orow + i * 8) =
          pack_bf16(o[i][2] * inv_hi, o[i][3] * inv_hi);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// a (D, S, H, B) tensor map of 64 x 64 boxes, 128-byte swizzle, over a bf16
// tensor with element strides st (batch, head, position); the driver's
// encoder comes through the runtime, so nothing links against libcuda
int tensor_map(CUtensorMap* map, const void* base, int d, int rows,
               int heads, int batch, const Strides& st, int box_rows) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess) return (int)e;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return (int)cudaErrorNotSupported;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)rows,
                              (cuuint64_t)heads, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)st.s * 2, (cuuint64_t)st.h * 2,
                                 (cuuint64_t)st.b * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)box_rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* out,
                 const Strides* st, int b, int h, int hkv, int sq, int skv,
                 int causal, int window, int q_offset, float sm_scale,
                 cudaStream_t stream) {
  const size_t smem = wg_smem_bytes<D>();
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  CUtensorMap tm_q, tm_k, tm_v;
  int e = tensor_map(&tm_q, q, D, sq, h, b, st[0], kWgBQ);
  if (e == 0) e = tensor_map(&tm_k, k, D, skv, hkv, b, st[1], kWgBK);
  if (e == 0) e = tensor_map(&tm_v, v, D, skv, hkv, b, st[2], kWgBK);
  if (e != 0) return e;
  const dim3 grid((sq + kWgBQ - 1) / kWgBQ, b * h);
  flash_wgmma_kernel<D><<<grid, kWgThreads, smem, stream>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(out), st[3], h, hkv, sq,
      skv, causal, window, q_offset, sm_scale * kLog2e);
  return (int)cudaGetLastError();
}

// ===========================================================================
// Path 3: f32 tile (CUDA cores)
// ===========================================================================

constexpr int kThreads = 128;
constexpr int kColGroups = 8;        // threads sharing one row (tx)
constexpr int kRowGroups = 16;       // row groups (ty)
constexpr int kBK = 64;              // kv rows per tile

// Stage rows [row0, row0 + ROWS) of a (rows, D) f32 operand with row
// stride `stride` into shared memory (leading dim LDS), times `scale`;
// rows at or past `nrows` are zero. Every thread issues all of its
// 16-byte loads before it stores any, so they are in flight together.
// Where the tile is no multiple of the block (16 rows at D = 112: 448
// vectors), the last round's threads past the tile load nothing.
template <int D, int ROWS, int LDS>
__device__ __forceinline__ void stage(float* dst, const float* src,
                                      long long stride, int row0, int nrows,
                                      float scale) {
  constexpr int VPR = D / 4;                  // vectors per row
  constexpr int TOTAL = ROWS * VPR;
  constexpr int N = (TOTAL + kThreads - 1) / kThreads;  // per thread
  constexpr bool kWhole = TOTAL % kThreads == 0;
  uint4 raw[N];
#pragma unroll
  for (int it = 0; it < N; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int r = i / VPR, c = (i % VPR) * 4;
    raw[it] = r < nrows && (kWhole || i < TOTAL)
                  ? *reinterpret_cast<const uint4*>(
                        src + (long long)(row0 + r) * stride + c)
                  : make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int it = 0; it < N; ++it) {
    const int i = threadIdx.x + it * kThreads;
    if (!kWhole && i >= TOTAL) break;
    const int r = i / VPR, c = (i % VPR) * 4;
    float f[4];
    widen(raw[it], f, static_cast<const float*>(nullptr));
#pragma unroll
    for (int j = 0; j < 4; ++j) dst[r * LDS + c + j] = f[j] * scale;
  }
}

template <int D, int BQ>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(BQ * (D + 1) + kBK * (D + 1) + kBK * D +
                                  BQ * (kBK + 1));
}

template <int D, int BQ>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 Strides qs, Strides ks, Strides vs, Strides os, int h,
                 int hkv, int sq, int skv, int causal, int window,
                 int q_offset, float sm_scale) {
  constexpr int RM = BQ / kRowGroups;   // rows per thread
  constexpr int CN = kBK / kColGroups;  // score columns per thread
  constexpr int DN = D / kColGroups;    // output columns per thread
  constexpr int LD = D + 1;             // padded row of Q and K tiles
  constexpr int LP = kBK + 1;           // padded row of the P tile
  extern __shared__ float smem[];
  float* q_s = smem;                    // BQ x LD, scaled
  float* k_s = q_s + BQ * LD;           // BK x LD
  float* v_s = k_s + kBK * LD;          // BK x D
  float* p_s = v_s + kBK * D;           // BQ x LP

  const int tid = threadIdx.x;
  const int tx = tid % kColGroups;
  const int ty = tid / kColGroups;
  const int bh = blockIdx.y;
  const int b = bh / h;
  const int hq = bh % h;
  const int hk = hq / (h / hkv);        // GQA: the reference's kv_map
  const int q0 = blockIdx.x * BQ;
  const int nq = min(BQ, sq - q0);

  const float* qb = q + b * qs.b + hq * qs.h;
  const float* kb = k + b * ks.b + hk * ks.h;
  const float* vb = v + b * vs.b + hk * vs.h;
  float* ob = out + b * os.b + hq * os.h;

  stage<D, BQ, LD>(q_s, qb, qs.s, q0, nq, sm_scale);

  // kv range any row of this tile can see
  const int qpos_first = q_offset + q0;
  const int qpos_last = q_offset + q0 + nq - 1;
  int kv_begin = 0, kv_end = skv;
  if (causal) kv_end = min(skv, qpos_last + 1);
  if (window > 0) kv_begin = max(0, qpos_first - window + 1);
  const int tile_begin = kv_begin / kBK;
  const int tile_end = kv_end > kv_begin ? (kv_end + kBK - 1) / kBK
                                         : tile_begin;

  float m[RM], l[RM], acc[RM][DN];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int d = 0; d < DN; ++d) acc[i][d] = 0.f;
  }

  for (int tile = tile_begin; tile < tile_end; ++tile) {
    const int k0 = tile * kBK;
    __syncthreads();               // the previous tile's reads are done
    stage<D, kBK, LD>(k_s, kb, ks.s, k0, skv - k0, 1.f);
    stage<D, kBK, D>(v_s, vb, vs.s, k0, skv - k0, 1.f);
    __syncthreads();

    float s[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      float qv[RM], kv[CN];
#pragma unroll
      for (int i = 0; i < RM; ++i) qv[i] = q_s[(ty + i * kRowGroups) * LD + c];
#pragma unroll
      for (int j = 0; j < CN; ++j) kv[j] = k_s[(tx + j * kColGroups) * LD + c];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int row = ty + i * kRowGroups;
      const int qpos = q_offset + q0 + row;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int kpos = k0 + tx + j * kColGroups;
        if (!visible(kpos, qpos, skv, causal, window)) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int col = tx + j * kColGroups;
        // kv rows past Skv do not exist: weight exactly zero
        const float p = k0 + col < skv ? expf(s[i][j] - m_new) : 0.f;
        rsum += p;
        p_s[row * LP + col] = p;
      }
      rsum += __shfl_xor_sync(0xffffffffu, rsum, 1);
      rsum += __shfl_xor_sync(0xffffffffu, rsum, 2);
      rsum += __shfl_xor_sync(0xffffffffu, rsum, 4);
      l[i] = l[i] * corr + rsum;
      m[i] = m_new;
#pragma unroll
      for (int d = 0; d < DN; ++d) acc[i][d] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pv[RM], vv[DN];
#pragma unroll
      for (int i = 0; i < RM; ++i) pv[i] = p_s[(ty + i * kRowGroups) * LP + c];
#pragma unroll
      for (int d = 0; d < DN; ++d) vv[d] = v_s[c * D + tx + d * kColGroups];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int d = 0; d < DN; ++d) acc[i][d] = fmaf(pv[i], vv[d], acc[i][d]);
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = ty + i * kRowGroups;
    if (row >= nq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    float* orow = ob + (long long)(q0 + row) * os.s;
#pragma unroll
    for (int d = 0; d < DN; ++d) orow[tx + d * kColGroups] = acc[i][d] / denom;
  }
}

template <int D, int BQ>
int launch_f32(const void* q, const void* k, const void* v, void* out,
               const Strides* st, int b, int h, int hkv, int sq, int skv,
               int causal, int window, int q_offset, float sm_scale,
               cudaStream_t stream) {
  const size_t smem = smem_bytes<D, BQ>();
  static bool attr_set = false;      // once per instantiation and process
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<D, BQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const dim3 grid((sq + BQ - 1) / BQ, b * h);
  flash_fwd_kernel<D, BQ><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), st[0], st[1],
      st[2], st[3], h, hkv, sq, skv, causal, window, q_offset, sm_scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_tile(int dtype, const void* q, const void* k, const void* v,
                void* out, const Strides* st, int b, int h, int hkv, int sq,
                int skv, int causal, int window, int q_offset,
                float sm_scale, cudaStream_t s) {
  if (dtype == kBF16)
    return launch_wgmma<D>(q, k, v, out, st, b, h, hkv, sq, skv, causal,
                           window, q_offset, sm_scale, s);
  if (sq <= 32)
    return launch_f32<D, 16>(q, k, v, out, st, b, h, hkv, sq, skv, causal,
                             window, q_offset, sm_scale, s);
  return launch_f32<D, 64>(q, k, v, out, st, b, h, hkv, sq, skv, causal,
                           window, q_offset, sm_scale, s);
}

template <int D>
int launch_decode(int dtype, const void* q, const void* k, const void* v,
                  void* out, const Strides* st, int b, int h, int hkv,
                  int sq, int kv_begin, int kv_end, int nsplit, int causal,
                  int window, int q_offset, float sm_scale, float* part_acc,
                  float* part_ml, cudaStream_t s) {
  if (dtype == kBF16)
    return launch_split_rows<__nv_bfloat16, D>(
        q, k, v, out, st, b, h, hkv, sq, kv_begin, kv_end, nsplit, causal,
        window, q_offset, sm_scale, part_acc, part_ml, s);
  return launch_split_rows<float, D>(q, k, v, out, st, b, h, hkv, sq,
                                     kv_begin, kv_end, nsplit, causal, window,
                                     q_offset, sm_scale, part_acc, part_ml,
                                     s);
}

bool bad_common(int dtype, int b, int h, int hkv, int sq, int skv, int d) {
  return b < 1 || h < 1 || hkv < 1 || h % hkv != 0 || sq < 1 || skv < 1 ||
         b * h > 65535 || (d != 64 && d != 112 && d != 128) ||
         (dtype != kF32 && dtype != kBF16);
}

void unpack(const long long* strides, Strides* st) {
  for (int i = 0; i < 4; ++i)
    st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
}

}  // namespace

// The tile paths (wgmma for bf16, f32 tile for f32): one launch.
// strides: 12 element strides, (batch, head, position) for q, k, v, out.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, int dtype,
                                     const long long* strides, int b, int h,
                                     int hkv, int sq, int skv, int d,
                                     int causal, int window, int q_offset,
                                     float sm_scale, void* stream) {
  if (bad_common(dtype, b, h, hkv, sq, skv, d))
    return (int)cudaErrorInvalidValue;
  Strides st[4];
  unpack(strides, st);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 128)
    return launch_tile<128>(dtype, q, k, v, out, st, b, h, hkv, sq, skv,
                            causal, window, q_offset, sm_scale, s);
  if (d == 112)
    return launch_tile<112>(dtype, q, k, v, out, st, b, h, hkv, sq, skv,
                            causal, window, q_offset, sm_scale, s);
  return launch_tile<64>(dtype, q, k, v, out, st, b, h, hkv, sq, skv, causal,
                         window, q_offset, sm_scale, s);
}

// The split_kv path: the split kernel, then the merge kernel. The keys
// [kv_begin, kv_end) are cut into nsplit splits of 64; part_acc holds
// b * hkv * nsplit * rep * sq * d floats, part_ml twice
// b * hkv * nsplit * rep * sq.
extern "C" int repro_flash_decode(const void* q, const void* k,
                                  const void* v, void* out, int dtype,
                                  const long long* strides, int b, int h,
                                  int hkv, int sq, int skv, int d,
                                  int causal, int window, int q_offset,
                                  int kv_begin, int kv_end, int nsplit,
                                  float sm_scale, void* part_acc,
                                  void* part_ml, void* stream) {
  if (bad_common(dtype, b, h, hkv, sq, skv, d) || (h / hkv) * sq > kMaxRows ||
      nsplit < 1 || b * hkv > 65535 || kv_begin < 0 || kv_end > skv ||
      kv_end < kv_begin || kv_begin + nsplit * kSplit < kv_end)
    return (int)cudaErrorInvalidValue;
  Strides st[4];
  unpack(strides, st);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
  if (d == 128)
    return launch_decode<128>(dtype, q, k, v, out, st, b, h, hkv, sq,
                              kv_begin, kv_end, nsplit, causal, window,
                              q_offset, sm_scale, pa, pm, s);
  if (d == 112)
    return launch_decode<112>(dtype, q, k, v, out, st, b, h, hkv, sq,
                              kv_begin, kv_end, nsplit, causal, window,
                              q_offset, sm_scale, pa, pm, s);
  return launch_decode<64>(dtype, q, k, v, out, st, b, h, hkv, sq, kv_begin,
                           kv_end, nsplit, causal, window, q_offset,
                           sm_scale, pa, pm, s);
}
