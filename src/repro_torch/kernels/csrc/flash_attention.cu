// GQA flash attention (forward) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::
// _flash_kernel (launched by flash_attention there):
//     out[b, j, t] = softmax_u(mask(q[b, j, t] . k[b, j / rep, u] * scale))
//                    @ v[b, j / rep]
// with rep = H / Hkv (GQA), an optional causal mask (kpos <= qpos), an
// optional sliding window (kpos > qpos - window) and absolute query
// positions qpos = q_offset + t. Inputs are f32 or bf16; q, k and v are
// converted to f32 and q is scaled in f32 before the product, the
// online-softmax accumulators (m, l, acc) are f32, masked scores take the
// finite NEG_INF = -1e30 of the reference, and the output is written in
// q's dtype as acc / max(l, 1e-30) -- the arithmetic of the TPU kernel.
//
// What bounds it on an H100: at the qwen3-1.7b prefill shape (B 4, H 16,
// Hkv 8, S 1024, D 128, bf16, causal) a launch does 17.2 GFLOP of the two
// products and moves about 50 MB, so the card's bound is 17 us at the
// bf16 tensor-core rate. This first kernel does its products in f32 on
// the CUDA cores (67 TFLOP/s peak), which puts its own floor near 0.26 ms:
// it is compute-bound by design, and the tensor-core redesign (wgmma on
// bf16 tiles) is later work. The decode shape (Sq 1, Skv 1056) moves
// about 17 MB of K/V and is bound by bytes and launch latency.
//
// What the design does about it:
//   * One block of 128 threads per (query tile, batch x head). The Pallas
//     grid's sequential kv axis is a loop inside the block; m, l and acc
//     stay in registers for the whole loop.
//   * Query tiles of 64 rows (16 for Sq <= 32, the decode shape), kv tiles
//     of 64 rows, both staged in shared memory as f32 through 16-byte
//     loads that a thread issues all at once (scalar loads, one in flight
//     per thread, made the decode shape latency-bound at 0.38 ms a launch
//     on an H100). Each thread owns BQ/16 rows x 8 score columns and
//     BQ/16 rows x D/8 output columns, so a row's softmax statistics
//     reduce over the 8 threads of one row group with warp shuffles. Rows
//     are padded by one float, so neither the score loop nor the P.V loop
//     has bank conflicts.
//   * kv tiles that the causal mask or the window hides from every row of
//     the block are skipped: they would add exactly zero (exp(-1e30 - m)
//     is 0 in f32), so the result is that of the full loop.
//   * The ragged edges are masked in the kernel: rows past Sq are neither
//     read nor written; kv rows past Skv load as zero, score NEG_INF
//     before the row max (a phantom score of 0 would otherwise become the
//     max of a row whose visible scores all lie far below 0, and underflow
//     every weight) and weigh zero. No caller pads.
//   * q, k, v and out are addressed through (batch, head, position)
//     strides with a contiguous head dim, so the model passes its
//     (B, S, H, D) projections as transposed views without a copy. Rows
//     must start on 16-byte boundaries (the wrapper checks).
//
// The launcher has a plain C interface (loaded with ctypes). It launches
// on the caller's stream, allocates nothing, does not synchronise, and
// returns a cudaError_t (0 on success) so the caller can raise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kColGroups = 8;        // threads sharing one row (tx)
constexpr int kRowGroups = 16;       // row groups (ty)
constexpr int kBK = 64;              // kv rows per tile
constexpr float kNegInf = -1e30f;    // the reference's finite NEG_INF

enum DType { kF32 = 0, kBF16 = 1 };

struct Strides {                     // in elements; head dim stride is 1
  long long b, h, s;
};

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

// Stage rows [row0, row0 + ROWS) of a (rows, D) operand with row stride
// `stride` into shared memory as f32 (leading dim LDS), times `scale`;
// rows at or past `nrows` are zero. Every thread issues all of its
// 16-byte loads before it stores any, so they are in flight together.
template <typename T, int D, int ROWS, int LDS>
__device__ __forceinline__ void stage(float* dst, const T* src,
                                      long long stride, int row0, int nrows,
                                      float scale) {
  constexpr int V = 16 / sizeof(T);           // elements per vector
  constexpr int VPR = D / V;                  // vectors per row
  constexpr int N = ROWS * VPR / kThreads;    // vectors per thread
  static_assert(ROWS * VPR % kThreads == 0, "tile not a multiple of block");
  uint4 raw[N];
#pragma unroll
  for (int it = 0; it < N; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int r = i / VPR, c = (i % VPR) * V;
    raw[it] = r < nrows ? *reinterpret_cast<const uint4*>(
                              src + (long long)(row0 + r) * stride + c)
                        : make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int it = 0; it < N; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int r = i / VPR, c = (i % VPR) * V;
    float f[V];
    widen(raw[it], f, static_cast<const T*>(nullptr));
#pragma unroll
    for (int j = 0; j < V; ++j) dst[r * LDS + c + j] = f[j] * scale;
  }
}

__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <int D, int BQ>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(BQ * (D + 1) + kBK * (D + 1) + kBK * D +
                                  BQ * (kBK + 1));
}

template <typename T, int D, int BQ>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, Strides qs,
                 Strides ks, Strides vs, Strides os, int h, int hkv, int sq,
                 int skv, int causal, int window, int q_offset,
                 float sm_scale) {
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

  const T* qb = q + b * qs.b + hq * qs.h;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;
  T* ob = out + b * os.b + hq * os.h;

  stage<T, D, BQ, LD>(q_s, qb, qs.s, q0, nq, sm_scale);

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
    stage<T, D, kBK, LD>(k_s, kb, ks.s, k0, skv - k0, 1.f);
    stage<T, D, kBK, D>(v_s, vb, vs.s, k0, skv - k0, 1.f);
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
        bool vis = kpos < skv;           // zero-staged rows past Skv
        if (causal) vis = vis && kpos <= qpos;
        if (window > 0) vis = vis && kpos > qpos - window;
        if (!vis) s[i][j] = kNegInf;
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
    T* orow = ob + (long long)(q0 + row) * os.s;
#pragma unroll
    for (int d = 0; d < DN; ++d)
      store_f32(orow + tx + d * kColGroups, acc[i][d] / denom);
  }
}

template <typename T, int D, int BQ>
int launch(const void* q, const void* k, const void* v, void* out,
           const Strides* st, int b, int h, int hkv, int sq, int skv,
           int causal, int window, int q_offset, float sm_scale,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<D, BQ>();
  static bool attr_set = false;      // once per instantiation and process
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D, BQ>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const dim3 grid((sq + BQ - 1) / BQ, b * h);
  flash_fwd_kernel<T, D, BQ><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), st[0], st[1], st[2],
      st[3], h, hkv, sq, skv, causal, window, q_offset, sm_scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v, void* out,
             const Strides* st, int b, int h, int hkv, int sq, int skv,
             int causal, int window, int q_offset, float sm_scale,
             cudaStream_t stream) {
  if (sq <= 32)
    return launch<T, D, 16>(q, k, v, out, st, b, h, hkv, sq, skv, causal,
                            window, q_offset, sm_scale, stream);
  return launch<T, D, 64>(q, k, v, out, st, b, h, hkv, sq, skv, causal,
                          window, q_offset, sm_scale, stream);
}

template <typename T>
int launch_t(const void* q, const void* k, const void* v, void* out,
             const Strides* st, int b, int h, int hkv, int sq, int skv,
             int d, int causal, int window, int q_offset, float sm_scale,
             cudaStream_t stream) {
  if (d == 128)
    return launch_d<T, 128>(q, k, v, out, st, b, h, hkv, sq, skv, causal,
                            window, q_offset, sm_scale, stream);
  if (d == 64)
    return launch_d<T, 64>(q, k, v, out, st, b, h, hkv, sq, skv, causal,
                           window, q_offset, sm_scale, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// strides: 12 element strides, (batch, head, position) for q, k, v, out.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, int dtype,
                                     const long long* strides, int b, int h,
                                     int hkv, int sq, int skv, int d,
                                     int causal, int window, int q_offset,
                                     float sm_scale, void* stream) {
  if (b < 1 || h < 1 || hkv < 1 || h % hkv != 0 || sq < 1 || skv < 1 ||
      b * h > 65535)
    return (int)cudaErrorInvalidValue;
  Strides st[4];
  for (int i = 0; i < 4; ++i)
    st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return launch_t<float>(q, k, v, out, st, b, h, hkv, sq, skv, d, causal,
                           window, q_offset, sm_scale, s);
  if (dtype == kBF16)
    return launch_t<__nv_bfloat16>(q, k, v, out, st, b, h, hkv, sq, skv, d,
                                   causal, window, q_offset, sm_scale, s);
  return (int)cudaErrorInvalidValue;
}
