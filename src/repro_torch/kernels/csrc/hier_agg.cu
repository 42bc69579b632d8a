// Segment-weighted bank aggregation and bank resync for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/hier_agg.py:
//   * _segment_agg_kernel (launched by _segment_agg_call) behind
//     segment_agg / segment_sum_partial / hier_agg:
//         out[j] = scale[j] * sum_{i: seg_i = j} w_i * bank[i]
//   * _segment_bcast_kernel behind segment_broadcast:
//         out[i] = models[seg_i], converted to the bank's dtype.
//
// What bounds them on an H100 (80 GB HBM3 at 3.35 TB/s): both are pure
// data movement. segment_agg reads the (N, P) bank once and writes the
// (E, P) result once (2 flops per bank element, far below the f32
// rate); segment_broadcast reads the (E, P) models and writes (N, P).
// At the CIFAR bank (N = 50, E = 5, P = 456,906, f32) each moves about
// 100.5 MB, so the floor is about 30 us; the MNIST bank (P = 21,840)
// moves 4.8 MB and is bound by launch latency, not bandwidth.
//
// What the design does about it:
//   * The TPU kernel builds an (E, N) one-hot matrix and reduces it on
//     the MXU over padded (N, 128k) column tiles. Here each thread owns
//     one column of P, so every warp reads 128 contiguous bytes of a
//     bank row per load (coalesced), there is no padding copy, and the
//     ragged edge is masked by the column bound.
//   * The E accumulators stay in registers: the row loop compares the
//     row's segment id against every slot of a fully unrolled loop over
//     a compile-time cap (1, 8 or 32 segments), so no accumulator is
//     indexed dynamically and nothing spills to local memory.
//   * Rows are walked in ascending order with fmaf in f32 and no
//     atomics anywhere: a zero-weight row leaves its accumulator
//     unchanged (fmaf(0, x, acc) == acc for finite x), and every run
//     gives the same bits. The scale is applied as a multiply, as the
//     reference normalizes by multiplying with the reciprocal.
//   * bf16 banks are read through __bfloat162float and accumulated in
//     f32; the resync writes bf16 through __float2bfloat16 (round to
//     nearest even, as torch's .to(torch.bfloat16) does).
//   * The resync walks (row, column) with the column fastest, so both
//     its loads and its stores are coalesced. Each thread writes its
//     column for 16 consecutive bank rows: a block per (row, column
//     tile) made 178k blocks of one load and one store each at the
//     CIFAR resync shape and reached 27 % of the bound on an H100; the model
//     rows it re-reads stay in L1/L2 (E x 512 bytes per block).
// Vectorised 16-byte accesses, TMA and persistent blocks are later work.
//
// The launchers have a plain C interface (loaded with ctypes). They
// launch on the caller's stream, allocate nothing, do not synchronise,
// and return cudaGetLastError() so the caller can raise on a refused
// launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;        // threads (columns) per block
constexpr int kMaxSegments = 32;     // largest E the register path takes
constexpr int kBcastRows = 16;       // bank rows each resync thread writes

enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ void store_from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T, int EMAX>
__global__ void __launch_bounds__(kThreads)
segment_agg_kernel(const T* __restrict__ bank, const float* __restrict__ w,
                   const int* __restrict__ seg,
                   const float* __restrict__ scale, float* __restrict__ out,
                   int n, int64_t p, int e) {
  const int64_t col = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (col >= p) return;
  float acc[EMAX];
#pragma unroll
  for (int j = 0; j < EMAX; ++j) acc[j] = 0.0f;
  const T* x = bank + col;
#pragma unroll 4
  for (int i = 0; i < n; ++i) {
    const int s = __ldg(seg + i);
    const float wi = __ldg(w + i);
    const float v = load_f32(x + (int64_t)i * p);
#pragma unroll
    for (int j = 0; j < EMAX; ++j) {
      if (j == s) acc[j] = fmaf(wi, v, acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < EMAX; ++j) {
    if (j < e) out[(int64_t)j * p + col] = acc[j] * __ldg(scale + j);
  }
}

template <typename TO>
__global__ void __launch_bounds__(kThreads)
segment_broadcast_kernel(const float* __restrict__ models,
                         const int* __restrict__ seg, TO* __restrict__ out,
                         int n, int64_t p, int e) {
  const int64_t col = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (col >= p) return;
  const int row0 = blockIdx.y * kBcastRows;
  const int rows = min(kBcastRows, n - row0);
#pragma unroll 4
  for (int r = 0; r < rows; ++r) {
    const int64_t row = row0 + r;
    const int s = __ldg(seg + row);
    // an id outside [0, E) matches no one-hot column in the TPU kernel,
    // so its row is written as zeros
    const float v = (s >= 0 && s < e)
                        ? __ldg(models + (int64_t)s * p + col) : 0.0f;
    store_from_f32(out + row * p + col, v);
  }
}

template <typename T>
void launch_segment_agg(const void* bank, const void* w, const void* seg,
                        const void* scale, void* out, int n, int64_t p,
                        int e, cudaStream_t stream) {
  const dim3 grid((unsigned)((p + kThreads - 1) / kThreads));
  const T* b = static_cast<const T*>(bank);
  const float* wf = static_cast<const float*>(w);
  const int* s = static_cast<const int*>(seg);
  const float* sc = static_cast<const float*>(scale);
  float* o = static_cast<float*>(out);
  if (e <= 1) {
    segment_agg_kernel<T, 1><<<grid, kThreads, 0, stream>>>(
        b, wf, s, sc, o, n, p, e);
  } else if (e <= 8) {
    segment_agg_kernel<T, 8><<<grid, kThreads, 0, stream>>>(
        b, wf, s, sc, o, n, p, e);
  } else {
    segment_agg_kernel<T, kMaxSegments><<<grid, kThreads, 0, stream>>>(
        b, wf, s, sc, o, n, p, e);
  }
}

}  // namespace

extern "C" {

// bank (n, p) in bank_dtype (0 = f32, 1 = bf16), w (n,) f32, seg (n,)
// int32, scale (e,) f32 -> out (e, p) f32. All row-major, contiguous.
int repro_segment_agg(const void* bank, int bank_dtype, const void* w,
                      const void* seg, const void* scale, void* out, int n,
                      long long p, int e, void* stream) {
  if (n < 0 || p < 0 || e < 1 || e > kMaxSegments) {
    return (int)cudaErrorInvalidValue;
  }
  if (p == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bank_dtype == kF32) {
    launch_segment_agg<float>(bank, w, seg, scale, out, n, p, e, st);
  } else if (bank_dtype == kBF16) {
    launch_segment_agg<__nv_bfloat16>(bank, w, seg, scale, out, n, p, e,
                                      st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// models (e, p) f32, seg (n,) int32 -> out (n, p) in out_dtype
// (0 = f32, 1 = bf16). All row-major, contiguous.
int repro_segment_broadcast(const void* models, const void* seg, void* out,
                            int out_dtype, int n, long long p, int e,
                            void* stream) {
  if (n < 0 || n > 65535 * kBcastRows || p < 0 || e < 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0 || p == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)((p + kThreads - 1) / kThreads),
                  (unsigned)((n + kBcastRows - 1) / kBcastRows));
  const float* m = static_cast<const float*>(models);
  const int* s = static_cast<const int*>(seg);
  if (out_dtype == kF32) {
    segment_broadcast_kernel<float><<<grid, kThreads, 0, st>>>(
        m, s, static_cast<float*>(out), n, p, e);
  } else if (out_dtype == kBF16) {
    segment_broadcast_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        m, s, static_cast<__nv_bfloat16*>(out), n, p, e);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
