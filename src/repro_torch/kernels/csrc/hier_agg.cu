// Segment-weighted bank aggregation and bank resync for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/hier_agg.py:
//   * _segment_agg_kernel (launched by _segment_agg_call) behind
//     segment_agg / segment_sum_partial / hier_agg:
//         out[j] = scale_j * sum_{i: seg_i = j} w_i * bank[i]
//     with scale_j = 1 / max(sum_{i: seg_i = j} w_i, 1e-9) (segment_agg)
//     or 1 (segment_sum_partial, which also returns the (E,) sums);
//   * _segment_bcast_kernel behind segment_broadcast:
//         out[i] = models[seg_i], converted to the bank's dtype.
//
// What bounds them on an H100 (80 GB HBM3 at 3.35 TB/s): both are pure
// data movement. segment_agg reads the (N, P) bank once and writes the
// (E, P) result once (2 flops per bank element, far below the f32
// rate); segment_broadcast reads the (E, P) models and writes (N, P).
// At the CIFAR bank (N = 50, E = 5, P = 456,906, f32) each moves about
// 100.5 MB, so the floor is about 30 us; the MNIST bank (P = 21,840)
// moves 4.8 MB (1.4 us) and is bound by memory latency and the launch.
//
// segment_agg, as redesigned for Hopper (the previous design took 0.0470 ms
// at CIFAR Eq. 1 and 0.0083 ms at MNIST Eq. 1, where torch.mm on a
// one-hot matrix took 0.0044 ms; its wrapper spent 0.23-0.27 ms per call
// on about eight small torch launches for the weight sums; NVIDIA H100
// 80GB HBM3, 700 W, chip_smoke.py):
//   * One launch does everything. Every warp sums the E segment weights
//     itself as it walks the rows: lane j adds the weight of each row of
//     segment j, in ascending row order (the same order, hence the same
//     bits, in every warp), and a shuffle hands lane j's 1 / max(sum,
//     1e-9) to the whole warp for the epilogue in the normalised mode.
//     No shared memory, no barrier. Block 0 writes the sums when the
//     caller asks for them. The wrapper issues no torch operation but
//     torch.empty for the outputs.
//   * Each thread owns one column of P and walks the rows in ascending
//     order, one fmaf chain per (segment, column): no row is split across
//     threads or blocks, so a subset of rows (a shard, an edge) sums to
//     the same bits as the full chain restricted to it, and a zero-weight
//     row leaves every accumulator unchanged (fmaf(0, x, acc) == acc).
//     No atomics: every run gives the same bits.
//   * Rows come in batches loaded into registers before the
//     compare-select chain, so each thread has 16 independent loads in
//     flight (the previous design: 4); a bank of at most 8 rows (Eq. 2)
//     takes batches of 8. Loads stay scalar: a bank row starts at any
//     4-byte (f32) or 2-byte (bf16) offset mod 16 (CIFAR's rows sit at 8
//     and 4 bytes mod 16), and the warp's 32 neighbouring columns
//     coalesce anyway.
//   * Blocks are 256 columns wide where P gives every SM at least four
//     of them (CIFAR: 1,785 blocks), and narrower down to 32 columns
//     where P is small: MNIST's P = 21,840 gives 683 blocks of 32 on an
//     H100 SXM's 132 SMs (the launcher reads the card's SM count).
//   * The E accumulators stay in registers: the compare-select chain is
//     unrolled over a compile-time count (E itself for E <= 8, else 16 or
//     32), so no accumulator is indexed dynamically. Ids outside [0, E)
//     match no slot and add nothing.
//   * bf16 banks are read through __bfloat162float and accumulated in
//     f32; the resync writes bf16 through __float2bfloat16 (round to
//     nearest even, as torch's .to(torch.bfloat16) does).
//
// segment_broadcast walks (row, column) with the column fastest, so both
// its loads and its stores are coalesced. Each thread writes its column
// for 16 consecutive bank rows: a block per (row, column tile) made 178k
// blocks of one load and one store each at the CIFAR resync shape and
// reached 27 % of the bound on an H100; the model rows it re-reads stay
// in L1/L2 (E x 512 bytes per block).
//
// The launchers have a plain C interface (loaded with ctypes). They
// launch on the caller's stream, allocate nothing, do not synchronise,
// and return cudaGetLastError() so the caller can raise on a refused
// launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;        // threads (columns) per block, at most
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

template <typename T, int EMAX, int ROWS>
__global__ void __launch_bounds__(kThreads)
segment_agg_kernel(const T* __restrict__ bank, const float* __restrict__ w,
                   const int* __restrict__ seg, float* __restrict__ out,
                   float* __restrict__ wsum_out, int n, int64_t p, int e,
                   int normalize) {
  const int lane = threadIdx.x % 32;
  const int64_t col = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = col < p;
  float acc[EMAX];
#pragma unroll
  for (int j = 0; j < EMAX; ++j) acc[j] = 0.0f;
  float ws = 0.0f;      // lane j: the weight sum of segment j, rows in order
  const T* x = bank + (active ? col : 0);
  for (int i0 = 0; i0 < n; i0 += ROWS) {
    float v[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {       // all loads first
      v[r] = active && i0 + r < n ? load_f32(x + (int64_t)(i0 + r) * p)
                                  : 0.0f;
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {       // rows in ascending order
      const bool ok = i0 + r < n;
      const int s = ok ? __ldg(seg + i0 + r) : -1;
      const float wi = ok ? __ldg(w + i0 + r) : 0.0f;
      if (lane == s) ws += wi;
#pragma unroll
      for (int j = 0; j < EMAX; ++j) {
        if (j == s) acc[j] = fmaf(wi, v[r], acc[j]);
      }
    }
  }
  if (wsum_out != nullptr && blockIdx.x == 0 && threadIdx.x < e) {
    wsum_out[threadIdx.x] = ws;
  }
  const float scale = normalize ? 1.0f / fmaxf(ws, 1e-9f) : 1.0f;
#pragma unroll
  for (int j = 0; j < EMAX; ++j) {
    const float sc = __shfl_sync(0xffffffffu, scale, j);
    if (active && j < e) out[(int64_t)j * p + col] = acc[j] * sc;
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

// The card's SM count, read once per process (an H100 SXM has 132, the
// PCIe card 114).
cudaError_t sm_count(int* sms) {
  static int cached = 0;
  if (cached == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) {
      e = cudaDeviceGetAttribute(&cached, cudaDevAttrMultiProcessorCount,
                                 dev);
    }
    if (e != cudaSuccess) {
      cached = 0;
      return e;
    }
  }
  *sms = cached;
  return cudaSuccess;
}

template <typename T, int EMAX>
void launch_agg(const T* bank, const float* w, const int* seg, float* out,
                float* wsum, int n, int64_t p, int e, int normalize, int sms,
                cudaStream_t stream) {
  // narrow blocks where P is small, so that every SM holds several
  int threads = kThreads;
  while (threads > 32 && (p + threads - 1) / threads < 4 * sms) {
    threads /= 2;
  }
  const dim3 grid((unsigned)(p > 0 ? (p + threads - 1) / threads : 1));
  // rows loaded ahead: all of a short bank (Eq. 2: one row per edge),
  // else 16 (8 or 32 measured slower at the HFL banks on an H100)
  if (n <= 8) {
    segment_agg_kernel<T, EMAX, 8><<<grid, threads, 0, stream>>>(
        bank, w, seg, out, wsum, n, p, e, normalize);
  } else {
    segment_agg_kernel<T, EMAX, 16><<<grid, threads, 0, stream>>>(
        bank, w, seg, out, wsum, n, p, e, normalize);
  }
}

template <typename T>
void launch_segment_agg(const void* bank, const void* w, const void* seg,
                        void* out, void* wsum, int n, int64_t p, int e,
                        int norm, int sms, cudaStream_t st) {
  const T* b = static_cast<const T*>(bank);
  const float* wf = static_cast<const float*>(w);
  const int* s = static_cast<const int*>(seg);
  float* o = static_cast<float*>(out);
  float* ws = static_cast<float*>(wsum);
  switch (e) {
    case 1: launch_agg<T, 1>(b, wf, s, o, ws, n, p, e, norm, sms, st); break;
    case 2: launch_agg<T, 2>(b, wf, s, o, ws, n, p, e, norm, sms, st); break;
    case 3: launch_agg<T, 3>(b, wf, s, o, ws, n, p, e, norm, sms, st); break;
    case 4: launch_agg<T, 4>(b, wf, s, o, ws, n, p, e, norm, sms, st); break;
    case 5: launch_agg<T, 5>(b, wf, s, o, ws, n, p, e, norm, sms, st); break;
    case 6: launch_agg<T, 6>(b, wf, s, o, ws, n, p, e, norm, sms, st); break;
    case 7: launch_agg<T, 7>(b, wf, s, o, ws, n, p, e, norm, sms, st); break;
    case 8: launch_agg<T, 8>(b, wf, s, o, ws, n, p, e, norm, sms, st); break;
    default:
      if (e <= 16) {
        launch_agg<T, 16>(b, wf, s, o, ws, n, p, e, norm, sms, st);
      } else {
        launch_agg<T, kMaxSegments>(b, wf, s, o, ws, n, p, e, norm, sms, st);
      }
  }
}

}  // namespace

extern "C" {

// bank (n, p) in bank_dtype (0 = f32, 1 = bf16), w (n,) f32, seg (n,)
// int32 -> out (e, p) f32, scaled by 1 / max(sum w, 1e-9) per segment when
// normalize is 1 and by 1 when it is 0; wsum (e,) f32 receives the
// per-segment weight sums unless it is null. All row-major, contiguous.
int repro_segment_agg(const void* bank, int bank_dtype, const void* w,
                      const void* seg, void* out, void* wsum, int n,
                      long long p, int e, int normalize, void* stream) {
  if (n < 0 || p < 0 || e < 1 || e > kMaxSegments) {
    return (int)cudaErrorInvalidValue;
  }
  if (p == 0 && wsum == nullptr) return (int)cudaSuccess;
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bank_dtype == kF32) {
    launch_segment_agg<float>(bank, w, seg, out, wsum, n, p, e, normalize,
                              sms, st);
  } else if (bank_dtype == kBF16) {
    launch_segment_agg<__nv_bfloat16>(bank, w, seg, out, wsum, n, p, e,
                                      normalize, sms, st);
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
