// Chunked RWKV6 WKV recurrence (forward, from a zero state) for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/wkv6.py::_wkv_kernel
// (launched by wkv6_chunked there). Per (batch, head), with r, k, v and
// the decay w in (0, 1) of shape (S, hd), bonus u (hd,) and state
// S_0 = 0:
//     y_t = r_t . (diag(u) k_t v_t^T + S_{t-1}),  S_t = diag(w_t) S_{t-1}
//                                                       + k_t v_t^T
// computed chunk by chunk as the TPU kernel does, with logw = log(max(w,
// 1e-38)), logcum its inclusive cumsum inside the chunk and lprev =
// logcum - logw:
//     A[t,u] = sum_k r[t,k] k[u,k] exp(lprev[t,k] - logcum[u,k])  (u < t)
//     A[t,t] = sum_k r[t,k] u[k] k[t,k]
//     y      = A v + (r * exp(lprev)) S_in
//     S_out  = S_in * exp(logcum[C-1]) + (k * exp(logcum[C-1] - logcum))^T v
// Every exponent is <= 0, so hard decays cannot overflow (the factored
// (r e^+)(k e^-)^T form does). Outputs: y (B, S, nh, hd) f32 and the
// final state (B, nh, hd, hd) f32.
//
// What bounds it on an H100: at the rwkv6-1.6b prefill shape (B 4, S 1024,
// 32 heads of 64, chunk 64; r/k/v bf16, w f32) the function moves about
// 119.6 MB (35.7 us at 3.35 TB/s) and needs about 4 hd^2 flops per token
// and head, a multiply-add per state element for k v^T and one for r . S
// (2.1 GFLOP, 32 us at 67 TFLOP/s f32): the card's bound is bytes. This
// design costs more than the function needs: it evaluates about 2.9e8
// exponentials, 2.6e8 of them inside the intra-chunk contraction (69 us
// at the SFU's 16 per clock per SM), and 3.5 GFLOP of f32 products, so
// its own floor sits near twice the card's bound.
//
// What the design does about it:
//   * One block of 256 threads per (batch, head): 128 blocks at the
//     prefill shape, one per SM. The Pallas grid's sequential chunk axis
//     is a loop inside the block, and the (64, 64) f32 state stays in
//     shared memory for the whole sequence.
//   * A chunk of r, k, v, log w, logcum and lprev is staged in shared
//     memory as f32 (rows padded by one float: no bank conflicts when a
//     warp walks 32 rows of one column). Each thread of the A loop owns one
//     column u and C/(256/C) rows t, reads k[u], logcum[u] once per channel
//     and the row values by broadcast, and skips the upper triangle a warp
//     at a time. The exponential in that loop is __expf (ex2.approx); its
//     argument is <= 0, where the approximation's relative error stays
//     near 2^-21.
//   * r * exp(lprev) and k * exp(logcum[C-1] - logcum) overwrite r and k
//     in place once A is done, so the carry-in and the state update are
//     plain products over shared memory.
//   * A ragged last chunk is masked in the kernel: rows past S load
//     r = k = v = 0 and w = 1, exactly the reference's padding, and are not
//     written. No caller pads.
//
// The launcher has a plain C interface (loaded with ctypes). It launches
// on the caller's stream, allocates nothing, does not synchronise, and
// returns a cudaError_t (0 on success) so the caller can raise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kHD = 64;              // head size (rwkv6: 64)
constexpr int kLD = kHD + 1;         // padded row

enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <int C>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(4 * C * kLD + C * kHD + C * (C + 1) +
                                  kHD * kHD + kHD);
}

template <typename TR, int C>
__global__ void __launch_bounds__(kThreads)
wkv6_kernel(const TR* __restrict__ r, const TR* __restrict__ k,
            const TR* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, float* __restrict__ y,
            float* __restrict__ s_out, int seq, int nh) {
  constexpr int TG = kThreads / C;     // row groups of the A loop
  constexpr int TA = C / TG;           // rows per thread in the A loop
  constexpr int YG = kThreads / kHD;   // row groups of the y/state loops
  constexpr int TY = C / YG;           // y rows per thread
  constexpr int TS = kHD / YG;         // state rows per thread
  extern __shared__ float smem[];
  float* r_s = smem;                   // C x LD: r, then r * exp(lprev)
  float* k_s = r_s + C * kLD;          // C x LD: k, then k * exp(lc_end - lc)
  float* lc_s = k_s + C * kLD;         // C x LD: inclusive cumsum of log w
  float* lp_s = lc_s + C * kLD;        // C x LD: log w, then lc - log w
  float* v_s = lp_s + C * kLD;         // C x HD
  float* a_s = v_s + C * kHD;          // C x (C + 1)
  float* st = a_s + C * (C + 1);       // HD x HD state
  float* u_s = st + kHD * kHD;         // HD

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / nh;
  const int h = bh % nh;
  const long long row = (long long)nh * kHD;          // (B, S, nh, HD)
  const long long base = (long long)b * seq * row + (long long)h * kHD;

  for (int i = tid; i < kHD * kHD; i += kThreads) st[i] = 0.f;
  if (tid < kHD) u_s[tid] = u[h * kHD + tid];

  const int n_chunks = (seq + C - 1) / C;
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int t0 = ci * C;
    __syncthreads();                  // the previous chunk is done
    for (int i = tid; i < C * kHD; i += kThreads) {
      const int t = i / kHD, d = i % kHD;
      const bool ok = t0 + t < seq;
      const long long off = base + (long long)(t0 + t) * row + d;
      r_s[t * kLD + d] = ok ? to_f32(r[off]) : 0.f;
      k_s[t * kLD + d] = ok ? to_f32(k[off]) : 0.f;
      v_s[t * kHD + d] = ok ? to_f32(v[off]) : 0.f;
      const float wv = ok ? w[off] : 1.f;
      lp_s[t * kLD + d] = logf(fmaxf(wv, 1e-38f));
    }
    __syncthreads();
    if (tid < kHD) {                  // per-channel cumsum along time
      float run = 0.f;
      for (int t = 0; t < C; ++t) {
        const float lw = lp_s[t * kLD + tid];
        run += lw;
        lc_s[t * kLD + tid] = run;
        lp_s[t * kLD + tid] = run - lw;
      }
    }
    __syncthreads();

    {  // A: strict lower triangle, exponential inside the contraction
      const int uu = tid % C, tg = tid / C;
      float a[TA];
#pragma unroll
      for (int i = 0; i < TA; ++i) a[i] = 0.f;
      for (int kk = 0; kk < kHD; ++kk) {
        const float ku = k_s[uu * kLD + kk];
        const float lcu = lc_s[uu * kLD + kk];
#pragma unroll
        for (int i = 0; i < TA; ++i) {
          const int t = tg + i * TG;
          if (uu < t)
            a[i] += r_s[t * kLD + kk] * ku *
                    __expf(lp_s[t * kLD + kk] - lcu);
        }
      }
#pragma unroll
      for (int i = 0; i < TA; ++i) {
        const int t = tg + i * TG;
        if (uu != t) a_s[t * (C + 1) + uu] = uu < t ? a[i] : 0.f;
      }
      if (tid < C) {                  // bonus diagonal
        float dg = 0.f;
        for (int kk = 0; kk < kHD; ++kk)
          dg += r_s[tid * kLD + kk] * u_s[kk] * k_s[tid * kLD + kk];
        a_s[tid * (C + 1) + tid] = dg;
      }
    }
    __syncthreads();
    for (int i = tid; i < C * kHD; i += kThreads) {
      const int t = i / kHD, kk = i % kHD;
      r_s[t * kLD + kk] *= expf(lp_s[t * kLD + kk]);
      k_s[t * kLD + kk] *= expf(lc_s[(C - 1) * kLD + kk] - lc_s[t * kLD + kk]);
    }
    __syncthreads();

    const int dd = tid % kHD, yg = tid / kHD;
#pragma unroll 1
    for (int i = 0; i < TY; ++i) {    // y = A v + (r exp(lprev)) S_in
      const int t = yg + i * YG;
      float acc = 0.f;
      for (int uu = 0; uu <= t; ++uu)
        acc += a_s[t * (C + 1) + uu] * v_s[uu * kHD + dd];
      float carry = 0.f;
      for (int kk = 0; kk < kHD; ++kk)
        carry += r_s[t * kLD + kk] * st[kk * kHD + dd];
      if (t0 + t < seq) y[base + (long long)(t0 + t) * row + dd] = acc + carry;
    }
    __syncthreads();                  // every read of S_in is done
#pragma unroll 1
    for (int i = 0; i < TS; ++i) {    // S_out
      const int kk = yg + i * YG;
      float acc = 0.f;
      for (int uu = 0; uu < C; ++uu)
        acc += k_s[uu * kLD + kk] * v_s[uu * kHD + dd];
      st[kk * kHD + dd] =
          st[kk * kHD + dd] * expf(lc_s[(C - 1) * kLD + kk]) + acc;
    }
  }
  __syncthreads();
  float* so = s_out + (long long)bh * kHD * kHD;
  for (int i = tid; i < kHD * kHD; i += kThreads) so[i] = st[i];
}

template <typename TR, int C>
int launch(const void* r, const void* k, const void* v, const float* w,
           const float* u, float* y, float* s_out, int b, int seq, int nh,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<C>();
  static bool attr_set = false;      // once per instantiation and process
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        wkv6_kernel<TR, C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  wkv6_kernel<TR, C><<<b * nh, kThreads, smem, stream>>>(
      static_cast<const TR*>(r), static_cast<const TR*>(k),
      static_cast<const TR*>(v), w, u, y, s_out, seq, nh);
  return (int)cudaGetLastError();
}

template <typename TR>
int launch_c(const void* r, const void* k, const void* v, const float* w,
             const float* u, float* y, float* s_out, int b, int seq, int nh,
             int chunk, cudaStream_t stream) {
  if (chunk == 64)
    return launch<TR, 64>(r, k, v, w, u, y, s_out, b, seq, nh, stream);
  if (chunk == 32)
    return launch<TR, 32>(r, k, v, w, u, y, s_out, b, seq, nh, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// r, k, v: (B, S, nh, 64) contiguous in rkv_dtype; w: the same shape in
// f32; u: (nh, 64) f32; y: (B, S, nh, 64) f32; s_out: (B, nh, 64, 64)
// f32. chunk is 32 or 64.
extern "C" int repro_wkv6(const void* r, const void* k, const void* v,
                          const void* w, const void* u, void* y, void* s_out,
                          int rkv_dtype, int b, int seq, int nh, int hd,
                          int chunk, void* stream) {
  if (b < 1 || seq < 1 || nh < 1 || hd != kHD)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* uf = static_cast<const float*>(u);
  float* yf = static_cast<float*>(y);
  float* sf = static_cast<float*>(s_out);
  if (rkv_dtype == kF32)
    return launch_c<float>(r, k, v, wf, uf, yf, sf, b, seq, nh, chunk, s);
  if (rkv_dtype == kBF16)
    return launch_c<__nv_bfloat16>(r, k, v, wf, uf, yf, sf, b, seq, nh,
                                   chunk, s);
  return (int)cudaErrorInvalidValue;
}
