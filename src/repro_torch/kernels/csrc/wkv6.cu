// RWKV6 WKV recurrence (forward, from a zero state) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/wkv6.py::_wkv_kernel
// (launched by wkv6_chunked there). Per (batch, head), with r, k, v and
// the decay w in (0, 1) of shape (S, hd), bonus u (hd,) and state
// S_0 = 0:
//     y_t = r_t . (diag(u) k_t v_t^T + S_{t-1}),  S_t = diag(w_t) S_{t-1}
//                                                       + k_t v_t^T
// Outputs: y (B, S, nh, hd) f32 and the final state (B, nh, hd, hd) f32.
//
// What bounds it on an H100: at the rwkv6-1.6b prefill shape (B 4, S 1024,
// 32 heads of 64; r/k/v bf16, w f32) the function moves about 119.6 MB
// (35.7 us at 3.35 TB/s) and needs about 4 hd^2 flops per token and head
// (2.1 GFLOP, 32 us at 67 TFLOP/s f32): the card's bound is bytes.
//
// The previous design (one block of 256 threads per (batch, head), 64-token
// chunks in log space with __expf inside the intra-chunk contraction,
// about 2.6e8 exponentials, scalar loads, one output column per thread)
// took 1.4104 ms there (NVIDIA H100 80GB HBM3, 700 W, chip_smoke.py).
//
// This design works in steps of T = 16 tokens with no exponential and no
// logarithm. With w clamped to max(w, 1e-38) as the reference does, and
// the step starting from state S_in:
//     A[t,u]  = sum_k r_t[k] k_u[k] prod_{m=u+1}^{t-1} w_m[k]     (u < t)
//     A[t,t]  = sum_k r_t[k] u[k] k_t[k]
//     y_t     = sum_{u<=t} A[t,u] v_u + (r_t * prod_{m<t} w_m) S_in
//     S_out   = diag(prod_m w_m) S_in + sum_u (k_u * prod_{m>u} w_m) v_u^T
// The decay products are running products: q_u = k_u, then q_u *= w_t
// after each row t > u, so q_u holds k_u * prod_{m=u+1}^{t-1} w_m when row
// t reads it and ends as the state update's k~_u; r~_t takes a prefix
// product. Every factor lies in (0, 1], so nothing overflows, and a hard
// decay underflows to 0 where the reference's exponential of a sum of
// logarithms does. ref.wkv6_step_ref states the same algorithm in
// PyTorch.
//
// What the design does about the card:
//   * Warp specialisation across steps. A, r~, k~ and the decay depend
//     on r, k and w only, not on the state, so the block's first 256
//     threads (the A group) prepare step s + 1 while the other 256 (the
//     Y group) compute y and the state update of step s; one block
//     barrier per step hands the double-buffered results over. Each
//     group syncs inside itself on its own named barrier.
//   * A group: r, k, the block's v columns and w for step s + 2 arrive by
//     16-byte cp.async (one head's row is 128 (bf16) or 256 (f32) bytes,
//     so every copy is aligned once the base pointers are; the wrapper
//     checks). For step s + 1, 64 threads walk one channel each through
//     the 16 rows: r and max(w, 1e-38) in f32, r~ and the decay; then
//     half warp u walks the 16 rows t of A^T's row u, each lane over 4
//     channels, fully unrolled so the 16 dot products overlap, and a
//     transposing shuffle reduction (15 shuffles) leaves A[t][u] in lane
//     t.
//   * Y group: y is one product [r~ ; A^T]^T [S_in ; V] over 64 + 16
//     rows, each thread holding a 4 x 4 output tile (tokens x columns)
//     over a slice of those rows, the slices then summed in a fixed
//     order; the state update keeps each thread's tile of S in registers
//     for the whole sequence and writes a copy for the next step's y.
//     Products run on the CUDA cores in f32; S and the decay products are
//     never rounded below f32.
//   * One block per (batch, head): 128 blocks of 512 threads at the
//     prefill shape, one per SM. Splitting the value columns over 2 or 4
//     blocks (column c of S and y needs only column c of v; each block
//     recomputes A) measured 1.7x and 3.2x slower on an H100 (PERF.md,
//     PR 14), so the kernel owns all 64 columns.
//   * What bounds it there: with either group's work taken out, the
//     other alone takes well over half of the kernel's time; they share
//     the SM. The Y group reads about 1 KB of shared memory per warp for
//     each 512 multiply-adds, so it is bound by the SM's 128 bytes per
//     clock of shared memory; the A group's step is a chain of barriers,
//     shared-memory round trips and shuffles. 3xTF32 mma.sync for the Y
//     group's products, with one fragment load per mma, moved as many
//     bytes and was no faster.
//   * A ragged last step is padded in shared memory (r = k = v = 0,
//     w = 1, exactly the reference's padding) and its rows past S are
//     not written. No caller pads. The result does not depend on the
//     caller's chunk length (the reference's and the plain version's).
//   * No atomics: every run gives the same bits.
//
// The launcher has a plain C interface (loaded with ctypes). It launches
// on the caller's stream, allocates nothing, does not synchronise, and
// returns a cudaError_t (0 on success) so the caller can raise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kHD = 64;              // head size (rwkv6: 64)
constexpr int kT = 16;               // tokens per step
constexpr int kJ = kHD + kT;         // rows of the y product: r~, then A^T
constexpr int kXS = kT + 4;          // padded row of X (fewer bank conflicts)

enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Layout of one dtype's instantiation. The block's first kGroup threads
// (the A group) prepare step s + 1 while the other kGroup threads (the Y
// group) finish step s.
constexpr int kGroup = 256;

template <typename T>
struct Cfg {
  static constexpr int VC = kHD;                 // value columns per block
  static constexpr int JG = kGroup / VC;         // row slices of the y product
  static constexpr int JR = kJ / JG;             // rows per slice
  static constexpr int CG = VC / 4;              // 4-column groups of S
  static constexpr int KR = kHD * VC / (kGroup * 4);  // S rows per thread
  // raw staging of one step: r, k, v rows of 64 (T), w rows of 64 (f32)
  static constexpr int RAW_RK = kT * kHD * (int)sizeof(T);
  static constexpr int RAW_V = kT * VC * (int)sizeof(T);
  static constexpr int RAW_W = kT * kHD * 4;
  static constexpr int RAW = 2 * RAW_RK + RAW_V + RAW_W;
  // per buffer: X (kJ x kXS), Z (kJ x VC), k~ (kT x 64), decay (64)
  static constexpr int BUF = kJ * kXS + kJ * VC + kT * kHD + kHD;
  // A group's own: r and clamped w in f32 (kT x 64 each)
  static constexpr int OWN = 2 * kT * kHD;
  static constexpr int FLOATS = 2 * BUF + OWN + kHD + JG * kT * VC;
  static constexpr size_t SMEM = 2 * (size_t)RAW + 4 * (size_t)FLOATS;
  static_assert(kGroup == 16 * kT, "a half warp per row of A");
  static_assert(JG * VC == kGroup && JG * JR == kJ, "y tiling");
  static_assert(KR % 4 == 0 && (kGroup / CG) * KR == kHD, "state tiling");
};

// barrier of one thread group (ids 1 and 2; 0 is __syncthreads)
__device__ __forceinline__ void group_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(kGroup) : "memory");
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, a.x * b.x)));
}
__device__ __forceinline__ float4 mul4(float4 a, float4 b) {
  return make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
}
__device__ __forceinline__ float4 sel4(bool c, float4 a, float4 b) {
  return c ? a : b;
}
// 4 consecutive values as f32 (16- or 8-byte aligned)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// One step of a transposing reduction over the 16 lanes of a half warp:
// lanes with bit `off` clear keep the lower half of their N values and
// add the partner's lower half; the others keep and add the upper half.
// After offsets 8, 4, 2 and 1, lane l holds the sum of value l over the
// 16 lanes, added in the same order on every run.
template <int N>
__device__ __forceinline__ void fold(const float (&in)[N],
                                     float (&out)[N / 2], int lane16,
                                     int off) {
  const bool hi = lane16 & off;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const float send = hi ? in[i] : in[i + N / 2];
    const float keep = hi ? in[i + N / 2] : in[i];
    out[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
  }
}

template <typename T>
__global__ void __launch_bounds__(2 * kGroup, 1)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, float* __restrict__ y,
            float* __restrict__ s_out, int seq, int nh) {
  using C = Cfg<T>;
  constexpr int VC = C::VC;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* raw = smem;                            // 2 x RAW bytes
  float* bufs = reinterpret_cast<float*>(smem + 2 * C::RAW);  // 2 x BUF
  float* R32 = bufs + 2 * C::BUF;     // kT x 64: r
  float* W32 = R32 + kT * kHD;         // kT x 64: max(w, 1e-38)
  float* bon = W32 + kT * kHD;         // 64: u
  float* part = bon + kHD;             // JG x kT x VC: y partials
  // buffer i of step-indexed data: X = [r~^T (64 rows); A^T (16 rows)],
  // Z = [S_in (64 rows); v (16 rows)], k~ and the full decay
  auto Xb = [&](int i) { return bufs + i * C::BUF; };
  auto Zb = [&](int i) { return bufs + i * C::BUF + kJ * kXS; };
  auto KTb = [&](int i) { return bufs + i * C::BUF + kJ * kXS + kJ * VC; };
  auto Db = [&](int i) {
    return bufs + i * C::BUF + kJ * kXS + kJ * VC + kT * kHD;
  };

  const int tid = threadIdx.x;
  const bool a_group = tid < kGroup;
  const int gt = a_group ? tid : tid - kGroup;       // thread in its group
  const int bh = blockIdx.x;
  const int b = bh / nh;
  const int h = bh % nh;
  const long long row = (long long)nh * kHD;          // (B, S, nh, 64)
  const long long base = (long long)b * seq * row + (long long)h * kHD;
  const int nsteps = (seq + kT - 1) / kT;

  // A group: step s's rows into staging buffer s & 1 (rows past S are not
  // copied), one commit group per step
  auto copy_rows = [&](auto ch, unsigned char* dst, const void* src,
                       long long stride, int valid) {
    constexpr int CH = decltype(ch)::value;  // 16-byte chunks per row
    const unsigned char* sb = static_cast<const unsigned char*>(src);
    for (int i = gt; i < kT * CH; i += kGroup) {
      const int t = i / CH, c = i % CH;
      if (t < valid) cp_async16(dst + i * 16, sb + t * stride + c * 16);
    }
  };
  auto issue = [&](int s) {
    unsigned char* buf = raw + (s & 1) * C::RAW;
    const int valid = min(kT, seq - s * kT);
    const long long off = base + (long long)s * kT * row;
    using CRK = std::integral_constant<int, kHD * (int)sizeof(T) / 16>;
    using CV = std::integral_constant<int, VC * (int)sizeof(T) / 16>;
    using CW = std::integral_constant<int, kHD * 4 / 16>;
    const long long st = row * (long long)sizeof(T);
    copy_rows(CRK(), buf, r + off, st, valid);
    copy_rows(CRK(), buf + C::RAW_RK, k + off, st, valid);
    copy_rows(CV(), buf + 2 * C::RAW_RK, v + off, st, valid);
    copy_rows(CW(), buf + 2 * C::RAW_RK + C::RAW_V, w + off, row * 4, valid);
    cp_async_commit();
  };

  // A group: wait for step s's rows, pad a ragged step (r = k = v = 0,
  // w = 1), then
  //   1. v into Z; per channel (64 threads), rows in order: r and
  //      max(w, 1e-38) in f32, r~ = r * prod_{m<t} w_m and the step's full
  //      decay;
  //   2. A by running products: half warp u owns row u of
  //      A^T, each lane 4 channels, and walks all 16 rows t (unrolled, so
  //      the dot products of different rows overlap): row t > u reads
  //      q_u = k_u * prod_{m=u+1}^{t-1} w_m, then q_u *= w_t; row u is
  //      the bonus term. The 16 dot products meet in a transposing
  //      reduction, and q_u ends as k~_u.
  auto prepare = [&](int s) {
    cp_async_wait1();                   // this thread's copies of step s
    unsigned char* buf = raw + (s & 1) * C::RAW;
    const int valid = min(kT, seq - s * kT);
    T* rr = reinterpret_cast<T*>(buf);
    T* kk = reinterpret_cast<T*>(buf + C::RAW_RK);
    T* vv = reinterpret_cast<T*>(buf + 2 * C::RAW_RK);
    float* ww = reinterpret_cast<float*>(buf + 2 * C::RAW_RK + C::RAW_V);
    if (valid < kT) {
      for (int i = valid * kHD + gt; i < kT * kHD; i += kGroup) {
        rr[i] = T(0.f);
        kk[i] = T(0.f);
        ww[i] = 1.f;
      }
      for (int i = valid * VC + gt; i < kT * VC; i += kGroup) vv[i] = T(0.f);
    }
    group_sync(1);                      // every copy and pad is visible
    float* X = Xb(s & 1);
    float* Z = Zb(s & 1);
    if (gt >= kHD) {                    // 1. v into Z
      for (int i = gt - kHD; i < kT * VC; i += kGroup - kHD)
        Z[kHD * VC + i] = to_f32(vv[i]);
    } else {                            // ... and per channel, rows in order
      const int ch = gt;
      float pre = 1.f;                  // prod_{m<t} w_m
#pragma unroll
      for (int t = 0; t < kT; ++t) {
        const float wc = fmaxf(ww[t * kHD + ch], 1e-38f);
        const float rv = to_f32(rr[t * kHD + ch]);
        W32[t * kHD + ch] = wc;
        R32[t * kHD + ch] = rv;
        X[ch * kXS + t] = rv * pre;                        // r~
        pre *= wc;
      }
      Db(s & 1)[ch] = pre;
    }
    group_sync(1);
    const int ua = gt / 16;
    const int l16 = gt % 16;
    const int ka = l16 * 4;
    const float4 ku = load4(kk + ua * kHD + ka);
    const float dd = dot4(load4(R32 + ua * kHD + ka), mul4(ku, load4(bon + ka)));
    float4 q = ku;
    float d[kT];
#pragma unroll
    for (int t = 0; t < kT; ++t) {
      d[t] = t == ua ? dd : dot4(load4(R32 + t * kHD + ka), q);
      q = sel4(t == ua, ku, mul4(q, load4(W32 + t * kHD + ka)));
    }
    float d8[8], d4[4], d2[2], d1[1];
    fold<16>(d, d8, l16, 8);
    fold<8>(d8, d4, l16, 4);
    fold<4>(d4, d2, l16, 2);
    fold<2>(d2, d1, l16, 1);
    X[(kHD + ua) * kXS + l16] = l16 >= ua ? d1[0] : 0.f;   // A[t=l16][u]
    *reinterpret_cast<float4*>(&KTb(s & 1)[ua * kHD + ka]) = q;  // k~_u
  };

  float sreg[C::KR][4];                 // Y group: its tile of S
#pragma unroll
  for (int a = 0; a < C::KR; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) sreg[a][c] = 0.f;
  const int scg = gt % C::CG;           // Y group: the tile's columns
  const int k0 = (gt / C::CG) * C::KR;  // ... and rows

  if (a_group) {
    if (gt < kHD) bon[gt] = u[h * kHD + gt];
    issue(0);
    issue(1);
    group_sync(1);                      // bon is written
    prepare(0);
  } else {
    for (int i = gt; i < kHD * VC; i += kGroup) Zb(0)[i] = 0.f;
  }
  __syncthreads();

  for (int s = 0; s < nsteps; ++s) {
    const int cur = s & 1;
    if (a_group) {
      // prepare step s + 1 while the Y group finishes step s
      if (s + 1 < nsteps) {
        issue(s + 2);                   // an empty group past the end
        prepare(s + 1);
      }
    } else {
      const float* X = Xb(cur);
      const float* Z = Zb(cur);
      // y partials: rows [j0, j0 + JR) of [r~ ; A^T]^T [S_in ; V], a
      // 4 x 4 tile (tokens x columns) per thread
      {
        const int jg = gt / VC;
        const int tg = (gt % VC) / C::CG;
        const int cg = (gt % VC) % C::CG;
        float acc[4][4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[a][c] = 0.f;
#pragma unroll
        for (int j = jg * C::JR; j < (jg + 1) * C::JR; ++j) {
          const float4 x =
              *reinterpret_cast<const float4*>(&X[j * kXS + 4 * tg]);
          const float4 z = *reinterpret_cast<const float4*>(&Z[j * VC + 4 * cg]);
          const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            acc[a][0] = fmaf(xs[a], z.x, acc[a][0]);
            acc[a][1] = fmaf(xs[a], z.y, acc[a][1]);
            acc[a][2] = fmaf(xs[a], z.z, acc[a][2]);
            acc[a][3] = fmaf(xs[a], z.w, acc[a][3]);
          }
        }
        float* yp = part + jg * kT * VC;
#pragma unroll
        for (int a = 0; a < 4; ++a)
          *reinterpret_cast<float4*>(&yp[(4 * tg + a) * VC + 4 * cg]) =
              make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
      }
      group_sync(2);
      // y: the slices summed in order, written for the valid rows
      const int t0 = s * kT;
      const int valid = min(kT, seq - t0);
      for (int i = gt; i < kT * C::CG; i += kGroup) {
        const int t = i / C::CG, cq = i % C::CG;
        float4 acc = *reinterpret_cast<const float4*>(&part[t * VC + 4 * cq]);
#pragma unroll
        for (int g = 1; g < C::JG; ++g) {
          const float4 p4 = *reinterpret_cast<const float4*>(
              &part[g * kT * VC + t * VC + 4 * cq]);
          acc.x += p4.x; acc.y += p4.y; acc.z += p4.z; acc.w += p4.w;
        }
        if (t < valid)
          *reinterpret_cast<float4*>(
              &y[base + (long long)(t0 + t) * row + 4 * cq]) = acc;
      }
      // S_out = diag(dec) S_in + k~^T V on the register tile; its copy in
      // the next buffer's Z is the next step's S_in
      const float* KT = KTb(cur);
      const float* dec = Db(cur);
#pragma unroll
      for (int a = 0; a < C::KR; ++a) {
        const float dk = dec[k0 + a];
#pragma unroll
        for (int c = 0; c < 4; ++c) sreg[a][c] *= dk;
      }
#pragma unroll 4
      for (int uu = 0; uu < kT; ++uu) {
        const float4 z = *reinterpret_cast<const float4*>(
            &Z[(kHD + uu) * VC + 4 * scg]);
        float kt[C::KR];
#pragma unroll
        for (int a = 0; a < C::KR; a += 4) {
          const float4 k4 = load4(KT + uu * kHD + k0 + a);
          kt[a] = k4.x; kt[a + 1] = k4.y; kt[a + 2] = k4.z; kt[a + 3] = k4.w;
        }
#pragma unroll
        for (int a = 0; a < C::KR; ++a) {
          sreg[a][0] = fmaf(kt[a], z.x, sreg[a][0]);
          sreg[a][1] = fmaf(kt[a], z.y, sreg[a][1]);
          sreg[a][2] = fmaf(kt[a], z.z, sreg[a][2]);
          sreg[a][3] = fmaf(kt[a], z.w, sreg[a][3]);
        }
      }
      float* zn = Zb(cur ^ 1);
#pragma unroll
      for (int a = 0; a < C::KR; ++a)
        *reinterpret_cast<float4*>(&zn[(k0 + a) * VC + 4 * scg]) =
            make_float4(sreg[a][0], sreg[a][1], sreg[a][2], sreg[a][3]);
    }
    __syncthreads();                    // step s + 1 is ready, s is done
  }

  if (!a_group) {
    float* so = s_out + (long long)bh * kHD * kHD;
#pragma unroll
    for (int a = 0; a < C::KR; ++a)
      *reinterpret_cast<float4*>(&so[(k0 + a) * kHD + 4 * scg]) =
          make_float4(sreg[a][0], sreg[a][1], sreg[a][2], sreg[a][3]);
  }
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const float* w,
           const float* u, float* y, float* s_out, int b, int seq, int nh,
           cudaStream_t stream) {
  const size_t smem = Cfg<T>::SMEM;
  static bool attr_set = false;      // once per instantiation and process
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        wkv6_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  wkv6_kernel<T><<<b * nh, 2 * kGroup, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), w, u, y, s_out, seq, nh);
  return (int)cudaGetLastError();
}

}  // namespace

// r, k, v: (B, S, nh, 64) contiguous in rkv_dtype; w: the same shape in
// f32; u: (nh, 64) f32; y: (B, S, nh, 64) f32; s_out: (B, nh, 64, 64)
// f32. r, k, v and w start at 16-byte aligned addresses.
extern "C" int repro_wkv6(const void* r, const void* k, const void* v,
                          const void* w, const void* u, void* y, void* s_out,
                          int rkv_dtype, int b, int seq, int nh, int hd,
                          void* stream) {
  if (b < 1 || seq < 1 || nh < 1 || hd != kHD)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* uf = static_cast<const float*>(u);
  float* yf = static_cast<float*>(y);
  float* sf = static_cast<float*>(s_out);
  if (rkv_dtype == kF32)
    return launch<float>(r, k, v, wf, uf, yf, sf, b, seq, nh, s);
  if (rkv_dtype == kBF16)
    return launch<__nv_bfloat16>(r, k, v, wf, uf, yf, sf, b, seq, nh, s);
  return (int)cudaErrorInvalidValue;
}
