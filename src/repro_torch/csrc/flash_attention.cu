// Causal (and sliding-window) flash attention, forward, for Hopper (sm_90a).
//
// Replaces the Pallas kernel _fa_kernel of
// src/repro/kernels/flash_attention/kernel.py (wrapper flash_attention_bhsd,
// model-layout entry ops.py::flash_attention), which the reference's
// attention reaches for backend="pallas" on the prefill of every layer.
//
// What it computes, per (batch, q head), over positions counted from 0:
//   s[i, j] = (q[i] . k[j]) * scale          scale = 1/sqrt(D), after the dot
//   live(i, j) = j <= i  and  (no window or i - j < window)  and  j < Skv
//   s = live ? s : -1e30                      (-1e30, not -inf)
//   out[i] = sum_j p[i, j] v[j] / max(l[i], 1e-30),  p = exp(s - running max)
// with the reference's online softmax: a running max m, normalizer l and
// accumulator per row, all float32, updated once per kv tile; a row whose
// running max is still -1e30 keeps p = 0. The kv head of q head h is
// h / (Hq / Hkv) (GQA). Inputs are float32 or bf16 (converted to float32 as
// they enter shared memory); the output is written in the inputs' dtype.
// Ragged S is handled by bounds masks (rows past S are not stored, keys past
// Skv are masked), where the reference pads to its block size; for the
// self-attention it serves (Skv == S) the padded keys sit after every query
// and are causally masked, so the results are the same.
//
// Layout, in and out: q (B, S, Hq, D), k/v (B, Skv, Hkv, D), o (B, S, Hq, D),
// contiguous. D is a template parameter: 64 and 128.
//
// What bounds it on this card: the operations. Causal prefill at smollm-135m
// (B=8, Hq=9, S=1024, D=64) is 4 * B * Hq * D * (S (S + 1) / 2) = 9.7 GFLOP
// against 25 MB of q, k, v and o: 9.8 us at the dense bf16 tensor-core rate
// (989 TFLOP/s), 7.5 us of bytes at 3.35 TB/s. This kernel does its dot
// products as float32 FMAs outside the tensor cores (67 TFLOP/s), so its own
// floor is about 145 us there; wgmma, TMA and a tuned tile are later work.
//
// Design. One block of 256 threads per (64-row q tile, q head, batch). The
// q tile is staged once in shared memory as float32; the kernel then walks
// only the kv tiles of 64 keys that hold a live key for some row of the q
// tile (causal: up to the diagonal tile; window: from the tile holding
// q0 - window + 1), so fully masked tiles are skipped as in the reference.
// Each kv tile is staged through shared memory as float32. A thread owns a
// 4 x 4 block of the 64 x 64 score tile (rows 4*ty .. 4*ty+3, keys tx + 16c)
// and a 4 x (D/16) block of the accumulator; the 16 threads of a row group
// are one half-warp, so row max and row sum are xor-shuffles over 16 lanes.
// Probabilities go through shared memory for the product with V. Rows are
// padded by 4 floats so that 16-byte shared loads of neighbouring rows fall
// in different banks. No atomics: the result does not change between runs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per kv tile
constexpr int kThreads = 256;  // 16 row groups of 4 rows x 16 lanes
constexpr int kPld = kBK + 4;  // padded row of the probability tile
constexpr float kNegInf = -1e30f;
static_assert(kBQ == kBK, "load_tile stages q and kv tiles of one height");

__device__ __forceinline__ void load16(const float* src, float* dst) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
}

__device__ __forceinline__ void load16(const __nv_bfloat16* src, float* dst) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
  *reinterpret_cast<float4*>(dst) =
      make_float4(__bfloat162float(h[0]), __bfloat162float(h[1]),
                  __bfloat162float(h[2]), __bfloat162float(h[3]));
  *reinterpret_cast<float4*>(dst + 4) =
      make_float4(__bfloat162float(h[4]), __bfloat162float(h[5]),
                  __bfloat162float(h[6]), __bfloat162float(h[7]));
}

__device__ __forceinline__ void store(float* dst, float x) { *dst = x; }

__device__ __forceinline__ void store(__nv_bfloat16* dst, float x) {
  *dst = __float2bfloat16(x);  // round to nearest even, as astype does
}

// Rows row0 .. row0 + 63 of a (rows, D) matrix whose rows are row_stride
// elements apart, into a float32 tile with rows D + 4 floats apart; rows at
// or past n_rows are zero.
template <typename T, int D>
__device__ void load_tile(const T* __restrict__ base, long long row_stride,
                          int row0, int n_rows, float* tile) {
  constexpr int kVec = 16 / sizeof(T);  // elements in 16 bytes
  constexpr int kChunksPerRow = D / kVec;
  for (int c = threadIdx.x; c < kBK * kChunksPerRow; c += kThreads) {
    const int r = c / kChunksPerRow;
    const int e = (c % kChunksPerRow) * kVec;
    float* dst = tile + r * (D + 4) + e;
    if (row0 + r < n_rows) {
      load16(base + (row0 + r) * row_stride + e, dst);
    } else {
#pragma unroll
      for (int i = 0; i < kVec; ++i) dst[i] = 0.f;
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o, int S,
                           int Skv, int Hq, int Hkv, int window, float scale) {
  constexpr int kLd = D + 4;     // padded row of the q, k and v tiles
  constexpr int kCols = D / 16;  // accumulator columns per thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kBQ * kLd;
  float* Vs = Ks + kBK * kLd;
  float* Ps = Vs + kBK * kLd;

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const long long q_stride = (long long)Hq * D;
  const long long kv_stride = (long long)Hkv * D;
  const T* kb = k + ((long long)b * Skv * Hkv + hk) * D;
  const T* vb = v + ((long long)b * Skv * Hkv + hk) * D;

  load_tile<T, D>(q + ((long long)b * S * Hq + h) * D, q_stride, q0, S, Qs);

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int cc = 0; cc < kCols; ++cc) acc[r][cc] = 0.f;
  }

  // the kv tiles that hold a live key for some row of this q tile
  const int kt_end = min((Skv + kBK - 1) / kBK, (q0 + kBQ - 1) / kBK + 1);
  int kt_begin = 0;
  if (window > 0 && q0 - (window - 1) > 0) kt_begin = (q0 - (window - 1)) / kBK;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the last tile's reads of Ks, Vs and Ps are done
    load_tile<T, D>(kb, kv_stride, k0, Skv, Ks);
    load_tile<T, D>(vb, kv_stride, k0, Skv, Vs);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        qv[r] = *reinterpret_cast<const float4*>(Qs + (4 * ty + r) * kLd + d);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        kv[c] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * c) * kLd + d);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[r][c] = fmaf(qv[r].x, kv[c].x, s[r][c]);
          s[r][c] = fmaf(qv[r].y, kv[c].y, s[r][c]);
          s[r][c] = fmaf(qv[r].z, kv[c].z, s[r][c]);
          s[r][c] = fmaf(qv[r].w, kv[c].w, s[r][c]);
        }
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qi = q0 + 4 * ty + r;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kj = k0 + tx + 16 * c;
        const bool live = kj < Skv && kj <= qi && (window <= 0 || qi - kj < window);
        s[r][c] = live ? s[r][c] * scale : kNegInf;
        mx = fmaxf(mx, s[r][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      const bool dead = m_new <= kNegInf * 0.5f;  // no live key yet
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = dead ? 0.f : expf(s[r][c] - m_new);
        Ps[(4 * ty + r) * kPld + tx + 16 * c] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      const float corr = expf(m[r] - m_new);
      l[r] = l[r] * corr + rs;
#pragma unroll
      for (int cc = 0; cc < kCols; ++cc) acc[r][cc] *= corr;
      m[r] = m_new;
    }
    __syncthreads();  // Ps is complete

#pragma unroll 2
    for (int j = 0; j < kBK; j += 4) {
      float4 pv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pv[r] = *reinterpret_cast<const float4*>(Ps + (4 * ty + r) * kPld + j);
#pragma unroll
      for (int cc = 0; cc < kCols; ++cc) {
        const float* vcol = Vs + j * kLd + tx + 16 * cc;
        const float v0 = vcol[0], v1 = vcol[kLd], v2 = vcol[2 * kLd],
                    v3 = vcol[3 * kLd];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          acc[r][cc] = fmaf(pv[r].x, v0, acc[r][cc]);
          acc[r][cc] = fmaf(pv[r].y, v1, acc[r][cc]);
          acc[r][cc] = fmaf(pv[r].z, v2, acc[r][cc]);
          acc[r][cc] = fmaf(pv[r].w, v3, acc[r][cc]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qi = q0 + 4 * ty + r;
    if (qi >= S) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    T* orow = o + (((long long)b * S + qi) * Hq + h) * D;
#pragma unroll
    for (int cc = 0; cc < kCols; ++cc) store(orow + tx + 16 * cc, acc[r][cc] / denom);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int Skv, int Hq, int Hkv, int window, float scale,
           cudaStream_t stream) {
  constexpr int smem =
      sizeof(float) * ((kBQ + 2 * kBK) * (D + 4) + kBQ * kPld);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBQ - 1) / kBQ, Hq, B);
  flash_attention_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, Skv, Hq, Hkv, window,
      scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One launch on ``stream``. dtype 0 is float32, 1 is bf16; window 0 means
// none. Returns the cudaError_t of the launch (0 on success), and
// cudaErrorInvalidValue for a head dim other than 64 and 128.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int S,
                                      int Skv, int Hq, int Hkv, int D,
                                      int window, int dtype, float scale,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool bf16 = dtype == 1;
  if (D == 64)
    return bf16 ? launch<__nv_bfloat16, 64>(q, k, v, o, B, S, Skv, Hq, Hkv, window, scale, st)
                : launch<float, 64>(q, k, v, o, B, S, Skv, Hq, Hkv, window, scale, st);
  if (D == 128)
    return bf16 ? launch<__nv_bfloat16, 128>(q, k, v, o, B, S, Skv, Hq, Hkv, window, scale, st)
                : launch<float, 128>(q, k, v, o, B, S, Skv, Hq, Hkv, window, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
