// Mamba2 SSD chunked scan, forward, for Hopper (sm_90a).
//
// Replaces the Pallas kernel _ssd_kernel of
// src/repro/kernels/ssd_scan/kernel.py:27 (wrapper ssd_scan_pallas, model
// entry ops.py::ssd_scan). The port runs it on the prefill of every layer
// of the ssm family, where it also returns the final state that the Pallas
// kernel keeps in VMEM scratch and drops.
//
// What it computes, per (batch, head), walking the chunks of Q = 128
// positions in order and carrying h_state (P, N) in float32 from zero:
//   dA_cum = cumsum(dt * A)                                   (Q,)
//   L[i, j] = exp(dA_cum[i] - dA_cum[j]) for i >= j, else exactly 0
//   y = ((C B^T) .* L) (x * dt) + (C h_state^T) * exp(dA_cum)   (Q, P)
//   h_state <- h_state * exp(dA_cum[Q-1])
//              + x^T (B * exp(dA_cum[Q-1] - dA_cum) * dt)
// with B and C of the head's group g = head / (H / G). All the math is
// float32 (inputs converted as they enter shared memory); y is written in
// the inputs' dtype and, when a pointer is passed, the final h_state
// (B, H, P, N) in float32. A ragged last chunk is read as zero past S
// (dt = 0 there: unit decay and no state update), which is what the
// reference's dt = 0 padding computes; rows past S are not stored.
//
// Layout: x (B, S, H, P) and B, C (B, S, G, N) with unit stride in their
// last two axes and any batch and sequence strides (the model passes views
// into the conv's output), dt (B, S, H) and A (H,) contiguous float32,
// y (B, S, H, P) contiguous. P = 64; N a multiple of 32 up to 256.
//
// What bounds it on this card. At mamba2-1.3b's prefill (B=8, S=1024,
// H=64, P=64, G=1, N=128) the function moves 157.3 MB (x, B, C, dt read
// once; y and the final state written once): 0.047 ms at 3.35 TB/s. Its
// live operations are 20.6 GFLOP (C B^T once per group and chunk on the
// lower triangle, the masked product with x * dt on the lower triangle,
// C h^T past the first chunk, the state update): 0.021 ms at the bf16
// tensor-core rate, 0.31 ms at the float32 rate (67 TFLOP/s) outside the
// tensor cores. So the bound is bytes in bf16 and operations in float32
// (chip_smoke.py::ssd_bound). This first kernel does float32 FMAs from
// shared memory and recomputes the full Q x Q square of C B^T for every
// head, about 43 GFLOP: it is far from the bound. Parity with the plain
// version at 1e-4 in float32 rules out TF32; mma/wgmma on bf16 operands,
// C B^T shared across the heads of a group and TMA loads are later work.
//
// Design: one pass. The chunk axis is sequential, the TPU's innermost
// "arbitrary" grid axis; here it is a loop inside the block, and one block
// of 256 threads owns one (batch, head) walk with h_state in shared memory.
// That is B * H = 512 blocks at the path's shape, one resident per SM
// (172 KB of shared memory at N = 128): 3.9 waves on 132 SMs. A two-pass
// design (chunk states in parallel, then a scan) would buy parallelism the
// path's shape does not need and cost a round trip of the chunk states
// through device memory. Per chunk:
//   1. warp 0 loads dt and scans dA = dt * A (4 positions per lane, then a
//      shuffle scan across lanes);
//   2. x * dt is staged (Q x P, float32);
//   3. N is walked in tiles of 32: the C and B tiles are staged, and each
//      thread accumulates an 8 x 8 block of C B^T (rows 8*ty.., columns
//      tx + 16c) and an 8 x 4 block of C h^T (the same rows, p = tx + 16c)
//      in registers from the same C loads; then, with every read of the
//      tile's h columns done, the tile's h columns take the state update
//      (a thread owns p = tid / 4 and 8 of the tile's n);
//   4. C B^T .* L goes to shared memory, exact zeros above the diagonal;
//   5. y = (C B^T .* L)(x * dt) over j <= i, plus C h^T * exp(dA_cum).
// Rows of the staged tiles are padded by 4 floats so that the 16-byte
// loads of neighbouring rows fall in different banks. No atomics: the
// result does not change between runs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kQ = 128;           // chunk length
constexpr int kP = 64;            // head dim
constexpr int kNT = 32;           // state columns per tile
constexpr int kThreads = 256;     // 16 row groups of 8 rows x 16 lanes
constexpr int kTld = kNT + 4;     // padded row of the B and C tiles
constexpr int kSld = kQ + 4;      // padded row of the masked score tile

__device__ __forceinline__ float4 load4(const float* src) {
  return *reinterpret_cast<const float4*>(src);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* src) {
  const uint2 raw = *reinterpret_cast<const uint2*>(src);
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
  return make_float4(__bfloat162float(h[0]), __bfloat162float(h[1]),
                     __bfloat162float(h[2]), __bfloat162float(h[3]));
}

__device__ __forceinline__ void store(float* dst, float x) { *dst = x; }

__device__ __forceinline__ void store(__nv_bfloat16* dst, float x) {
  *dst = __float2bfloat16(x);  // round to nearest even, as astype does
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// Rows t0 .. t0 + 127 (zero at or past S) of columns col0 .. col0 + 31 of a
// (S, *) matrix whose rows are row_stride elements apart, into a float32
// tile with rows kTld floats apart.
template <typename T>
__device__ void load_state_tile(const T* __restrict__ base,
                                long long row_stride, int t0, int rows,
                                int col0, float* tile) {
  for (int e = threadIdx.x; e < kQ * (kNT / 4); e += kThreads) {
    const int r = e / (kNT / 4);
    const int c = (e % (kNT / 4)) * 4;
    const float4 v = r < rows ? load4(base + (t0 + r) * row_stride + col0 + c)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(tile + r * kTld + c) = v;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const T* __restrict__ Bm,
                    const T* __restrict__ Cm, T* __restrict__ y,
                    float* __restrict__ state_out, int S, int H, int G,
                    int N, long long x_sb, long long x_ss, long long b_sb,
                    long long b_ss, long long c_sb, long long c_ss) {
  const int hld = N + 4;  // padded row of h_state
  extern __shared__ float4 smem4[];
  float* Ss = reinterpret_cast<float*>(smem4);  // kQ x kSld: (C B^T) .* L
  float* Xs = Ss + kQ * kSld;                   // kQ x kP: x * dt
  float* Bs = Xs + kQ * kP;                     // kQ x kTld
  float* Cs = Bs + kQ * kTld;                   // kQ x kTld
  float* Hs = Cs + kQ * kTld;                   // kP x hld: h_state
  float* cum = Hs + kP * hld;                   // kQ: dA_cum
  float* dts = cum + kQ;                        // kQ: dt
  float* wdec = dts + kQ;                       // kQ: exp(cum[Q-1] - cum)

  const int hh = blockIdx.x;
  const int b = blockIdx.y;
  const int grp = hh / (H / G);
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const float a = A[hh];

  const T* xb = x + b * x_sb + (long long)hh * kP;
  const float* dtb = dt + (long long)b * S * H + hh;
  const T* bb = Bm + b * b_sb + (long long)grp * N;
  const T* cb = Cm + b * c_sb + (long long)grp * N;
  T* yb = y + ((long long)b * S * H + hh) * kP;

  for (int i = tid; i < kP * hld; i += kThreads) Hs[i] = 0.f;

  const int n_chunks = (S + kQ - 1) / kQ;
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int t0 = ci * kQ;
    const int rows = min(kQ, S - t0);
    __syncthreads();  // the last chunk's reads of Ss, Xs, cum, dts are done

    // 1. dt and the cumulative sum of dA over the chunk (warp 0)
    if (tid < 32) {
      float v[4];
      float run = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int t = 4 * tid + k;
        const float d = t < rows ? dtb[(long long)(t0 + t) * H] : 0.f;
        dts[t] = d;
        run += d * a;
        v[k] = run;
      }
      float incl = run;  // inclusive scan of the lanes' totals
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += up;
      }
      const float excl = incl - run;
#pragma unroll
      for (int k = 0; k < 4; ++k) cum[4 * tid + k] = excl + v[k];
    }
    __syncthreads();

    // 2. x * dt, and the state update's weights
    for (int e = tid; e < kQ * (kP / 4); e += kThreads) {
      const int r = e / (kP / 4);
      const int c = (e % (kP / 4)) * 4;
      float4 v = r < rows ? load4(xb + (t0 + r) * x_ss + c)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
      const float d = dts[r];
      v.x *= d;
      v.y *= d;
      v.z *= d;
      v.w *= d;
      *reinterpret_cast<float4*>(Xs + r * kP + c) = v;
    }
    const float cum_last = cum[kQ - 1];
    if (tid < kQ) wdec[tid] = expf(cum_last - cum[tid]);
    const float chunk_decay = expf(cum_last);

    // 3. C B^T and C h^T over tiles of N; the state update per tile
    float sacc[8][8], yacc[8][4];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
#pragma unroll
      for (int c = 0; c < 8; ++c) sacc[r][c] = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) yacc[r][c] = 0.f;
    }
    for (int n0 = 0; n0 < N; n0 += kNT) {
      __syncthreads();  // the last tile's reads and h updates are done
      load_state_tile<T>(cb, c_ss, t0, rows, n0, Cs);
      load_state_tile<T>(bb, b_ss, t0, rows, n0, Bs);
      __syncthreads();
#pragma unroll 2
      for (int d = 0; d < kNT; d += 4) {
        float4 cv[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) cv[r] = load4(Cs + (8 * ty + r) * kTld + d);
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const float4 bv = load4(Bs + (tx + 16 * c) * kTld + d);
#pragma unroll
          for (int r = 0; r < 8; ++r) sacc[r][c] = dot4(cv[r], bv, sacc[r][c]);
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float4 hv = load4(Hs + (tx + 16 * c) * hld + n0 + d);
#pragma unroll
          for (int r = 0; r < 8; ++r) yacc[r][c] = dot4(cv[r], hv, yacc[r][c]);
        }
      }
      __syncthreads();  // every read of this tile's h columns is done
      {
        const int p = tid / 4;
        const int nn = (tid % 4) * 8;
        float upd[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) upd[k] = 0.f;
#pragma unroll 4
        for (int l = 0; l < kQ; ++l) {
          const float w = Xs[l * kP + p] * wdec[l];
          const float4 b0 = load4(Bs + l * kTld + nn);
          const float4 b1 = load4(Bs + l * kTld + nn + 4);
          upd[0] = fmaf(w, b0.x, upd[0]);
          upd[1] = fmaf(w, b0.y, upd[1]);
          upd[2] = fmaf(w, b0.z, upd[2]);
          upd[3] = fmaf(w, b0.w, upd[3]);
          upd[4] = fmaf(w, b1.x, upd[4]);
          upd[5] = fmaf(w, b1.y, upd[5]);
          upd[6] = fmaf(w, b1.z, upd[6]);
          upd[7] = fmaf(w, b1.w, upd[7]);
        }
        float* hrow = Hs + p * hld + n0 + nn;
#pragma unroll
        for (int k = 0; k < 8; ++k) hrow[k] = hrow[k] * chunk_decay + upd[k];
      }
    }

    // 4. C B^T .* L, exactly zero above the diagonal
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int i = 8 * ty + r;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int j = tx + 16 * c;
        Ss[i * kSld + j] = i >= j ? sacc[r][c] * expf(cum[i] - cum[j]) : 0.f;
      }
    }
    __syncthreads();

    // 5. y = (C B^T .* L)(x * dt) + C h^T * exp(dA_cum)
    const int j_end = 8 * ty + 8;  // the last live key of this thread's rows
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int i = 8 * ty + r;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int j = 0; j < j_end; j += 4) {
        const float4 sv = load4(Ss + i * kSld + j);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float* xcol = Xs + j * kP + tx + 16 * c;
          acc[c] = fmaf(sv.x, xcol[0], acc[c]);
          acc[c] = fmaf(sv.y, xcol[kP], acc[c]);
          acc[c] = fmaf(sv.z, xcol[2 * kP], acc[c]);
          acc[c] = fmaf(sv.w, xcol[3 * kP], acc[c]);
        }
      }
      if (i < rows) {
        const float decay = expf(cum[i]);
        T* yrow = yb + (long long)(t0 + i) * H * kP;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          store(yrow + tx + 16 * c, acc[c] + yacc[r][c] * decay);
      }
    }
  }

  if (state_out != nullptr) {
    __syncthreads();  // the last tile's h updates are done
    float* sb = state_out + ((long long)b * H + hh) * kP * N;
    for (int i = tid; i < kP * N; i += kThreads)
      sb[i] = Hs[(i / N) * hld + i % N];
  }
}

template <typename T>
int launch(const void* x, const float* dt, const float* A, const void* B,
           const void* C, void* y, float* state, int batch, int S, int H,
           int G, int N, long long x_sb, long long x_ss, long long b_sb,
           long long b_ss, long long c_sb, long long c_ss,
           cudaStream_t stream) {
  const int smem = static_cast<int>(
      sizeof(float) * (kQ * kSld + kQ * kP + 2 * kQ * kTld + kP * (N + 4) +
                       3 * kQ));
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(H, batch);
  ssd_scan_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(B),
      static_cast<const T*>(C), static_cast<T*>(y), state, S, H, G, N, x_sb,
      x_ss, b_sb, b_ss, c_sb, c_ss);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One launch on ``stream``. dtype 0 is float32, 1 is bf16 (x, B, C and y);
// ``state`` may be null (the final state is then not written). Strides are
// in elements. Returns the cudaError_t of the launch (0 on success), and
// cudaErrorInvalidValue for a state dim that is not a multiple of 32 up to
// 256 or groups that do not divide the heads.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A,
                               const void* B, const void* C, void* y,
                               void* state, int batch, int S, int H, int G,
                               int N, long long x_sb, long long x_ss,
                               long long b_sb, long long b_ss, long long c_sb,
                               long long c_ss, int dtype, void* stream) {
  if (N % kNT != 0 || N > 256 || N < kNT || G < 1 || H % G != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  float* sf = static_cast<float*>(state);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dtf, Af, B, C, y, sf, batch, S, H, G, N,
                                 x_sb, x_ss, b_sb, b_ss, c_sb, c_ss, st);
  return launch<float>(x, dtf, Af, B, C, y, sf, batch, S, H, G, N, x_sb, x_ss,
                       b_sb, b_ss, c_sb, c_ss, st);
}
