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
// with B and C of the head's group g = head / (H / G). y is written in the
// inputs' dtype and, when a pointer is passed, the final h_state
// (B, H, P, N) in float32. A ragged last chunk is read as zero past S
// (dt = 0 there: unit decay and no state update), which is what the
// reference's dt = 0 padding computes; rows past S are not stored.
//
// Layout: x (B, S, H, P) and B, C (B, S, G, N) with unit stride in their
// last two axes and any batch and sequence strides that are multiples of 4
// elements (the model passes views into the conv's output), dt (B, S, H)
// and A (H,) contiguous float32, y (B, S, H, P) contiguous. P = 64; N a
// multiple of 32 up to 256.
//
// What bounds it on this card. At mamba2-1.3b's prefill (B=8, S=1024,
// H=64, P=64, G=1, N=128) the function moves 157.3 MB (x, B, C, dt read
// once; y and the final state written once): 0.047 ms at 3.35 TB/s. Its
// live operations are 20.6 GFLOP (C B^T once per group and chunk on the
// lower triangle, the masked product with x * dt on the lower triangle,
// C h^T past the first chunk, the state update): 0.021 ms at the bf16
// tensor-core rate, 0.31 ms at the float32 rate (67 TFLOP/s) outside the
// tensor cores. So the bound is bytes in bf16 and operations in float32
// (chip_smoke.py::ssd_bound).
//
// Both routes are one pass: the chunk axis is sequential (the TPU's
// innermost "arbitrary" grid axis), here a loop inside the block, and one
// block of 256 threads owns one (batch, head) walk. A two-pass design (chunk
// states in parallel, then a scan) would write and read the (B, chunks, H,
// P, N) float32 chunk states, 134 MB at the path's shape, more than the
// bound's bytes. dtype picks the route in ssd_scan_launch.
//
// bf16 (the serving path): ssd_scan_bf16_kernel, on the tensor cores. The
// chunk's x (128 x 64), B and C (128 x N) tiles and its dt come into shared
// memory in bf16 by cp.async, read in place from strided views (16-byte
// copies, 8-byte where a stride is only 8-byte aligned): C's copy for the
// next chunk is in flight during this chunk's state update, x's, B's and
// dt's during the h write-back and, with 2 blocks resident per SM at
// N <= 128 (112 KB of shared memory and at most 128 registers a thread),
// during the other block's products. Rows are padded by 16 bytes so
// ldmatrix is free of bank conflicts. Warp 0 scans dA = dt * A in float32.
// Warp w owns the rows r0 = 16w .. 16w+15 of y:
//   - C h^T: A fragments of C by ldmatrix, h^T from a bf16 copy of h in
//     shared memory; scaled by exp(dA_cum) in registers;
//   - C B^T on the lower triangle only (16-key tiles above the warp's rows
//     are skipped), in blocks of 32 keys held in registers; the masked
//     C B^T .* L * dt is rounded to bf16 in registers, where it is the A
//     fragment of the product with x (read by ldmatrix.trans). Folding dt
//     into the score leaves one rounding where (C B^T .* L) and x * dt
//     would take two. Below the diagonal tile, L is factored around r0,
//     exp(cum[i] - cum[r0]) * exp(cum[r0] - cum[j]), both factors at most 1
//     (no overflow), the key factors times dt shared in shared memory; the
//     diagonal tile takes exp(cum[i] - cum[j]) itself and an exact 0 above
//     the diagonal.
// The state h (64 x N) lives in registers as float32 accumulators: warp w
// owns p rows 16 (w % 4) .. +15 and half of n; h <- h * exp(dA_cum[Q-1]) +
// (x * w)^T B with w = exp(dA_cum[Q-1] - dA_cum) * dt, the A fragments of
// x^T by ldmatrix.trans scaled by w and rounded to bf16 in registers (the
// decay is folded into x, 64 wide, rather than into B, N wide: the same one
// rounding of a product), B^T by ldmatrix.trans. After the update each warp
// writes its part of h as bf16 for the next chunk's C h^T. Every product is
// mma.sync.m16n8k16 bf16 -> f32. The roundings to bf16 are those three
// derived operands (C B^T .* L * dt, x * w, h's copy); C, B and x are bf16
// already, so their products are exact in float32, and h stays float32.
// Warps are unevenly loaded (warp 7's rows see 8 key tiles, warp 0's one);
// the other resident block fills the gaps.
//
// float32 (the first design, kept for the 1e-4 parity that rules out TF32):
// ssd_scan_f32_kernel, scalar float32 FMAs from shared memory with
// synchronous loads, h_state in shared memory, one block per SM (172 KB at
// N = 128). It recomputes the full Q x Q square of C B^T for every head,
// about 43 GFLOP at the path's shape. Per chunk: warp 0 scans dA; x * dt is
// staged; N is walked in tiles of 32, the C and B tiles staged, each thread
// accumulating an 8 x 8 block of C B^T and an 8 x 4 block of C h^T from the
// same C loads, then the tile's h columns take the state update; C B^T .* L
// goes to shared memory, and y = (C B^T .* L)(x * dt) + C h^T * exp(dA_cum).
// Rows of its staged tiles are padded by 4 floats.
//
// No atomics in either route: the result does not change between runs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQ = 128;           // chunk length
constexpr int kP = 64;            // head dim
constexpr int kThreads = 256;     // 8 warps

// ---------------------------------------------------------------------------
// float32 route (the first design)
// ---------------------------------------------------------------------------

constexpr int kNT = 32;           // state columns per tile
constexpr int kTld = kNT + 4;     // padded row of the B and C tiles
constexpr int kSld = kQ + 4;      // padded row of the masked score tile

__device__ __forceinline__ float4 load4(const float* src) {
  return *reinterpret_cast<const float4*>(src);
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
__device__ void load_state_tile(const float* __restrict__ base,
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

__global__ void __launch_bounds__(kThreads, 1)
    ssd_scan_f32_kernel(const float* __restrict__ x,
                        const float* __restrict__ dt,
                        const float* __restrict__ A,
                        const float* __restrict__ Bm,
                        const float* __restrict__ Cm, float* __restrict__ y,
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

  const float* xb = x + b * x_sb + (long long)hh * kP;
  const float* dtb = dt + (long long)b * S * H + hh;
  const float* bb = Bm + b * b_sb + (long long)grp * N;
  const float* cb = Cm + b * c_sb + (long long)grp * N;
  float* yb = y + ((long long)b * S * H + hh) * kP;

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
      load_state_tile(cb, c_ss, t0, rows, n0, Cs);
      load_state_tile(bb, b_ss, t0, rows, n0, Bs);
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
        float* yrow = yb + (long long)(t0 + i) * H * kP;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          yrow[tx + 16 * c] = acc[c] + yacc[r][c] * decay;
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

// ---------------------------------------------------------------------------
// bf16 route: tensor cores (mma.sync) and cp.async
// ---------------------------------------------------------------------------

constexpr int kXld = kP + 8;  // padded row of the x tile, in elements

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16, 8 or 4 bytes from global to shared memory, asynchronously; zeros
// where !valid (src is then not read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 8 : 0));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a b: a 16 x 16 bf16 (4 regs), b 16 x 8 bf16 (2 regs), c 16 x 8 f32
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to nearest even into one bf16 pair (lo in the low half)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// a bf16 pair times two floats, rounded back to a bf16 pair
__device__ __forceinline__ uint32_t scale_bf16(uint32_t u, float2 w) {
  const float2 f =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
  return pack_bf16(f.x * w.x, f.y * w.y);
}

// kNMax: the largest N the instance takes (64, 128 or 256); it sizes the
// registers that hold this warp's part of h.
template <int kNMax>
__global__ void __launch_bounds__(kThreads, kNMax <= 128 ? 2 : 1)
    ssd_scan_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                         const float* __restrict__ dt,
                         const float* __restrict__ A,
                         const __nv_bfloat16* __restrict__ Bm,
                         const __nv_bfloat16* __restrict__ Cm,
                         __nv_bfloat16* __restrict__ y,
                         float* __restrict__ state_out, int S, int H, int G,
                         int N, long long x_sb, long long x_ss,
                         long long b_sb, long long b_ss, long long c_sb,
                         long long c_ss, int vec16) {
  constexpr int kHTiles = kNMax / 16;  // n-tiles of 8 in a warp's half of h
  const int ld = N + 8;                // padded row of the B, C, h tiles
  extern __shared__ uint4 smem_bf16[];
  __nv_bfloat16* Cs = reinterpret_cast<__nv_bfloat16*>(smem_bf16);  // kQ x ld
  __nv_bfloat16* Bs = Cs + kQ * ld;                                  // kQ x ld
  __nv_bfloat16* Xs = Bs + kQ * ld;                                  // kQ x kXld
  __nv_bfloat16* Hb = Xs + kQ * kXld;  // kP x ld: h entering the chunk
  float* dts = reinterpret_cast<float*>(Hb + kP * ld);  // kQ: dt
  float* cum = dts + kQ;                                // kQ: dA_cum
  float* wst = cum + kQ;   // kQ: exp(cum[Q-1] - cum) * dt
  float* ecum = wst + kQ;  // kQ: exp(cum)
  float* kdec = ecum + kQ;  // 8 x kQ: row w exp(cum[16 w] - cum[j]) * dt[j]

  const int hh = blockIdx.x;
  const int b = blockIdx.y;
  const int grp = hh / (H / G);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;   // the fragment's row within 8
  const int tq = lane % 4;  // the fragment's column pair
  const float a = A[hh];

  const __nv_bfloat16* xb = x + b * x_sb + (long long)hh * kP;
  const float* dtb = dt + (long long)b * S * H + hh;
  const __nv_bfloat16* bb = Bm + b * b_sb + (long long)grp * N;
  const __nv_bfloat16* cb = Cm + b * c_sb + (long long)grp * N;
  __nv_bfloat16* yb = y + ((long long)b * S * H + hh) * kP;

  // rows t0 .. t0 + 127 of a (S, cols) view into a tile with rows tld
  // elements apart, zeros at or past ``rows``: 16-byte copies, or 8-byte
  // ones where a stride or a base is only 8-byte aligned
  auto load_rows = [&](__nv_bfloat16* tile, int tld,
                       const __nv_bfloat16* base, long long row_stride,
                       int cols, int t0, int rows) {
    const int vec = vec16 ? 8 : 4;
    const int per_row = cols / vec;
    for (int c = tid; c < kQ * per_row; c += kThreads) {
      const int r = c / per_row;
      const int e = (c % per_row) * vec;
      const bool ok = r < rows;
      const __nv_bfloat16* src = ok ? base + (t0 + r) * row_stride + e : base;
      if (vec16)
        cp_async16(smem_addr(tile + r * tld + e), src, ok);
      else
        cp_async8(smem_addr(tile + r * tld + e), src, ok);
    }
  };
  auto load_dt = [&](int t0, int rows) {
    if (tid < kQ)
      cp_async4(smem_addr(dts + tid),
                tid < rows ? dtb + (long long)(t0 + tid) * H : dtb, tid < rows);
  };

  const int n_chunks = (S + kQ - 1) / kQ;
  load_rows(Cs, ld, cb, c_ss, N, 0, min(kQ, S));
  load_rows(Bs, ld, bb, b_ss, N, 0, min(kQ, S));
  load_rows(Xs, kXld, xb, x_ss, kP, 0, min(kQ, S));
  load_dt(0, min(kQ, S));
  cp_async_commit();

  // this warp's part of h: p rows 16 pm .. +15, n from nbase, N/16 n-tiles
  const int pm = warp % 4;
  const int nbase = (warp / 4) * (N / 2);
  float hacc[kHTiles][4];
#pragma unroll
  for (int j = 0; j < kHTiles; ++j)
    hacc[j][0] = hacc[j][1] = hacc[j][2] = hacc[j][3] = 0.f;

  const int r0 = 16 * warp;  // this warp's rows of y in the chunk
  const int i0 = r0 + g;     // this thread's rows: i0 and i0 + 8
  const int i1 = i0 + 8;

  for (int ci = 0; ci < n_chunks; ++ci) {
    const int t0 = ci * kQ;
    const int rows = min(kQ, S - t0);
    cp_async_wait_all();
    __syncthreads();  // this chunk's tiles and h's bf16 copy are in place

    // 1. the cumulative sum of dA over the chunk (warp 0)
    if (warp == 0) {
      float v[4], d[4];
      float run = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        d[k] = dts[4 * lane + k];
        run += d[k] * a;
        v[k] = run;
      }
      float incl = run;  // inclusive scan of the lanes' totals
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += up;
      }
      const float excl = incl - run;
      const float last = __shfl_sync(0xffffffffu, excl + v[3], 31);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float c = excl + v[k];
        cum[4 * lane + k] = c;
        wst[4 * lane + k] = expf(last - c) * d[k];
        ecum[4 * lane + k] = expf(c);
      }
    }
    __syncthreads();
    // the decay below the diagonal of this warp's rows, factored around its
    // first row r0: exp(cum[i] - cum[j]) = exp(cum[i] - cum[r0]) *
    // exp(cum[r0] - cum[j]) for j < r0 <= i, both factors at most 1; the key
    // factors (times dt) in this warp's row of kdec, which no other warp reads
    float* kd = kdec + warp * kQ;
    for (int j = lane; j < r0; j += 32) kd[j] = __expf(cum[r0] - cum[j]) * dts[j];
    __syncwarp();

    // 2. y for this warp's rows: C h^T * exp(dA_cum), then the masked
    //    C B^T .* L * dt times x, key blocks of 32 on the lower triangle
    float yacc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
      yacc[n][0] = yacc[n][1] = yacc[n][2] = yacc[n][3] = 0.f;
    const int ksteps = N / 16;
    const float c0 = cum[i0], c1 = cum[i1];
    const float rf0 = __expf(c0 - cum[r0]), rf1 = __expf(c1 - cum[r0]);
    for (int kb = 0; kb < 4; ++kb) {  // keys 32 kb .. 32 kb + 31
      if (2 * kb > warp) break;       // above the diagonal for every row
      const bool with_off = kb == 0 && ci > 0;  // h is zero in chunk 0
      float sacc[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
        sacc[n][0] = sacc[n][1] = sacc[n][2] = sacc[n][3] = 0.f;
#pragma unroll 1  // unrolled, it spills at 128 registers
      for (int ks = 0; ks < ksteps; ++ks) {
        uint32_t cf[4];
        ldsm_x4(smem_addr(Cs + (r0 + lane % 16) * ld + ks * 16 +
                          (lane / 16) * 8),
                cf);
        if (with_off) {
#pragma unroll
          for (int pp = 0; pp < 4; ++pp) {
            uint32_t bf[4];
            ldsm_x4(smem_addr(Hb + (16 * pp + lane % 8 + (lane / 16) * 8) * ld +
                              ks * 16 + ((lane / 8) % 2) * 8),
                    bf);
            mma_bf16(yacc[2 * pp], cf, bf[0], bf[1]);
            mma_bf16(yacc[2 * pp + 1], cf, bf[2], bf[3]);
          }
        }
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {  // keys 32 kb + 16 jp .. + 15
          if (2 * kb + jp > warp) continue;
          uint32_t bf[4];
          ldsm_x4(smem_addr(Bs + (32 * kb + 16 * jp + lane % 8 +
                                  (lane / 16) * 8) * ld +
                            ks * 16 + ((lane / 8) % 2) * 8),
                  bf);
          mma_bf16(sacc[2 * jp], cf, bf[0], bf[1]);
          mma_bf16(sacc[2 * jp + 1], cf, bf[2], bf[3]);
        }
      }
      if (with_off) {
        const float e0 = ecum[i0], e1 = ecum[i1];
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          yacc[n][0] *= e0;
          yacc[n][1] *= e0;
          yacc[n][2] *= e1;
          yacc[n][3] *= e1;
        }
      }
      // (C B^T .* L * dt) of this key block, rounded to bf16, times x
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {  // keys 32 kb + 16 kk .. + 15
        const int kt = 2 * kb + kk;     // the key tile of 16
        if (kt > warp) continue;
        uint32_t pf[4];
        if (kt < warp) {  // wholly below the diagonal
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int j = 2 * kk + half;
            const int key = 32 * kb + 8 * j + 2 * tq;
            const float2 f = *reinterpret_cast<const float2*>(kd + key);
            pf[2 * half] = pack_bf16(sacc[j][0] * rf0 * f.x,
                                     sacc[j][1] * rf0 * f.y);
            pf[2 * half + 1] = pack_bf16(sacc[j][2] * rf1 * f.x,
                                         sacc[j][3] * rf1 * f.y);
          }
        } else {  // the diagonal tile: exact 0 above it
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int j = 2 * kk + half;
            const int key = 32 * kb + 8 * j + 2 * tq;
            const float2 cj = *reinterpret_cast<const float2*>(cum + key);
            const float2 dj = *reinterpret_cast<const float2*>(dts + key);
            const float v0 =
                i0 >= key ? sacc[j][0] * __expf(c0 - cj.x) * dj.x : 0.f;
            const float v1 =
                i0 >= key + 1 ? sacc[j][1] * __expf(c0 - cj.y) * dj.y : 0.f;
            const float v2 =
                i1 >= key ? sacc[j][2] * __expf(c1 - cj.x) * dj.x : 0.f;
            const float v3 =
                i1 >= key + 1 ? sacc[j][3] * __expf(c1 - cj.y) * dj.y : 0.f;
            pf[2 * half] = pack_bf16(v0, v1);
            pf[2 * half + 1] = pack_bf16(v2, v3);
          }
        }
#pragma unroll
        for (int pp = 0; pp < 4; ++pp) {
          uint32_t bf[4];
          ldsm_x4_trans(
              smem_addr(Xs + (16 * kt + lane % 8 + ((lane / 8) % 2) * 8) * kXld +
                        16 * pp + (lane / 16) * 8),
              bf);
          mma_bf16(yacc[2 * pp], pf, bf[0], bf[1]);
          mma_bf16(yacc[2 * pp + 1], pf, bf[2], bf[3]);
        }
      }
    }
    __syncthreads();  // every read of Cs and Hb is done
    if (ci + 1 < n_chunks)  // the next C in flight during the state update
      load_rows(Cs, ld, cb, c_ss, N, t0 + kQ, min(kQ, S - t0 - kQ));
    cp_async_commit();

    // 3. h <- h * exp(dA_cum[Q-1]) + (x * w)^T B on this warp's part of h
    const float chunk_decay = expf(cum[kQ - 1]);
#pragma unroll
    for (int j = 0; j < kHTiles; ++j) {
      hacc[j][0] *= chunk_decay;
      hacc[j][1] *= chunk_decay;
      hacc[j][2] *= chunk_decay;
      hacc[j][3] *= chunk_decay;
    }
    const int npairs = N / 32;
#pragma unroll 2
    for (int ks = 0; ks < kQ / 16; ++ks) {  // positions 16 ks .. + 15
      uint32_t af[4];
      ldsm_x4_trans(smem_addr(Xs + (16 * ks + lane % 8 + (lane / 16) * 8) * kXld +
                              16 * pm + ((lane / 8) % 2) * 8),
                    af);
      const float2 wa = *reinterpret_cast<const float2*>(wst + 16 * ks + 2 * tq);
      const float2 wb =
          *reinterpret_cast<const float2*>(wst + 16 * ks + 8 + 2 * tq);
      af[0] = scale_bf16(af[0], wa);
      af[1] = scale_bf16(af[1], wa);
      af[2] = scale_bf16(af[2], wb);
      af[3] = scale_bf16(af[3], wb);
#pragma unroll
      for (int np = 0; np < kHTiles / 2; ++np) {
        if (np >= npairs) break;
        uint32_t bf[4];
        ldsm_x4_trans(smem_addr(Bs + (16 * ks + lane % 8 + ((lane / 8) % 2) * 8) *
                                         ld +
                                nbase + 16 * np + (lane / 16) * 8),
                      bf);
        mma_bf16(hacc[2 * np], af, bf[0], bf[1]);
        mma_bf16(hacc[2 * np + 1], af, bf[2], bf[3]);
      }
    }

    // 4. y of this warp's rows
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int p = 8 * n + 2 * tq;
      if (i0 < rows)
        *reinterpret_cast<uint32_t*>(yb + (long long)(t0 + i0) * H * kP + p) =
            pack_bf16(yacc[n][0], yacc[n][1]);
      if (i1 < rows)
        *reinterpret_cast<uint32_t*>(yb + (long long)(t0 + i1) * H * kP + p) =
            pack_bf16(yacc[n][2], yacc[n][3]);
    }
    __syncthreads();  // every read of Xs, Bs, dts and wst is done

    // 5. h entering the next chunk, in bf16 for its C h^T; the next x, B, dt
    if (ci + 1 < n_chunks) {
#pragma unroll
      for (int j = 0; j < kHTiles; ++j) {
        if (j >= N / 16) break;
        const int n = nbase + 8 * j + 2 * tq;
        const int p = 16 * pm + g;
        *reinterpret_cast<uint32_t*>(Hb + p * ld + n) =
            pack_bf16(hacc[j][0], hacc[j][1]);
        *reinterpret_cast<uint32_t*>(Hb + (p + 8) * ld + n) =
            pack_bf16(hacc[j][2], hacc[j][3]);
      }
      const int next_rows = min(kQ, S - t0 - kQ);
      load_rows(Bs, ld, bb, b_ss, N, t0 + kQ, next_rows);
      load_rows(Xs, kXld, xb, x_ss, kP, t0 + kQ, next_rows);
      load_dt(t0 + kQ, next_rows);
    }
    cp_async_commit();
  }

  if (state_out != nullptr) {
    float* sb = state_out + ((long long)b * H + hh) * kP * N;
#pragma unroll
    for (int j = 0; j < kHTiles; ++j) {
      if (j >= N / 16) break;
      const int n = nbase + 8 * j + 2 * tq;
      const int p = 16 * pm + g;
      *reinterpret_cast<float2*>(sb + (long long)p * N + n) =
          make_float2(hacc[j][0], hacc[j][1]);
      *reinterpret_cast<float2*>(sb + (long long)(p + 8) * N + n) =
          make_float2(hacc[j][2], hacc[j][3]);
    }
  }
}

int launch_f32(const void* x, const float* dt, const float* A, const void* B,
               const void* C, void* y, float* state, int batch, int S, int H,
               int G, int N, long long x_sb, long long x_ss, long long b_sb,
               long long b_ss, long long c_sb, long long c_ss,
               cudaStream_t stream) {
  const int smem = static_cast<int>(
      sizeof(float) * (kQ * kSld + kQ * kP + 2 * kQ * kTld + kP * (N + 4) +
                       3 * kQ));
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(H, batch);
  ssd_scan_f32_kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(x), dt, A, static_cast<const float*>(B),
      static_cast<const float*>(C), static_cast<float*>(y), state, S, H, G, N,
      x_sb, x_ss, b_sb, b_ss, c_sb, c_ss);
  return static_cast<int>(cudaGetLastError());
}

template <int kNMax>
int launch_bf16(const void* x, const float* dt, const float* A, const void* B,
                const void* C, void* y, float* state, int batch, int S, int H,
                int G, int N, long long x_sb, long long x_ss, long long b_sb,
                long long b_ss, long long c_sb, long long c_ss,
                cudaStream_t stream) {
  // C and B (kQ x ld), x (kQ x kXld), h's copy (kP x ld), 12 x kQ floats
  const int ld = N + 8;
  const int smem = static_cast<int>(
      sizeof(__nv_bfloat16) * ((2 * kQ + kP) * ld + kQ * kXld) +
      sizeof(float) * 12 * kQ);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_bf16_kernel<kNMax>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // 16-byte copies where every row start is on a 16-byte boundary
  const bool vec16 =
      reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(B) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(C) % 16 == 0 && x_sb % 8 == 0 &&
      x_ss % 8 == 0 && b_sb % 8 == 0 && b_ss % 8 == 0 && c_sb % 8 == 0 &&
      c_ss % 8 == 0;
  const dim3 grid(H, batch);
  ssd_scan_bf16_kernel<kNMax><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), dt, A,
      static_cast<const __nv_bfloat16*>(B),
      static_cast<const __nv_bfloat16*>(C), static_cast<__nv_bfloat16*>(y),
      state, S, H, G, N, x_sb, x_ss, b_sb, b_ss, c_sb, c_ss, vec16 ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One launch on ``stream``. dtype 0 is float32 (the scalar route), 1 is bf16
// (x, B, C and y; the tensor-core route); ``state`` may be null (the final
// state is then not written). Strides are in elements. Returns the
// cudaError_t of the launch (0 on success), and cudaErrorInvalidValue for a
// state dim that is not a multiple of 32 up to 256, groups that do not
// divide the heads, or another dtype.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A,
                               const void* B, const void* C, void* y,
                               void* state, int batch, int S, int H, int G,
                               int N, long long x_sb, long long x_ss,
                               long long b_sb, long long b_ss, long long c_sb,
                               long long c_ss, int dtype, void* stream) {
  if (N % 32 != 0 || N > 256 || N < 32 || G < 1 || H % G != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  float* sf = static_cast<float*>(state);
  if (dtype == 0)
    return launch_f32(x, dtf, Af, B, C, y, sf, batch, S, H, G, N, x_sb, x_ss,
                      b_sb, b_ss, c_sb, c_ss, st);
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (N <= 64)
    return launch_bf16<64>(x, dtf, Af, B, C, y, sf, batch, S, H, G, N, x_sb,
                           x_ss, b_sb, b_ss, c_sb, c_ss, st);
  if (N <= 128)
    return launch_bf16<128>(x, dtf, Af, B, C, y, sf, batch, S, H, G, N, x_sb,
                            x_ss, b_sb, b_ss, c_sb, c_ss, st);
  return launch_bf16<256>(x, dtf, Af, B, C, y, sf, batch, S, H, G, N, x_sb,
                          x_ss, b_sb, b_ss, c_sb, c_ss, st);
}
