// Causal (and sliding-window) flash attention, forward, for Hopper (sm_90a).
//
// Replaces the Pallas kernel _fa_kernel of
// src/repro/kernels/flash_attention/kernel.py:31 (wrapper
// flash_attention_bhsd, model-layout entry ops.py::flash_attention), which
// the reference's attention reaches for backend="pallas" on the prefill of
// every layer.
//
// What it computes, per (batch, q head), over positions counted from 0:
//   s[i, j] = (q[i] . k[j]) * scale          scale = 1/sqrt(D), after the dot
//   live(i, j) = j <= i  and  (no window or i - j < window)  and  j < Skv
//   s = live ? s : -1e30                      (-1e30, not -inf)
//   out[i] = sum_j p[i, j] v[j] / max(l[i], 1e-30),  p = exp(s - running max)
// with the reference's online softmax: a running max m, normalizer l and
// accumulator per row, all float32, updated once per kv tile of 64 keys; a
// row whose running max is still -1e30 keeps p = 0. The kv head of q head h
// is h / (Hq / Hkv) (GQA). The output is written in the inputs' dtype.
// Ragged S is handled by bounds masks (rows past S are not stored, keys past
// Skv are masked), where the reference pads to its block size; for the
// self-attention it serves (Skv == S) the padded keys sit after every query
// and are causally masked, so the results are the same.
//
// Layout, in and out: q (B, S, Hq, D), k/v (B, Skv, Hkv, D), o (B, S, Hq, D),
// contiguous, on 16-byte boundaries. D is a template parameter: 64 and 128.
//
// What bounds it on this card: the operations. Causal prefill at smollm-135m
// (B=8, Hq=9, S=1024, D=64) is 4 * B * Hq * D * (S (S + 1) / 2) = 9.7 GFLOP
// against 25 MB of q, k, v and o (chip_smoke.py::fa_bound): 9.8 us at the
// dense bf16 tensor-core rate (989 TFLOP/s), 7.5 us of bytes at 3.35 TB/s.
//
// Two routes, picked by the inputs' dtype in flash_attention_launch:
//
// bf16 (the serving path): flash_attention_bf16_kernel, on the tensor cores.
// One block of 4 warps per (64-row q tile, q head, batch), 4 blocks per SM
// at D = 64; q tiles ride the grid's slowest axis, those with the most kv
// tiles first. Each warp owns 16 q rows, whose Q fragments are read once
// from shared memory with ldmatrix and kept in registers. The kernel walks
// only the kv tiles of 64 keys that hold a live key for some row of the q
// tile (causal: up to the diagonal tile; window: from the tile holding
// q0 - window + 1), and a warp skips the tiles and the 16-key slices that
// hold no live key for its own rows. K and V tiles are bf16 in shared
// memory, double-buffered with cp.async (16 bytes a thread): the next
// tile's copy is in flight while this one computes. Rows are padded by 16
// bytes, so the 8 row addresses of an ldmatrix fall in 8 distinct groups of
// 4 banks. S = Q K^T runs on mma.sync.m16n8k16 bf16 -> f32 (16 x 64 scores
// a warp, all in registers); the -1e30 masks apply only on tiles that cross
// the diagonal, a window's edge or Skv, and the scale is folded into the
// exponent (2^((s - m) scale log2 e) by ex2.approx; scale > 0 commutes with
// the max and the masks). The online softmax runs in registers (row max by
// quad shuffles). P is rounded to bf16 in registers, where it is the A
// fragment of O += P V (mma.sync, V read through ldmatrix.trans) and of
// l += P 1 (one more mma against a fragment of ones), so l sums exactly the
// rounded weights the output sees: that rounding (2^-9 relative a weight)
// is the route's one rounding beyond the output's. The output tile is
// staged through the warp's own rows of the Q tile for 16-byte stores.
//
// float32 (the first design, kept for the 1e-5 parity that rules out TF32):
// flash_attention_f32_kernel, scalar float32 FMAs outside the tensor cores
// (67 TFLOP/s), so its own floor is about 145 us at smollm's shape.
// One block of 256 threads per (64-row q tile, q head, batch), tiles staged
// as float32 with synchronous loads; a thread owns a 4 x 4 block of the
// score tile and a 4 x (D/16) block of the accumulator, the 16 threads of a
// row group are one half-warp (row max and row sum are xor-shuffles), and
// the probabilities go through shared memory for the product with V.
//
// No atomics in either route: the result does not change between runs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per kv tile
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kBQ == kBK, "the tiles of q and kv have one height");

// ---------------------------------------------------------------------------
// float32 route (the first design)
// ---------------------------------------------------------------------------

constexpr int kF32Threads = 256;  // 16 row groups of 4 rows x 16 lanes
constexpr int kPld = kBK + 4;     // padded row of the probability tile

// Rows row0 .. row0 + 63 of a (rows, D) matrix whose rows are row_stride
// elements apart, into a float32 tile with rows D + 4 floats apart; rows at
// or past n_rows are zero.
template <int D>
__device__ void load_tile_f32(const float* __restrict__ base,
                              long long row_stride, int row0, int n_rows,
                              float* tile) {
  constexpr int kChunksPerRow = D / 4;
  for (int c = threadIdx.x; c < kBK * kChunksPerRow; c += kF32Threads) {
    const int r = c / kChunksPerRow;
    const int e = (c % kChunksPerRow) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n_rows)
      v = *reinterpret_cast<const float4*>(base + (row0 + r) * row_stride + e);
    *reinterpret_cast<float4*>(tile + r * (D + 4) + e) = v;
  }
}

template <int D>
__global__ void __launch_bounds__(kF32Threads)
    flash_attention_f32_kernel(const float* __restrict__ q,
                               const float* __restrict__ k,
                               const float* __restrict__ v,
                               float* __restrict__ o, int S, int Skv, int Hq,
                               int Hkv, int window, float scale) {
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
  const float* kb = k + ((long long)b * Skv * Hkv + hk) * D;
  const float* vb = v + ((long long)b * Skv * Hkv + hk) * D;

  load_tile_f32<D>(q + ((long long)b * S * Hq + h) * D, q_stride, q0, S, Qs);

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
    load_tile_f32<D>(kb, kv_stride, k0, Skv, Ks);
    load_tile_f32<D>(vb, kv_stride, k0, Skv, Vs);
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
    float* orow = o + (((long long)b * S + qi) * Hq + h) * D;
#pragma unroll
    for (int cc = 0; cc < kCols; ++cc) orow[tx + 16 * cc] = acc[r][cc] / denom;
  }
}

// ---------------------------------------------------------------------------
// bf16 route: tensor cores (mma.sync) and cp.async
// ---------------------------------------------------------------------------

constexpr int kBf16Threads = 32 * (kBQ / 16);  // a warp per 16 q rows

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously; zeros where !valid
// (src is then not read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
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

// 2^x by the special-function unit, flushing denormals (any weight below
// 2^-126 is rounded away in bf16 anyway); 2^-inf = +0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

constexpr uint32_t kOnesBf16x2 = 0x3F803F80u;  // (1.0, 1.0) in bf16

// 4 blocks per SM at D = 64: the 128-register cap spills 48 bytes a thread
// and was still faster than 3 blocks without spills in a trial build; at
// D = 128 the cap spills far more, so there the floor is one block
template <int D>
__global__ void __launch_bounds__(kBf16Threads, D == 64 ? 4 : 1)
    flash_attention_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                                const __nv_bfloat16* __restrict__ k,
                                const __nv_bfloat16* __restrict__ v,
                                __nv_bfloat16* __restrict__ o, int S, int Skv,
                                int Hq, int Hkv, int window, float scale) {
  constexpr int kLd = D + 8;          // padded smem row, in elements
  constexpr int kKsteps = D / 16;     // k-steps of Q K^T
  constexpr int kDtiles = D / 8;      // n-tiles of the output
  constexpr int kChunks = D / 8;      // 16-byte pieces of a row
  extern __shared__ uint4 smem_bf16[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_bf16);
  __nv_bfloat16* Ks = Qs + kBQ * kLd;    // two buffers
  __nv_bfloat16* Vs = Ks + 2 * kBK * kLd;  // two buffers

  // q tiles on the slowest grid axis, the longest (causal) first
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBQ;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int hk = h / (Hq / Hkv);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;   // the fragment's row within 8
  const int tq = lane % 4;  // the fragment's column pair
  const long long q_stride = (long long)Hq * D;
  const long long kv_stride = (long long)Hkv * D;
  const __nv_bfloat16* qb = q + ((long long)b * S * Hq + h) * D;
  const __nv_bfloat16* kb = k + ((long long)b * Skv * Hkv + hk) * D;
  const __nv_bfloat16* vb = v + ((long long)b * Skv * Hkv + hk) * D;

  // rows row0 .. row0 + 63 into a padded tile, zeros at or past n_rows
  auto load_tile = [&](const __nv_bfloat16* base, long long row_stride,
                       int row0, int n_rows, __nv_bfloat16* tile) {
    for (int c = threadIdx.x; c < kBK * kChunks; c += kBf16Threads) {
      const int r = c / kChunks;
      const int e = (c % kChunks) * 8;
      const bool ok = row0 + r < n_rows;
      cp_async16(smem_addr(tile + r * kLd + e),
                 ok ? base + (row0 + r) * row_stride + e : base, ok);
    }
  };

  // the kv tiles that hold a live key for some row of this q tile
  const int kt_end = min((Skv + kBK - 1) / kBK, (q0 + kBQ - 1) / kBK + 1);
  int kt_begin = 0;
  if (window > 0 && q0 - (window - 1) > 0) kt_begin = (q0 - (window - 1)) / kBK;

  load_tile(qb, q_stride, q0, S, Qs);
  cp_async_commit();
  if (kt_begin < kt_end) {
    load_tile(kb, kv_stride, kt_begin * kBK, Skv, Ks);
    load_tile(vb, kv_stride, kt_begin * kBK, Skv, Vs);
  }
  cp_async_commit();
  cp_async_wait<1>();  // the q tile has landed
  __syncthreads();

  const int r0 = warp * 16;  // this warp's rows in the q tile
  uint32_t qf[kKsteps][4];
#pragma unroll
  for (int ks = 0; ks < kKsteps; ++ks)
    ldsm_x4(smem_addr(Qs + (r0 + lane % 16) * kLd + ks * 16 + (lane / 16) * 8),
            qf[ks]);

  // acc[n]: rows g and g + 8 of the output's n-tile n; lsum: the same rows'
  // sums of P, by a product with a fragment of ones
  float acc[kDtiles][4], lsum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int n = 0; n < kDtiles; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf};  // running max of the raw dots
  const float sl = scale * kLog2e;  // exp(scale (s - m)) = 2^(sl (s - m))
  const int row_lo = q0 + r0 + g;   // this thread's rows: row_lo, row_lo + 8

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int buf = (kt - kt_begin) & 1;
    const int k0 = kt * kBK;
    if (kt + 1 < kt_end) {  // the next tile's copy is in flight meanwhile
      load_tile(kb, kv_stride, k0 + kBK, Skv, Ks + (buf ^ 1) * kBK * kLd);
      load_tile(vb, kv_stride, k0 + kBK, Skv, Vs + (buf ^ 1) * kBK * kLd);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile has landed
    __syncthreads();
    const __nv_bfloat16* Kt = Ks + buf * kBK * kLd;
    const __nv_bfloat16* Vt = Vs + buf * kBK * kLd;

    // the last key of the tile that is live for some row of this warp, and
    // whether any is: a tile wholly above the warp's rows or wholly before
    // its window leaves m, l and acc as they are
    const int last = q0 + r0 + 15 - k0;
    const bool warp_live =
        last >= 0 && (window <= 0 || k0 + kBK - 1 > q0 + r0 - window);
    if (warp_live) {
      float s[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < kKsteps; ++ks) {
#pragma unroll
        for (int jp = 0; jp < 4; ++jp) {  // keys 16 jp .. 16 jp + 15
          if (16 * jp > last) continue;
          uint32_t bf[4];
          ldsm_x4(smem_addr(Kt + (16 * jp + lane % 8 + (lane / 16) * 8) * kLd +
                            ks * 16 + ((lane / 8) % 2) * 8),
                  bf);
          mma_bf16(s[2 * jp], qf[ks], bf[0], bf[1]);
          mma_bf16(s[2 * jp + 1], qf[ks], bf[2], bf[3]);
        }
      }

      // the -1e30 masks, only where the tile crosses the diagonal, a
      // window's edge or Skv for some row of this warp; the scale is folded
      // into the exponent (scale > 0: the max and the masks commute with it)
      const bool need_mask = q0 + r0 - k0 < kBK - 1 || k0 + kBK > Skv ||
                             (window > 0 && last >= window);
      if (need_mask) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qi = row_lo + (e / 2) * 8;
            const int kj = k0 + 8 * j + 2 * tq + (e % 2);
            const bool live =
                kj < Skv && kj <= qi && (window <= 0 || qi - kj < window);
            s[j][e] = live ? s[j][e] : kNegInf;
          }
      }
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
      }
      float mlog[2], corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        corr[r] = ex2((m[r] - mx[r]) * sl);
        // a row with no live key yet keeps p = 0: 2^(s sl - inf) = 0
        mlog[r] = mx[r] <= kNegInf * 0.5f ? __int_as_float(0x7f800000) : mx[r] * sl;
        m[r] = mx[r];
      }

      // P in bf16, as the A fragments of P V and of the sums of P
      uint32_t pf[4][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          pf[j / 2][(j % 2) * 2 + r] =
              pack_bf16(ex2(fmaf(s[j][2 * r], sl, -mlog[r])),
                        ex2(fmaf(s[j][2 * r + 1], sl, -mlog[r])));
#pragma unroll
      for (int n = 0; n < kDtiles; ++n) {
        acc[n][0] *= corr[0];
        acc[n][1] *= corr[0];
        acc[n][2] *= corr[1];
        acc[n][3] *= corr[1];
      }
      lsum[0] *= corr[0];
      lsum[1] *= corr[0];
      lsum[2] *= corr[1];
      lsum[3] *= corr[1];

#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {  // keys 16 kk .. 16 kk + 15
        if (16 * kk > last) continue;
#pragma unroll
        for (int dp = 0; dp < kDtiles / 2; ++dp) {
          uint32_t bf[4];
          ldsm_x4_trans(
              smem_addr(Vt + (16 * kk + lane % 8 + ((lane / 8) % 2) * 8) * kLd +
                        16 * dp + (lane / 16) * 8),
              bf);
          mma_bf16(acc[2 * dp], pf[kk], bf[0], bf[1]);
          mma_bf16(acc[2 * dp + 1], pf[kk], bf[2], bf[3]);
        }
        mma_bf16(lsum, pf[kk], kOnesBf16x2, kOnesBf16x2);
      }
    }
    __syncthreads();  // every read of this buffer is done before its refill
  }

  // out = acc / max(l, 1e-30), staged through this warp's rows of the q
  // tile (no other warp reads them) for 16-byte stores
  const float inv0 = 1.f / fmaxf(lsum[0], 1e-30f);
  const float inv1 = 1.f / fmaxf(lsum[2], 1e-30f);
  __nv_bfloat16* stage = Qs + r0 * kLd;
#pragma unroll
  for (int n = 0; n < kDtiles; ++n) {
    *reinterpret_cast<uint32_t*>(stage + g * kLd + 8 * n + 2 * tq) =
        pack_bf16(acc[n][0] * inv0, acc[n][1] * inv0);
    *reinterpret_cast<uint32_t*>(stage + (g + 8) * kLd + 8 * n + 2 * tq) =
        pack_bf16(acc[n][2] * inv1, acc[n][3] * inv1);
  }
  __syncwarp();
  for (int c = lane; c < 16 * kChunks; c += 32) {
    const int r = c / kChunks;
    const int e = (c % kChunks) * 8;
    const int qi = q0 + r0 + r;
    if (qi < S)
      *reinterpret_cast<uint4*>(o + (((long long)b * S + qi) * Hq + h) * D +
                                e) =
          *reinterpret_cast<const uint4*>(stage + r * kLd + e);
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B,
               int S, int Skv, int Hq, int Hkv, int window, float scale,
               cudaStream_t stream) {
  constexpr int smem =
      sizeof(float) * ((kBQ + 2 * kBK) * (D + 4) + kBQ * kPld);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_f32_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBQ - 1) / kBQ, Hq, B);
  flash_attention_f32_kernel<D><<<grid, kF32Threads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, Skv, Hq, Hkv,
      window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int B,
                int S, int Skv, int Hq, int Hkv, int window, float scale,
                cudaStream_t stream) {
  // the q tile and two buffers each of the k and v tiles
  constexpr int smem = sizeof(__nv_bfloat16) * (kBQ + 4 * kBK) * (D + 8);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_bf16_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(Hq, B, (S + kBQ - 1) / kBQ);
  flash_attention_bf16_kernel<D><<<grid, kBf16Threads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), S,
      Skv, Hq, Hkv, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One launch on ``stream``. dtype 0 is float32 (the scalar route), 1 is bf16
// (the tensor-core route); window 0 means none. Returns the cudaError_t of
// the launch (0 on success), and cudaErrorInvalidValue for a head dim other
// than 64 and 128 or another dtype.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int S,
                                      int Skv, int Hq, int Hkv, int D,
                                      int window, int dtype, float scale,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && D == 64)
    return launch_bf16<64>(q, k, v, o, B, S, Skv, Hq, Hkv, window, scale, st);
  if (dtype == 1 && D == 128)
    return launch_bf16<128>(q, k, v, o, B, S, Skv, Hq, Hkv, window, scale, st);
  if (dtype == 0 && D == 64)
    return launch_f32<64>(q, k, v, o, B, S, Skv, Hq, Hkv, window, scale, st);
  if (dtype == 0 && D == 128)
    return launch_f32<128>(q, k, v, o, B, S, Skv, Hq, Hkv, window, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
