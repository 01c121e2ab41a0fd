// Flash attention, forward, for Hopper (sm_90a): causal (and
// sliding-window), or over every key.
//
// Replaces the Pallas kernel _fa_kernel of
// src/repro/kernels/flash_attention/kernel.py:31 (wrapper
// flash_attention_bhsd, model-layout entry ops.py::flash_attention), which
// the reference's attention reaches for backend="pallas" on the prefill of
// every layer.
//
// What it computes, per (batch, q head), over positions counted from 0:
//   s[i, j] = (q[i] . k[j]) * scale          scale = 1/sqrt(D), after the dot
//   live(i, j) = (j <= i where causal)  and  (no window or i - j < window)
//                and  j < Skv
//   s = live ? s : -1e30                      (-1e30, not -inf)
//   out[i] = sum_j p[i, j] v[j] / max(l[i], 1e-30),  p = exp(s - running max)
// with the reference's online softmax: a running max m, normalizer l and
// accumulator per row, all float32, updated once per kv tile (128 keys in
// the bf16 route up to D = 128 and 64 at its 256-column instance, 64 in the
// float32 one); a row whose running max is still
// -1e30 keeps p = 0. The kv head of q head h is h / (Hq / Hkv) (GQA). The
// output is written in the inputs' dtype. Ragged S is handled at the edges
// (rows past S are not stored, keys past Skv are masked), where the
// reference pads to its block size; for the self-attention it serves
// (Skv == S) the padded keys sit after every query and are causally masked,
// so the results are the same. Without the causal mask (causal = 0: every
// kv tile, Skv free of S) the keys past Skv are masked by their index; the
// reference's zero-padded keys would take part in the softmax there
// (ROADMAP.md, R8), which its own oracle does not do. A window needs the
// causal mask (the reference's kernel and oracle disagree without it, R9).
//
// Layout, in and out: q (B, S, Hq, D), k/v (B, Skv, Hkv, D), o (B, S, Hq, D),
// contiguous, on 16-byte boundaries. Each route is instantiated at the panel
// widths 64, 128 and 256 and runs the next one at or above D: the bf16
// route's tensor maps take the true D (a multiple of 8), so that the TMA
// fills the panel's columns past D with zeros (a box wholly past D comes
// back as zeros), which add nothing to Q K^T, and its store drops the
// output's; the float32 route loads and stores those columns under guards
// (D a multiple of 4). The scale is 1/sqrt(D) of the true D, which the
// caller passes: ops.flash_attention adds zero columns to a D off the
// route's step and passes the scale of the D it was given.
//
// What bounds it on this card: the operations. Causal prefill is
// 4 * B * Hq * D * S (S + 1) / 2 operations against q, k, v and o read or
// written once (chip_smoke.py::fa_bound): at smollm-135m (B=8, S=1024, 9 q
// over 3 kv heads, D=64) 9.7 GFLOP, 9.8 us at the dense bf16 tensor-core
// rate (989 TFLOP/s) against 7.5 us of bytes at 3.35 TB/s; at granite-34b
// (48 q heads over 1, D=128) 103 GFLOP, 104 us against 27 us of bytes.
//
// Two routes, picked by the inputs' dtype in flash_attention_launch:
//
// bf16 (the serving path): flash_attention_wgmma_kernel, on Hopper's warpgroup
// tensor-core instructions. One block of three warpgroups per 128 q rows, one
// block per SM; q tiles are taken those with the most kv tiles first, on the
// grid's slowest axis, or on its fastest where k and v outgrow L2 (more than 40
// MB of the 50), so that the blocks that read one (batch, kv head)'s tiles run
// together. Warpgroup 0 is the producer: it gives up its registers
// (setmaxnreg.dec to 24) and one of its threads issues every copy as a TMA box
// from tensor maps on the tensors as they lie (4-d: D, H, S, B; the 128-byte
// swizzle; built on each call in the C entry). The q tiles are loaded once; kv
// tiles of 128 keys run through a ring of 2 stages in shared memory (Q 32 KB +
// 2 x (K 32 KB + V 32 KB) at D = 128, half at 64; at D = 256 tiles of 64
// keys, Q 64 KB + 2 x (K 32 KB + V 32 KB) = 192 KB, as 128-key tiles would
// need 320 KB: FlashAttention-3 too narrows its kv tile at 256), each stage
// with a full
// barrier per operand (armed with the tile's bytes) and an empty barrier that
// each consumer warp arrives at once the wgmma reading the stage has retired.
// Warpgroups 1 and 2 are the consumers (setmaxnreg.inc to 240), 64 q rows each.
// Where Hq / Hkv is even they take the same 64 positions of two q heads of one
// kv head, whose causal extents are equal; otherwise 128 consecutive positions
// of one head. The walk runs over the kv tiles that hold a live key for some
// row of the block (from the window's first live tile to the diagonal, or
// every tile without the causal mask), and a
// consumer whose rows have none in a tile skips its products there (it still
// waits on and releases the stage). Per tile, a consumer computes S = Q K^T by
// wgmma m64n128k16 (m64n64k16 on 64-key tiles) with both operands read from
// shared memory through
// descriptors; applies the -1e30 masks only on tiles that cross the diagonal, a
// window's edge or Skv; runs the online softmax on the accumulator in registers
// (row max over the quad by shuffles, the scale folded into the exponent as
// 2^((s - m) scale log2 e) by ex2.approx); rounds P to bf16 in the
// accumulator's order, which is the register A operand of O += P V (wgmma
// m64nDk16, two m64n128k16 halves at D = 256, V read from shared memory as
// an MN-major operand: no transpose copy), and sums l from the same rounded
// weights: that rounding (2^-9 relative
// a weight) is the route's one rounding beyond the output's. The output, acc /
// max(l, 1e-30) in bf16, is written into the consumer's q tile in the swizzled
// layout and stored by TMA, which clips rows past S.
//
// What this does about the limits of the mma.sync route it replaced (one
// warp per 16 rows, ldmatrix, cp.async; 168 TFLOP/s at granite's shape):
// shared memory is read by the tensor cores themselves, and each kv tile
// feeds 128 q rows instead of 64 (four 16-row warps re-reading it through
// ldmatrix); at D = 128 the consumers hold S, O and P in 240 registers
// where the old route's cap spilled (at D = 256, S of a 64-key tile and
// O's 128 floats a thread); no thread spends instructions on
// addresses or copies; and under GQA with an even group the kv tiles of a
// head are loaded once per pair of q heads. Left for later: a consumer's
// softmax of one tile overlapping its product of the next, kv tiles
// multicast across a cluster, and a persistent scheduler (PERF.md, section
// 6, measures what each block's start and end, the exponentials and the
// kv tiles' traffic out of L2 cost).
//
// float32 (the first design, kept for the 1e-5 parity that rules out TF32):
// flash_attention_f32_kernel, scalar float32 FMAs outside the tensor cores
// (67 TFLOP/s), so its own floor is about 145 us at smollm's shape.
// Its shared memory is 4 ((64 + 2 x 64)(D + 4) + 64 x 68) bytes: 217,088 at
// D = 256, under the 232,448 a block can have.
// One block of 256 threads per (64-row q tile, q head, batch), tiles staged
// as float32 with synchronous loads; a thread owns a 4 x 4 block of the
// score tile and a 4 x (D/16) block of the accumulator, the 16 threads of a
// row group are one half-warp (row max and row sum are xor-shuffles), and
// the probabilities go through shared memory for the product with V.
//
// No atomics in either route: the result does not change between runs.

#include "hopper.cuh"

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

// Rows row0 .. row0 + 63 of a (rows, d) matrix whose rows are row_stride
// elements apart, into a float32 tile of D columns with rows D + 4 floats
// apart; rows at or past n_rows and columns at or past d are zero.
template <int D>
__device__ void load_tile_f32(const float* __restrict__ base,
                              long long row_stride, int row0, int n_rows,
                              int d, float* tile) {
  constexpr int kChunksPerRow = D / 4;
  for (int c = threadIdx.x; c < kBK * kChunksPerRow; c += kF32Threads) {
    const int r = c / kChunksPerRow;
    const int e = (c % kChunksPerRow) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n_rows && e < d)
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
                               int Hkv, int d, int causal, int window,
                               float scale) {
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
  const long long q_stride = (long long)Hq * d;
  const long long kv_stride = (long long)Hkv * d;
  const float* kb = k + ((long long)b * Skv * Hkv + hk) * d;
  const float* vb = v + ((long long)b * Skv * Hkv + hk) * d;

  load_tile_f32<D>(q + ((long long)b * S * Hq + h) * d, q_stride, q0, S, d,
                   Qs);

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int cc = 0; cc < kCols; ++cc) acc[r][cc] = 0.f;
  }

  // the kv tiles that hold a live key for some row of this q tile: every
  // tile without the causal mask
  int kt_end = (Skv + kBK - 1) / kBK;
  if (causal) kt_end = min(kt_end, (q0 + kBQ - 1) / kBK + 1);
  int kt_begin = 0;
  if (window > 0 && q0 - (window - 1) > 0) kt_begin = (q0 - (window - 1)) / kBK;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the last tile's reads of Ks, Vs and Ps are done
    load_tile_f32<D>(kb, kv_stride, k0, Skv, d, Ks);
    load_tile_f32<D>(vb, kv_stride, k0, Skv, d, Vs);
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
        const bool live = kj < Skv && (!causal || kj <= qi) &&
                          (window <= 0 || qi - kj < window);
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
    float* orow = o + (((long long)b * S + qi) * Hq + h) * d;
#pragma unroll
    for (int cc = 0; cc < kCols; ++cc)
      if (tx + 16 * cc < d) orow[tx + 16 * cc] = acc[r][cc] / denom;
  }
}

// ---------------------------------------------------------------------------
// bf16 route: wgmma, TMA and an mbarrier ring (sm_90a)
// ---------------------------------------------------------------------------

constexpr int kWgRows = 64;    // q rows of one consumer warpgroup
constexpr int kStages = 2;     // kv tiles in flight in shared memory
constexpr int kBf16Threads = 384;  // a producer and two consumer warpgroups
constexpr int kPanel = 64;     // bf16 values in a 128-byte swizzle span
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;  // 24 * 128 + 2 * 240 * 128 <= 65,536
static_assert(kProducerRegs * 128 + 2 * kConsumerRegs * 128 <= 65536,
              "the three warpgroups' registers fit the SM's file");
// k and v larger than this do not stay in the 50 MB L2 across the grid
constexpr long long kKvL2Bytes = 40ll << 20;

// keys per kv tile: 128, or 64 at D = 256, where two stages of 128-key k
// and v tiles beside the q tiles would take 320 KB of the SM's 227
template <int D>
struct KvTile {
  static constexpr int kKeys = D > 128 ? 64 : 128;
};

// Shared memory of one block, in bytes from a 1024-byte boundary (the 128B
// swizzle's atom is 8 rows of 128 bytes): each consumer's q tile (then its
// output tile), the ring's k and v tiles, and the ring's mbarriers. A tile
// row of D values is D / 64 panels of 128 bytes; panel p of a tile of R
// rows starts at p * R * 128, as one TMA box of (R, 64) lands it.
template <int D>
struct Bf16Smem {
  static constexpr int kQTile = kWgRows * D * 2;   // one consumer's q or o
  static constexpr int kKvTile = KvTile<D>::kKeys * D * 2;  // one k or v tile
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + 2 * kQTile;
  static constexpr int kV = kK + kStages * kKvTile;
  static constexpr int kBar = kV + kStages * kKvTile;
  // q_full, then k_full, v_full and empty for each stage
  static constexpr int kBytes = kBar + 8 * (1 + 3 * kStages);
  static constexpr int kAlloc = kBytes + 1024;  // room to align the base
};

// the sum of a bf16 pair, exactly as the rounded values
__device__ __forceinline__ float bf16x2_sum(uint32_t x) {
  return __uint_as_float(x << 16) + __uint_as_float(x & 0xFFFF0000u);
}

// 2^x by the special-function unit, flushing denormals (any weight below
// 2^-126 is rounded away in bf16 anyway); 2^-inf = +0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One block per 128 q rows: two q heads of one GQA group at the same 64
// positions (``pair``: Hq / Hkv even), or 128 positions of one head. Warp
// group 0 is the producer (one thread issues every TMA copy), 1 and 2 the
// consumers, 64 rows each.
template <int D>
__global__ void __launch_bounds__(kBf16Threads, 1)
    flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                                 const __grid_constant__ CUtensorMap tk,
                                 const __grid_constant__ CUtensorMap tv,
                                 const __grid_constant__ CUtensorMap to,
                                 int S, int Skv, int Hq, int Hkv, int causal,
                                 int window, float scale, int pair,
                                 int q_fast) {
  using L = Bf16Smem<D>;
  constexpr int kTileK = KvTile<D>::kKeys;    // keys per kv tile
  constexpr int kPanels = D / kPanel;
  constexpr int kKsteps = D / 16;         // k16 steps of Q K^T
  constexpr int kQPanel = kWgRows * 128;  // bytes of a q panel
  constexpr int kKvPanel = kTileK * 128;  // bytes of a k or v panel
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);
  const uint32_t q_full = base + L::kBar;
  const uint32_t k_full = q_full + 8;
  const uint32_t v_full = k_full + 8 * kStages;
  const uint32_t empty = v_full + 8 * kStages;

  // q tiles the longest (causal) first: on the slowest grid axis, or on
  // the fastest where k and v outgrow L2, so that the blocks of one (batch,
  // kv head) run together and read its kv tiles while L2 holds them
  const int rows = pair ? kWgRows : 2 * kWgRows;  // positions of this block
  const int q_tiles = q_fast ? gridDim.x : gridDim.z;
  const int q0 = (q_tiles - 1 - (q_fast ? blockIdx.x : blockIdx.z)) * rows;
  const int hb = q_fast ? blockIdx.y : blockIdx.x;  // head (or pair) index
  const int h0 = pair ? 2 * hb : hb;
  const int b = q_fast ? blockIdx.z : blockIdx.y;
  const int hk = h0 / (Hq / Hkv);
  // the kv tiles that hold a live key for some row of this block: every
  // tile without the causal mask
  int kt_end = (Skv + kTileK - 1) / kTileK;
  if (causal) kt_end = min(kt_end, (q0 + rows - 1) / kTileK + 1);
  int kt_begin = 0;
  if (window > 0 && q0 - (window - 1) > 0)
    kt_begin = (q0 - (window - 1)) / kTileK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(k_full + 8 * st, 1);
      mbar_init(v_full + 8 * st, 1);
      mbar_init(empty + 8 * st, 8);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one thread issues every copy --------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, 2 * L::kQTile);
      for (int c = 0; c < 2; ++c)
        for (int p = 0; p < kPanels; ++p)
          tma_load(base + L::kQ + c * L::kQTile + p * kQPanel, &tq, q_full,
                   p * kPanel, pair ? h0 + c : h0,
                   pair ? q0 : q0 + c * kWgRows, b);
      for (int kt = kt_begin, i = 0; kt < kt_end; ++kt, ++i) {
        const int st = i % kStages;
        // the stage's last tile has been read by both consumers
        mbar_wait(empty + 8 * st, ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(k_full + 8 * st, L::kKvTile);
        for (int p = 0; p < kPanels; ++p)
          tma_load(base + L::kK + st * L::kKvTile + p * kKvPanel, &tk,
                   k_full + 8 * st, p * kPanel, hk, kt * kTileK, b);
        mbar_expect_tx(v_full + 8 * st, L::kKvTile);
        for (int p = 0; p < kPanels; ++p)
          tma_load(base + L::kV + st * L::kKvTile + p * kKvPanel, &tv,
                   v_full + 8 * st, p * kPanel, hk, kt * kTileK, b);
      }
    }
  } else {
    // ---- consumers: 64 q rows each --------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int c = wg - 1;
    const int t = threadIdx.x % 128;
    const int warp = t / 32;
    const int lane = t % 32;
    const int g = lane / 4;   // the accumulator's row within 8
    const int tq = lane % 4;  // the accumulator's column pair
    const int qa = pair ? q0 : q0 + c * kWgRows;  // this consumer's first row
    const int row_lo = qa + 16 * warp + g;  // this thread's rows: +0, +8
    const uint32_t q_s = base + L::kQ + c * L::kQTile;

    float s[kTileK / 2];  // S = Q K^T: 64 rows x kTileK keys
    float acc[D / 2];     // O: 64 rows x D
#pragma unroll
    for (int i = 0; i < kTileK / 2; ++i) s[i] = 0.f;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m[2] = {kNegInf, kNegInf};  // running max of the raw dots
    float lsum[2] = {0.f, 0.f};       // this thread's part of l
    const float sl = scale * kLog2e;  // exp(scale (s - m)) = 2^(sl (s - m))

    mbar_wait(q_full, 0);
    for (int kt = kt_begin, i = 0; kt < kt_end; ++kt, ++i) {
      const int st = i % kStages;
      const uint32_t parity = (i / kStages) & 1;
      const int k0 = kt * kTileK;
      const uint32_t k_s = base + L::kK + st * L::kKvTile;
      const uint32_t v_s = base + L::kV + st * L::kKvTile;
      // every consumer waits on every tile, live or not, so that its
      // parity never runs ahead of the ring
      mbar_wait(k_full + 8 * st, parity);
      // a tile wholly above this consumer's rows or wholly before their
      // window leaves m, l and acc as they are
      const bool live = (!causal || k0 <= qa + kWgRows - 1) &&
                        (window <= 0 || qa - (k0 + kTileK - 1) < window);
      if (live) {
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < kKsteps; ++ks) {
          const uint64_t dq =
              sw128_desc(q_s + (ks / 4) * kQPanel + (ks % 4) * 32, 16, 1024);
          const uint64_t dk =
              sw128_desc(k_s + (ks / 4) * kKvPanel + (ks % 4) * 32, 16, 1024);
          if constexpr (kTileK == 64)
            wgmma_ss_n64(s, dq, dk, ks > 0);
          else
            wgmma_ss_n128(s, dq, dk, ks > 0);
        }
        wgmma_commit();
        wgmma_wait_all();

        // the -1e30 masks, only where the tile crosses the diagonal, a
        // window's edge or Skv for some row of this consumer (a key past
        // Skv comes in as zeros and would score 0: without the causal mask
        // only its index masks it); the scale is folded into the exponent
        // (scale > 0: the max and the masks commute with it)
        const bool need_mask =
            (causal && k0 + kTileK - 1 > qa) || k0 + kTileK > Skv ||
            (window > 0 && qa + kWgRows - 1 - k0 >= window);
        if (need_mask) {
#pragma unroll
          for (int j = 0; j < kTileK / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int qi = row_lo + (e / 2) * 8;
              const int kj = k0 + 8 * j + 2 * tq + (e % 2);
              const bool ok = kj < Skv && (!causal || kj <= qi) &&
                              (window <= 0 || qi - kj < window);
              s[4 * j + e] = ok ? s[4 * j + e] : kNegInf;
            }
        }
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int j = 0; j < kTileK / 8; ++j) {
          mx[0] = fmaxf(mx[0], fmaxf(s[4 * j], s[4 * j + 1]));
          mx[1] = fmaxf(mx[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
        }
        float mlog[2], corr[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          corr[r] = ex2((m[r] - mx[r]) * sl);
          // a row with no live key yet keeps p = 0: 2^(s sl - inf) = 0
          mlog[r] = mx[r] <= kNegInf * 0.5f ? __int_as_float(0x7f800000)
                                            : mx[r] * sl;
          m[r] = mx[r];
        }

        // P in bf16 as the A operand of P V: keys 16 kk .. 16 kk + 15 are
        // the accumulator's column blocks 2 kk and 2 kk + 1; l sums the
        // rounded weights the output sees
        uint32_t pf[kTileK / 16][4];
        float ps[2] = {0.f, 0.f};
#pragma unroll
        for (int j = 0; j < kTileK / 8; ++j)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const uint32_t x =
                pack_bf16(ex2(fmaf(s[4 * j + 2 * r], sl, -mlog[r])),
                          ex2(fmaf(s[4 * j + 2 * r + 1], sl, -mlog[r])));
            pf[j / 2][(j % 2) * 2 + r] = x;
            ps[r] += bf16x2_sum(x);
          }
#pragma unroll
        for (int r = 0; r < 2; ++r) lsum[r] = lsum[r] * corr[r] + ps[r];
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          acc[4 * n] *= corr[0];
          acc[4 * n + 1] *= corr[0];
          acc[4 * n + 2] *= corr[1];
          acc[4 * n + 3] *= corr[1];
        }

        mbar_wait(v_full + 8 * st, parity);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kTileK / 16; ++kk) {
          const uint64_t dv =
              sw128_desc(v_s + kk * 16 * 128, kKvPanel, 1024);
          if constexpr (D == 64) {
            wgmma_rs_n64(acc, pf[kk], dv);
          } else if constexpr (D == 128) {
            wgmma_rs_n128(acc, pf[kk], dv);
          } else {  // two halves of 128 columns, two panels apart
            wgmma_rs_n128(acc, pf[kk], dv);
            wgmma_rs_n128(acc + 64, pf[kk],
                          sw128_desc(v_s + 2 * kKvPanel + kk * 16 * 128,
                                     kKvPanel, 1024));
          }
        }
        wgmma_commit();
        wgmma_wait_all();
      } else {
        mbar_wait(v_full + 8 * st, parity);
      }
      // this consumer's reads of the stage are done
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * st);
    }

    // out = acc / max(l, 1e-30) in bf16, into this consumer's q tile (its
    // reads are done) in the 128B-swizzled layout the TMA store reads
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = lsum[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      inv[r] = 1.f / fmaxf(l, 1e-30f);
    }
    uint8_t* const o_s = gbase + L::kQ + c * L::kQTile;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = 16 * warp + g + 8 * r;
        const int off = (n / 8) * kQPanel + row * 128 +
                        (((n % 8) ^ (row % 8)) * 16) + tq * 4;
        *reinterpret_cast<uint32_t*>(o_s + off) = pack_bf16(
            acc[4 * n + 2 * r] * inv[r], acc[4 * n + 2 * r + 1] * inv[r]);
      }
    // the stores are seen by the TMA (the async proxy) once every thread of
    // this consumer has made them
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");
    if (t == 0) {
      for (int p = 0; p < kPanels; ++p)
        tma_store(&to, q_s + p * kQPanel, p * kPanel, pair ? h0 + c : h0, qa,
                  b);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B,
               int S, int Skv, int Hq, int Hkv, int d, int causal,
               int window, float scale, cudaStream_t stream) {
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
      d, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

// The map of a contiguous bf16 (B, S, H, D) tensor as 4-d (D, H, S, B),
// boxes of (64 values, 1 head, ``rows`` positions, 1 batch) in the 128B
// swizzle; false if the encoding is refused. With D below the instance's
// panels the boxes reach past D: a load fills those columns with zeros
// and a store drops them
bool bf16_map(EncodeTiled enc, CUtensorMap* map, const void* ptr, int B,
              int S, int H, int D, int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {2ull * D, 2ull * H * D, 2ull * S * H * D};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(kPanel), 1,
                             static_cast<cuuint32_t>(rows), 1};
  return bf16_map_4d(enc, map, ptr, dims, strides, box);
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int B,
                int S, int Skv, int Hq, int Hkv, int d, int causal,
                int window, float scale, cudaStream_t stream) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap tq, tk, tv, to;
  if (!bf16_map(enc, &tq, q, B, S, Hq, d, kWgRows) ||
      !bf16_map(enc, &tk, k, B, Skv, Hkv, d, KvTile<D>::kKeys) ||
      !bf16_map(enc, &tv, v, B, Skv, Hkv, d, KvTile<D>::kKeys) ||
      !bf16_map(enc, &to, o, B, S, Hq, d, kWgRows))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = Bf16Smem<D>::kAlloc;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_wgmma_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // two q heads of one kv head share each kv tile where the group is even
  const int pair = (Hq / Hkv) % 2 == 0;
  const int rows = pair ? kWgRows : 2 * kWgRows;
  const int q_tiles = (S + rows - 1) / rows;
  const int heads = pair ? Hq / 2 : Hq;
  const int q_fast = 4ll * B * Skv * Hkv * d > kKvL2Bytes;
  const dim3 grid = q_fast ? dim3(q_tiles, heads, B) : dim3(heads, B, q_tiles);
  flash_attention_wgmma_kernel<D><<<grid, kBf16Threads, smem, stream>>>(
      tq, tk, tv, to, S, Skv, Hq, Hkv, causal, window, scale, pair, q_fast);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One launch on ``stream``. dtype 0 is float32 (the scalar route), 1 is bf16
// (the tensor-core route); causal 0 attends to every key below Skv; window
// 0 means none (a window needs the causal mask). Each route runs the
// instance of the next panel width, 64, 128 or 256, at or above the head
// dim D. Returns the cudaError_t of the launch (0 on success), and
// cudaErrorInvalidValue for a D off the route's domain (bf16: a multiple of
// 8 from 8 to 256, which TMA's 16-byte strides need; float32: of 4 from 4
// to 256), a window without the causal mask, or another dtype.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int S,
                                      int Skv, int Hq, int Hkv, int D,
                                      int causal, int window, int dtype,
                                      float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int step = dtype == 1 ? 8 : 4;
  if (D < step || D > 256 || D % step != 0 || (window > 0 && !causal))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1 && D <= 64)
    return launch_bf16<64>(q, k, v, o, B, S, Skv, Hq, Hkv, D, causal, window,
                           scale, st);
  if (dtype == 1 && D <= 128)
    return launch_bf16<128>(q, k, v, o, B, S, Skv, Hq, Hkv, D, causal, window,
                            scale, st);
  if (dtype == 1)
    return launch_bf16<256>(q, k, v, o, B, S, Skv, Hq, Hkv, D, causal, window,
                            scale, st);
  if (dtype == 0 && D <= 64)
    return launch_f32<64>(q, k, v, o, B, S, Skv, Hq, Hkv, D, causal, window,
                          scale, st);
  if (dtype == 0 && D <= 128)
    return launch_f32<128>(q, k, v, o, B, S, Skv, Hq, Hkv, D, causal, window,
                           scale, st);
  if (dtype == 0)
    return launch_f32<256>(q, k, v, o, B, S, Skv, Hq, Hkv, D, causal, window,
                           scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
