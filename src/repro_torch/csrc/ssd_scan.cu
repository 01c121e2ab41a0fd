// Mamba2 SSD chunked scan, forward, for Hopper (sm_90a).
//
// Replaces the Pallas kernel _ssd_kernel of
// src/repro/kernels/ssd_scan/kernel.py:27 (wrapper ssd_scan_pallas, model
// entry ops.py::ssd_scan). The port runs it on the prefill of every layer
// of the ssm family, where it also returns the final state that the Pallas
// kernel keeps in VMEM scratch and drops.
//
// What it computes, per (batch, head), walking the chunks of Q positions
// in order (Q a multiple of 16 up to 256, the TPU kernel's grid step: the
// chunked algorithm's rounding depends on Q, so a chunk of 256 is one chunk,
// never two of 128) and carrying h_state (P, N) in float32 from zero:
//   dA_cum = cumsum(dt * A)                                   (Q,)
//   L[i, j] = exp(dA_cum[i] - dA_cum[j]) for i >= j, else exactly 0
//   y = ((C B^T) .* L) (x * dt) + (C h_state^T) * exp(dA_cum)   (Q, P)
//   h_state <- h_state * exp(dA_cum[Q-1])
//              + x^T (B * exp(dA_cum[Q-1] - dA_cum) * dt)
// with B and C of the head's group g = head / (H / G). y is written in the
// inputs' dtype and, when a pointer is passed, the final h_state
// (B, H, P, N) in float32. A ragged last chunk is read as zero past S
// (dt = 0 there: unit decay and no state update), which is what the
// reference's dt = 0 padding computes; rows past S are not stored. A chunk
// takes one row tile of 128 rows up to Q = 128 and two above (the bf16
// route splits it at Q / 2, the float32 route at 128), a tile's rows past
// its part of the chunk read as zeros with dt = 0 in the same way (x = 0
// too, since 0 x NaN is NaN), so a chunk below 128 costs a chunk of 128.
// Over two row tiles the products are the chunk's own, tile by tile: C B^T
// .* L of rows 1 against keys 0 and 1, with L from the chunk's dA_cum, and
// the state update over all Q keys; no state passes between the tiles (C
// h^T reads the state as it entered the chunk in both).
//
// Layout: x (B, S, H, P) and B, C (B, S, G, N) with unit stride in their
// last two axes and any batch and sequence strides that are multiples of 4
// elements (the model passes views into the conv's output), dt (B, S, H)
// and A (H,) contiguous float32, y (B, S, H, P) contiguous. P a multiple
// of 8 up to 128 and N a multiple of 8 up to 256 (ops.ssd_scan adds zero
// columns to others): the tiles are 64 columns of x, a block for each 64
// columns of P (the columns of x, y and the rows of h are independent of
// one another: at P = 128 two blocks a head, each recomputing C B^T), and
// N in slabs of 64 (bf16) or tiles of 32 (float32), and their
// columns past P or N are zeros (the bf16 route's tensor maps take the true
// widths, so that the TMA fills them and its store drops y's; the float32
// route guards its loads and stores). They leave y and h's live part as
// they are, and h's padded rows and columns stay exactly 0 across chunks.
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
// innermost "arbitrary" grid axis), here a loop inside the block. A
// two-pass design (chunk states in parallel, then a scan) would write and
// read the (B, chunks, H, P, N) float32 chunk states, 134 MB at the path's
// shape, more than the bound's bytes. dtype picks the route in
// ssd_scan_launch.
//
// bf16 (the serving path): ssd_scan_wgmma_kernel, on Hopper's warpgroup
// tensor-core instructions. One block of three warpgroups walks one head
// of one batch row, one block per SM; the blocks of one (batch, group) are
// next to each other on the grid and read B and C while L2 holds them.
//   - Warpgroup 0 is the producer (setmaxnreg.dec): one thread issues TMA
//     boxes (tensor maps on the tensors as they lie, 4-d, the 128B
//     swizzle, built on each call in the C entry) into two rings with full
//     and empty mbarriers: a ring of 2 chunk stages (the head's x tile,
//     128 x 64) and a ring of 2-4 slab stages (B and C, 128 positions x 64
//     state columns, so that N = 256 fits and N = 32 reads one half-empty
//     slab: columns past N and rows past S come back as zeros). A chunk of
//     two row tiles takes three passes of the slabs, C of row tile 0
//     against B of 0, then C of 1 against B of 1 and of 0 (with N above
//     128, two more passes of B alone come first: the state update's). dt
//     is 4 bytes a head, below TMA's 16-byte box: the producer warp loads it by
//     plain loads a chunk ahead and scans dA = dt * A into the chunk stage
//     (cum, dt, w = exp(cum[Q-1] - cum) * dt, exp(cum)), so no consumer
//     waits on a scan. A view whose rows are only 8-byte aligned, which
//     TMA cannot take, is copied by 8-byte cp.async from the producer's 128
//     threads into the same swizzled layout (each thread waits for its
//     copies and fences them to the async proxy before it arrives). A
//     chunk below 128 positions lands as boxes of Q rows; the tiles' rows
//     past Q, which no box writes, are zeroed once when the block starts.
//     Consumer 1's rows are then zero (or the chunk's past 64), and it
//     stores only those that the chunk has.
//   - Warpgroups 1 and 2 are the consumers (setmaxnreg.inc), rows 0-63 and
//     64-127 of each row tile. Per slab, with both operands read from shared
//     memory through descriptors: S += C B^T on the lower triangle by
//     blocks of 64 (keys 0-63, or 0-127; every key of row tile 0 for rows
//     of row tile 1); and, on the diagonal passes (a row tile's first), y
//     += C h^T from h's bf16 copy and the update of the state h (64 x N,
//     float32 in registers) by the consumer that holds it,
//     h = h exp(cum[Q-1]) + (x w)^T B, with (x w)^T
//     as the register A operand (ldmatrix.trans from the swizzled x tile,
//     scaled by w and rounded to bf16: the decay is folded into x, 64 wide,
//     not into B, N wide) and B MN-major. One slab's products are in
//     flight while the next slab's are issued. Then y = y exp(cum) +
//     bf16(S .* L * dt) x, the masked scores the register A operand and x
//     MN-major. L keeps an exact 0 above the diagonal; below each warp's
//     diagonal 16-row tile it is factored around the tile's first row r0,
//     exp(cum[i] - cum[r0]) * exp(cum[r0] - cum[j]), both at most 1 (no
//     overflow; for row tile 1, every key of row tile 0 lies below), the key
//     factors times dt in the warp's row of shared memory. y goes through a
//     swizzled tile per consumer to a TMA store, which clips rows past S.
//   - The work is split so that the two consumers' is near even: with N up
//     to 128 consumer 0 holds h (at mamba2's shape 4.7 MFLOP a chunk for
//     rows 0-63 and the state update, 4.2 for rows 64-127; at a chunk of
//     256, 12.6 for consumer 0's 64 + 128 + 64 keys a row, two C h^T and the
//     state update over 256 keys, 11.5 for consumer 1's 128 + 128 + 128
//     keys and two C h^T); above 128 the two split h's slabs (one
//     warpgroup's registers do not hold 64 x 256 floats beside the rest).
//     A holder hands its part of h over as soon as it is updated: the bf16
//     copy goes into one of two buffers (by the chunk's parity) behind a
//     full barrier, and the other consumer's empty
//     barrier says when it may be written again. That hand-over is the only
//     wait of one consumer on the other.
//   - No instruction but a wgmma writes an accumulator while products are
//     in flight, which would make ptxas serialize every wgmma: first
//     products overwrite (scale-d 0) instead of zeroed registers, and h's
//     decay is applied by volatile multiplies before a chunk's first issue.
// The roundings to bf16 are three derived operands (S .* L * dt, x * w and
// h's copy); C, B and x are bf16 already, so their products are exact in
// float32, every sum is float32 and h stays float32.
//
// What this does about the mma.sync route it replaced (0.2686 ms at
// mamba2's shape on an H100): the two consumers take the triangle and the
// state update in near-even parts where warp w of 8 took w + 1 tiles;
// every copy is the TMA's (one thread, no address arithmetic), the next
// chunk's tiles landing while this one computes; the dA scan is the
// producer's; the tensor cores read shared memory themselves (only the
// state update's x fragments pass through ldmatrix), with no mma.sync and
// no cp.async on the path's views. Two heads of a group a block, sharing
// C B^T and the B and C loads, measured slower at the paths' shapes (they
// halve the blocks that fill the SMs; PERF.md, section 6), so a block
// walks one head.
//
// float32 (the first design, kept for the 1e-4 parity that rules out TF32):
// ssd_scan_f32_kernel, scalar float32 FMAs from shared memory with
// synchronous loads, h_state in shared memory, one block per SM (174 KB at
// N = 128, 207 KB at 256). It recomputes the full 128 x 128 square of C B^T
// of each pair of row tiles for every head, about 43 GFLOP at the path's
// shape. Per chunk: warp 0 scans dA; then per row tile and per row tile of
// keys up to it, x * dt of the keys is staged; N is walked in tiles of 32,
// the C and B tiles staged, each thread accumulating an 8 x 8 block of C
// B^T and (on the first keys) an 8 x 4 block of C h^T from the same C
// loads, then on the last row tile the tile's h columns take the state
// update; C B^T .* L goes to shared memory, and y = (C B^T .* L)(x * dt) +
// C h^T * exp(dA_cum). Rows of its staged tiles are padded by 4 floats (a
// 256 x 256 score tile would not fit: 266 KB).
//
// No atomics in either route: the result does not change between runs.

#include "hopper.cuh"

namespace {

constexpr int kQ = 128;           // rows of a row tile (a chunk has one or two)
constexpr int kP = 64;            // columns of x a block walks
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

// Rows t0 .. t0 + 127 (zero at or past ``rows``: past S, or past the
// chunk) of columns col0 .. col0 + 31 (zero at or past n) of a (S, n)
// matrix whose rows are row_stride elements apart, into a float32 tile with
// rows kTld floats apart.
__device__ void load_state_tile(const float* __restrict__ base,
                                long long row_stride, int t0, int rows,
                                int col0, int n, float* tile) {
  for (int e = threadIdx.x; e < kQ * (kNT / 4); e += kThreads) {
    const int r = e / (kNT / 4);
    const int c = (e % (kNT / 4)) * 4;
    const float4 v = r < rows && col0 + c < n
                         ? load4(base + (t0 + r) * row_stride + col0 + c)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(tile + r * kTld + c) = v;
  }
}

// kRT: row tiles of 128 a chunk (Q up to 128 kRT); blockIdx.z picks the
// 64 columns of x (and rows of the state) that the block walks
template <int kRT>
__global__ void __launch_bounds__(kThreads, 1)
    ssd_scan_f32_kernel(const float* __restrict__ x,
                        const float* __restrict__ dt,
                        const float* __restrict__ A,
                        const float* __restrict__ Bm,
                        const float* __restrict__ Cm, float* __restrict__ y,
                        float* __restrict__ state_out, int S, int H, int G,
                        int N, int P, int Q, long long x_sb, long long x_ss,
                        long long b_sb, long long b_ss, long long c_sb,
                        long long c_ss) {
  // the state's columns in tiles of kNT (zero past N), its rows padded by 4
  const int n_tiled = (N + kNT - 1) / kNT * kNT;
  const int hld = n_tiled + 4;
  extern __shared__ float4 smem4[];
  float* Ss = reinterpret_cast<float*>(smem4);  // kQ x kSld: (C B^T) .* L
  float* Xs = Ss + kQ * kSld;                   // kQ x kP: x * dt
  float* Bs = Xs + kQ * kP;                     // kQ x kTld
  float* Cs = Bs + kQ * kTld;                   // kQ x kTld
  float* Hs = Cs + kQ * kTld;                   // kP x hld: h_state
  float* cum = Hs + kP * hld;                   // 2 kQ: dA_cum
  float* dts = cum + 2 * kQ;                    // 2 kQ: dt
  float* wdec = dts + 2 * kQ;                   // 2 kQ: exp(cum[Q-1] - cum)

  const int hh = blockIdx.x;
  const int b = blockIdx.y;
  const int p0 = kP * blockIdx.z;  // this block's 64 columns of x and y
  const int grp = hh / (H / G);
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const float a = A[hh];
  constexpr int per = 4 * kRT;  // positions of the scan a lane

  const float* xb = x + b * x_sb + (long long)hh * P + p0;
  const float* dtb = dt + (long long)b * S * H + hh;
  const float* bb = Bm + b * b_sb + (long long)grp * N;
  const float* cb = Cm + b * c_sb + (long long)grp * N;
  float* yb = y + ((long long)b * S * H + hh) * P + p0;
  const int pw = P - p0;  // live columns of this block

  for (int i = tid; i < kP * hld; i += kThreads) Hs[i] = 0.f;

  // chunks of Q positions, each in row tiles of 128: rows past the chunk
  // (or past S) read as zeros with dt = 0
  const int n_chunks = (S + Q - 1) / Q;
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int t0 = ci * Q;
    const int rows = min(Q, S - t0);
    __syncthreads();  // the last chunk's reads of Ss, Xs, cum, dts are done

    // 1. dt and the cumulative sum of dA over the chunk (warp 0)
    if (tid < 32) {
      float v[per];
      float run = 0.f;
#pragma unroll
      for (int k = 0; k < per; ++k) {
        const int t = per * tid + k;
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
      for (int k = 0; k < per; ++k) cum[per * tid + k] = excl + v[k];
    }
    __syncthreads();

    // 2. the state update's weights and the chunk's decay
    const float cum_last = cum[kRT * kQ - 1];
    for (int i = tid; i < kRT * kQ; i += kThreads)
      wdec[i] = expf(cum_last - cum[i]);
    const float chunk_decay = expf(cum_last);

    // 3. row tile by row tile: C B^T against the keys of each row tile up
    // to its own (the lower triangle on the diagonal), C h^T with h as it
    // entered the chunk on the first, and on the last row tile the state
    // update, rows of keys by rows of keys; y after each pass (a row tile's
    // later passes add to the float32 y its first stored)
#pragma unroll
    for (int rh = 0; rh < kRT; ++rh) {
#pragma unroll
      for (int kh = 0; kh <= rh; ++kh) {
        const bool update = rh == kRT - 1;
        // x * dt of the keys' rows
        __syncthreads();  // the last pass's reads of Xs and Ss are done
        for (int e = tid; e < kQ * (kP / 4); e += kThreads) {
          const int r = e / (kP / 4);
          const int c = (e % (kP / 4)) * 4;
          const int t = kh * kQ + r;
          float4 v = t < rows && c < pw ? load4(xb + (t0 + t) * x_ss + c)
                                        : make_float4(0.f, 0.f, 0.f, 0.f);
          const float d = dts[t];
          v.x *= d;
          v.y *= d;
          v.z *= d;
          v.w *= d;
          *reinterpret_cast<float4*>(Xs + r * kP + c) = v;
        }

        float sacc[8][8], yacc[8][4];
#pragma unroll
        for (int r = 0; r < 8; ++r) {
#pragma unroll
          for (int c = 0; c < 8; ++c) sacc[r][c] = 0.f;
#pragma unroll
          for (int c = 0; c < 4; ++c) yacc[r][c] = 0.f;
        }
        for (int n0 = 0; n0 < n_tiled; n0 += kNT) {
          __syncthreads();  // the last tile's reads and h updates are done
          load_state_tile(cb, c_ss, t0 + rh * kQ, rows - rh * kQ, n0, N, Cs);
          load_state_tile(bb, b_ss, t0 + kh * kQ, rows - kh * kQ, n0, N, Bs);
          __syncthreads();
#pragma unroll 2
          for (int d = 0; d < kNT; d += 4) {
            float4 cv[8];
#pragma unroll
            for (int r = 0; r < 8; ++r)
              cv[r] = load4(Cs + (8 * ty + r) * kTld + d);
#pragma unroll
            for (int c = 0; c < 8; ++c) {
              const float4 bv = load4(Bs + (tx + 16 * c) * kTld + d);
#pragma unroll
              for (int r = 0; r < 8; ++r)
                sacc[r][c] = dot4(cv[r], bv, sacc[r][c]);
            }
            if (kh == 0) {
#pragma unroll
              for (int c = 0; c < 4; ++c) {
                const float4 hv = load4(Hs + (tx + 16 * c) * hld + n0 + d);
#pragma unroll
                for (int r = 0; r < 8; ++r)
                  yacc[r][c] = dot4(cv[r], hv, yacc[r][c]);
              }
            }
          }
          if (!update) continue;
          __syncthreads();  // every read of this tile's h columns is done
          {
            const int p = tid / 4;
            const int nn = (tid % 4) * 8;
            float upd[8];
#pragma unroll
            for (int k = 0; k < 8; ++k) upd[k] = 0.f;
#pragma unroll 4
            for (int l = 0; l < kQ; ++l) {
              const float w = Xs[l * kP + p] * wdec[kh * kQ + l];
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
            // the chunk's decay once, on the first pass of keys
            const float decay = kh == 0 ? chunk_decay : 1.f;
            float* hrow = Hs + p * hld + n0 + nn;
#pragma unroll
            for (int k = 0; k < 8; ++k) hrow[k] = hrow[k] * decay + upd[k];
          }
        }

        // 4. C B^T .* L, exactly zero above the diagonal
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const int i = 8 * ty + r;
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            const int j = tx + 16 * c;
            Ss[i * kSld + j] =
                kh < rh || i >= j
                    ? sacc[r][c] * expf(cum[rh * kQ + i] - cum[kh * kQ + j])
                    : 0.f;
          }
        }
        __syncthreads();

        // 5. y = (C B^T .* L)(x * dt) over these keys + C h^T *
        // exp(dA_cum) on the first pass, or + the y of the earlier ones
        const int j_end = kh < rh ? kQ : 8 * ty + 8;  // the last live key
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
          const int gi = rh * kQ + i;
          if (gi < rows) {
            const float decay = expf(cum[gi]);
            float* yrow = yb + (long long)(t0 + gi) * H * P;
#pragma unroll
            for (int c = 0; c < 4; ++c)
              if (tx + 16 * c < pw)
                yrow[tx + 16 * c] = kh == 0
                                        ? acc[c] + yacc[r][c] * decay
                                        : yrow[tx + 16 * c] + acc[c];
          }
        }
      }
    }
  }

  if (state_out != nullptr) {
    __syncthreads();  // the last tile's h updates are done
    float* sb = state_out + (((long long)b * H + hh) * P + p0) * N;
    const int pn = min(kP, pw) * N;
    for (int i = tid; i < pn; i += kThreads)
      sb[i] = Hs[(i / N) * hld + i % N];
  }
}

int launch_f32(const void* x, const float* dt, const float* A, const void* B,
               const void* C, void* y, float* state, int batch, int S, int H,
               int G, int N, int P, int Q, long long x_sb, long long x_ss,
               long long b_sb, long long b_ss, long long c_sb, long long c_ss,
               cudaStream_t stream) {
  const int n_tiled = (N + kNT - 1) / kNT * kNT;
  const int smem = static_cast<int>(
      sizeof(float) * (kQ * kSld + kQ * kP + 2 * kQ * kTld +
                       kP * (n_tiled + 4) + 3 * 2 * kQ));
  auto* kernel = Q > kQ ? ssd_scan_f32_kernel<2> : ssd_scan_f32_kernel<1>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the heads fastest, then the batch rows, then the 64-column parts of p
  const dim3 grid(H, batch, (P + kP - 1) / kP);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(x), dt, A, static_cast<const float*>(B),
      static_cast<const float*>(C), static_cast<float*>(y), state, S, H, G, N,
      P, Q, x_sb, x_ss, b_sb, b_ss, c_sb, c_ss);
  return static_cast<int>(cudaGetLastError());
}


// ---------------------------------------------------------------------------
// bf16 route: wgmma, TMA and mbarrier rings (sm_90a)
// ---------------------------------------------------------------------------

constexpr int kSlab = 64;               // state columns of a slab: 128 bytes
constexpr int kTileBytes = kQ * 128;    // 128 rows of 64 bf16: x, or a B or C slab
constexpr int kHSlabBytes = kP * 128;   // 64 rows of 64 bf16: a slab of h's copy
constexpr int kChunkStages = 2;         // chunks of x and dA in flight
constexpr int kMaxSlabStages = 4;       // B and C slabs in flight, at most
constexpr int kWgThreads = 3 * 128;     // a producer and two consumer warpgroups
// setmaxnreg moves registers within the block's launch share, 168 a thread
// (65,536 / 384, rounded down to 8): the consumers' increase waits for the
// producer's decrease, and never ends if the two do not fit that share
constexpr int kLaunchRegs = 168;
constexpr int kProducerRegs = 72;
constexpr int kConsumerRegs = 216;
static_assert(kProducerRegs + 2 * kConsumerRegs <= 3 * kLaunchRegs,
              "the three warpgroups' registers fit the block's launch share");

// Shared memory of one block, in bytes from a 1024-byte boundary (the 128B
// swizzle's atom): the kRT x tiles of each chunk stage, h's bf16 copies
// (two, by the parity of the chunk that reads them, per slab), each
// consumer's y tile (64 x 64, read by the TMA store), the ring of B and C
// slabs (its depth is picked at launch), then per chunk stage and row tile
// the dA scan's four rows (cum, dt, w, exp(cum)), each consumer warp's key
// factors per row tile of keys, and the mbarriers.
template <int kNS, int kRT>
struct WgSmem {
  static constexpr int kX = 0;
  static constexpr int kH = kX + kChunkStages * kRT * kTileBytes;
  static constexpr int kY = kH + 2 * kNS * kHSlabBytes;
  static constexpr int kSlabs = kY + 2 * kHSlabBytes;
  static constexpr int kScalBytes = kChunkStages * kRT * 4 * kQ * 4;
  static constexpr int kKdBytes = 8 * kRT * kQ * 4;
  static constexpr int kBarBytes =
      8 * (2 * kMaxSlabStages + 2 * kChunkStages + 2 + 4);
  static constexpr int bytes(int slab_stages) {
    return kSlabs + slab_stages * 2 * kTileBytes + kScalBytes + kKdBytes +
           kBarBytes;
  }
};

// What a launch passes besides the tensor maps: the tensors as they lie (for
// the cp.async copies, dt, A and the outputs) and the walk's sizes.
struct SsdArgs {
  const __nv_bfloat16* x;
  const __nv_bfloat16* B;
  const __nv_bfloat16* C;
  const float* dt;
  const float* A;
  __nv_bfloat16* y;
  float* state;
  long long x_sb, x_ss, b_sb, b_ss, c_sb, c_ss;
  int batch, S, H, G, N;
  int P;            // head dim: the x tile's columns past P read as zeros
  int Q;            // chunk: a row tile's rows past Q / kRT read as zeros
  int tma;          // 1: TMA boxes; 0: 8-byte cp.async (views on 8 bytes)
  int slab_stages;  // depth of the B and C ring
};

// One block's shared-memory addresses and walk.
struct WgCtx {
  uint32_t base;   // 1024-byte aligned
  uint8_t* gbase;  // the same, as a generic pointer
  uint32_t hs, ys, slabs, scal, kd, bar;
  int slab_stages, ns, rt;  // ring depth; slabs and row tiles of the instance
  int head, b, grp;
  int p0;       // this block's first column of x, y and the state's rows
  int R;        // positions of a chunk in each row tile: Q / rt
  int n_chunks;
  __device__ uint32_t slab_full(int st) const { return bar + 8 * st; }
  __device__ uint32_t slab_empty(int st) const {
    return bar + 8 * (kMaxSlabStages + st);
  }
  __device__ uint32_t chunk_full(int cs) const {
    return bar + 8 * (2 * kMaxSlabStages + cs);
  }
  __device__ uint32_t chunk_empty(int cs) const {
    return bar + 8 * (2 * kMaxSlabStages + kChunkStages + cs);
  }
  // h's copies of parity q are written, by every warpgroup holding a part
  __device__ uint32_t hfull(int q) const {
    return bar + 8 * (2 * kMaxSlabStages + 2 * kChunkStages + q);
  }
  // consumer c has read the copies of parity q
  __device__ uint32_t hempty(int c, int q) const {
    return bar + 8 * (2 * kMaxSlabStages + 2 * kChunkStages + 2 + 2 * c + q);
  }
  // row tile r of chunk stage cs's x
  __device__ uint32_t xtile(int cs, int r) const {
    return base + (cs * rt + r) * kTileBytes;
  }
  __device__ uint32_t hcopy(int q, int s) const {
    return hs + (q * ns + s) * kHSlabBytes;
  }
  // consumer c's y tile
  __device__ uint32_t ytile(int c) const { return ys + c * kHSlabBytes; }
  __device__ uint32_t cslab(int st) const {
    return slabs + st * 2 * kTileBytes;
  }
  // the scan's rows of row tile r of a chunk stage: cum at 0, dt at kQ, w
  // at 2 kQ, exp(cum) at 3 kQ
  __device__ float* scalars(int cs, int r) const {
    return reinterpret_cast<float*>(gbase + (scal - base)) +
           (cs * rt + r) * 4 * kQ;
  }
  // warp warp8's key factors for the keys of row tile r
  __device__ float* keyf(int warp8, int r) const {
    return reinterpret_cast<float*>(gbase + (kd - base)) +
           (warp8 * rt + r) * kQ;
  }
};

// The block's context, made by each warpgroup after its setmaxnreg, so that
// nothing stays live across the change of register counts.
template <int kNS, int kRT>
__device__ __forceinline__ WgCtx wg_context(const SsdArgs& a) {
  using L = WgSmem<kNS, kRT>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  WgCtx w;
  w.base = (raw + 1023) & ~1023u;
  w.gbase = smem_raw + (w.base - raw);
  w.slab_stages = a.slab_stages;
  w.ns = kNS;
  w.rt = kRT;
  w.hs = w.base + L::kH;
  w.ys = w.base + L::kY;
  w.slabs = w.base + L::kSlabs;
  w.scal = w.slabs + a.slab_stages * 2 * kTileBytes;
  w.kd = w.scal + L::kScalBytes;
  w.bar = w.kd + L::kKdBytes;
  // the heads of one group are consecutive on the grid's fast axis, so
  // that their B and C tiles are read while L2 holds them
  w.head = blockIdx.x;
  w.grp = w.head / (a.H / a.G);
  w.b = blockIdx.y;
  w.p0 = kP * blockIdx.z;
  w.R = a.Q / kRT;
  w.n_chunks = (a.S + a.Q - 1) / a.Q;
  return w;
}

// Which part of the state consumer c holds: the slabs [lo, hi). With N up
// to 128 consumer 0 holds it all (the rows it takes are the lighter half of
// the triangle); above 128 the two split its slabs, as one warpgroup's
// registers do not hold 64 x 256 floats beside the rest.
template <int kNS, int c>
struct Holding {
  static constexpr bool kSplit = kNS > 2;
  static constexpr int lo = kSplit && c == 1 ? kNS / 2 : 0;
  static constexpr int hi = kSplit ? (c == 0 ? kNS / 2 : kNS)
                                   : (c == 0 ? kNS : 0);
  static constexpr int slabs = hi - lo;
  // warpgroups that write h's copies
  static constexpr int writers = kSplit ? 2 : 1;
};

// Where a chunk of two row tiles meets a split state (N above 128), the
// state update takes passes of its own, one per row tile of keys, ahead of
// the products: fused into the diagonal passes it would put a consumer's S
// of 128 keys, y, 64 columns of h and the x fragments in one register set
// (ptxas spills there).
template <int kNS, int kRT>
constexpr bool kSepUpdate = Holding<kNS, 0>::kSplit && kRT == 2;

__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 8 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Rows 0 .. 127 of a (rows, cols) bf16 view whose rows are row_stride
// elements apart into a 128 x 64 tile in the 128B-swizzled layout a TMA box
// lands, by 8-byte cp.async from the 128 threads of a warpgroup; zeros at
// or past ``rows`` and ``cols``.
__device__ __forceinline__ void copy_tile8(uint32_t dst, const __nv_bfloat16* src,
                           long long row_stride, int rows, int cols, int t) {
#pragma unroll 1  // few registers: the producer's are 72
  for (int e = t; e < kQ * 16; e += 128) {
    const int r = e / 16;
    const int q = e % 16;  // the 8-byte piece of the 128-byte row
    const bool ok = r < rows && 4 * q < cols;
    const uint32_t d =
        dst + r * 128 + ((((q / 2) ^ (r & 7)) << 4) | ((q & 1) << 3));
    cp_async8(d, ok ? src + r * row_stride + 4 * q : src, ok);
  }
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// a bf16 pair times two floats, rounded back to a bf16 pair
__device__ __forceinline__ uint32_t scale_bf16(uint32_t u, float2 w) {
  const float2 f =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
  return pack_bf16(f.x * w.x, f.y * w.y);
}

// Chunk ci's dt into 4 kRT positions a lane (zero past the chunk, past S
// and for chunks past the last), by plain loads: one head's dt is 4 bytes
// wide, under TMA's 16-byte box
template <int kRT>
__device__ __forceinline__ void load_dt(float (&d)[4 * kRT], const SsdArgs& a,
                                        const WgCtx& w, int ci, int lane) {
  const int rows = min(a.Q, a.S - ci * a.Q);
  const float* dtb = a.dt + ((long long)w.b * a.S + ci * a.Q) * a.H + w.head;
#pragma unroll
  for (int j = 0; j < 4 * kRT; ++j) {
    const int tt = 4 * kRT * lane + j;
    d[j] = tt < rows ? dtb[(long long)tt * a.H] : 0.f;
  }
}

// The producer warpgroup. With TMA one warp works: lane 0 issues every box,
// the 32 lanes load dt by plain loads and scan dA. With cp.async (a view on
// 8-byte boundaries) all 128 threads copy, then wait for their copies and
// fence them to the async proxy before they arrive. A chunk's B and C slabs
// come once per pass (row tile rh of C against row tile kh <= rh of B), in
// the order the consumers walk them: (0, 0), then (1, 1) and (1, 0).
template <int kNS, int kRT>
__device__ __forceinline__ void ssd_producer(const CUtensorMap* tx,
                                             const CUtensorMap* tb,
                                             const CUtensorMap* tc,
                                             const SsdArgs& a) {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
  constexpr int kPer = 4 * kRT;  // positions of the scan a lane
  const int t = threadIdx.x;
  if (a.tma && t >= 32) return;
  const WgCtx w = wg_context<kNS, kRT>(a);
  const int lane = t % 32;
  const int R = w.R;
  float dn[kPer];  // the next chunk's dt
  if (t < 32) load_dt<kRT>(dn, a, w, 0, lane);
  int slab = 0;
  for (int ci = 0; ci < w.n_chunks; ++ci) {
    const int t0 = ci * a.Q;
    const int cs = ci % kChunkStages;
    mbar_wait(w.chunk_empty(cs), ((ci / kChunkStages) & 1) ^ 1);
    if (a.tma) {
      if (lane == 0) {  // a box of R rows a row tile
        mbar_expect_tx(w.chunk_full(cs), a.Q * 128);
        for (int r = 0; r < kRT; ++r)
          tma_load(w.xtile(cs, r), tx, w.chunk_full(cs), w.p0, w.head,
                   t0 + r * R, w.b);
      }
    } else {
      // each copy from row min(t0 + r R, S - 1), so that no address is
      // formed past the view; rows past S are zeros
      for (int r = 0; r < kRT; ++r)
        copy_tile8(w.xtile(cs, r),
                   a.x + w.b * a.x_sb + min(t0 + r * R, a.S - 1) * a.x_ss +
                       w.head * a.P + w.p0,
                   a.x_ss, min(R, a.S - t0 - r * R), a.P - w.p0, t);
      cp_async_wait_all();
      fence_proxy_async();
    }
    if (t < 32) {
      // dA = dt * A and its inclusive sum over the chunk: kPer positions a
      // lane, then a scan of the lanes' totals; rows past S have dt = 0.
      // The next chunk's dt is loaded now, to land while this one waits.
      float d[kPer];
#pragma unroll
      for (int j = 0; j < kPer; ++j) d[j] = dn[j];
      load_dt<kRT>(dn, a, w, ci + 1, lane);
      const float av = a.A[w.head];
      float v[kPer];
      float run = 0.f;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        run += d[j] * av;
        v[j] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += up;
      }
      const float excl = incl - run;
      const float last = __shfl_sync(0xffffffffu, excl + v[kPer - 1], 31);
      // position tt of the chunk is row tt - r R of row tile r
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int tt = kPer * lane + j;
        if (tt >= a.Q) continue;
        const int r = kRT == 1 ? 0 : tt / R;
        float* sc = w.scalars(cs, r);
        const int i = tt - r * R;
        const float c = excl + v[j];
        sc[i] = c;
        sc[kQ + i] = d[j];
        sc[2 * kQ + i] = expf(last - c) * d[j];
        sc[3 * kQ + i] = expf(c);
      }
      __syncwarp();
      // a row tile's rows past R: its last cum, dt = 0 (no key weight, no
      // state update; every factor of L they enter is at most 1)
      for (int r = 0; r < kRT; ++r) {
        float* sc = w.scalars(cs, r);
        const float c = sc[R - 1];
        for (int i = R + lane; i < kQ; i += 32) {
          sc[i] = c;
          sc[kQ + i] = 0.f;
          sc[2 * kQ + i] = 0.f;
          sc[3 * kQ + i] = expf(c);
        }
      }
    }
    mbar_arrive(w.chunk_full(cs));
    if constexpr (kSepUpdate<kNS, kRT>) {
      // the state update's passes: B of each row tile alone
#pragma unroll 1
      for (int kh = 0; kh < kRT; ++kh)
#pragma unroll 1
        for (int sl = 0; sl < kNS; ++sl, ++slab) {
          const int st = slab % w.slab_stages;
          mbar_wait(w.slab_empty(st), ((slab / w.slab_stages) & 1) ^ 1);
          const uint32_t bdst = w.cslab(st) + kTileBytes;
          if (a.tma) {
            if (lane == 0) {
              mbar_expect_tx(w.slab_full(st), R * 128);
              tma_load(bdst, tb, w.slab_full(st), kSlab * sl, w.grp,
                       t0 + kh * R, w.b);
            }
          } else {
            const long long n0 = (long long)w.grp * a.N + kSlab * sl;
            copy_tile8(bdst,
                       a.B + w.b * a.b_sb +
                           min(t0 + kh * R, a.S - 1) * a.b_ss + n0,
                       a.b_ss, min(R, a.S - t0 - kh * R),
                       min(kSlab, a.N - kSlab * sl), t);
            cp_async_wait_all();
            fence_proxy_async();
            mbar_arrive(w.slab_full(st));
          }
        }
    }
    // the consumers' order: row tile rh against keys rh, then 0 .. rh - 1;
    // not unrolled, which would hoist each copy's addresses past the
    // producer's 72 registers
#pragma unroll 1
    for (int rh = 0; rh < kRT; ++rh)
#pragma unroll 1
      for (int j = 0; j <= rh; ++j)
#pragma unroll 1
        for (int sl = 0, kh = j == 0 ? rh : j - 1; sl < kNS; ++sl, ++slab) {
          const int st = slab % w.slab_stages;
          mbar_wait(w.slab_empty(st), ((slab / w.slab_stages) & 1) ^ 1);
          const uint32_t cdst = w.cslab(st);
          if (a.tma) {
            if (lane == 0) {
              mbar_expect_tx(w.slab_full(st), 2 * R * 128);
              tma_load(cdst, tc, w.slab_full(st), kSlab * sl, w.grp,
                       t0 + rh * R, w.b);
              tma_load(cdst + kTileBytes, tb, w.slab_full(st), kSlab * sl,
                       w.grp, t0 + kh * R, w.b);
            }
          } else {
            const int cols = min(kSlab, a.N - kSlab * sl);
            const long long n0 = (long long)w.grp * a.N + kSlab * sl;
            copy_tile8(cdst,
                       a.C + w.b * a.c_sb +
                           min(t0 + rh * R, a.S - 1) * a.c_ss + n0,
                       a.c_ss, min(R, a.S - t0 - rh * R), cols, t);
            copy_tile8(cdst + kTileBytes,
                       a.B + w.b * a.b_sb +
                           min(t0 + kh * R, a.S - 1) * a.b_ss + n0,
                       a.b_ss, min(R, a.S - t0 - kh * R), cols, t);
            cp_async_wait_all();
            fence_proxy_async();
            mbar_arrive(w.slab_full(st));
          }
        }
  }
}

// (x w)^T for k16 steps kk0 .. kk0 + kSteps - 1 (positions 16 kk .. + 15) as
// the A operand of the state update: this warp's p rows 16 warp .. + 15 by
// ldmatrix.trans from the swizzled x tile, each pair of values scaled by
// its positions' w and rounded to bf16
template <int kSteps>
__device__ __forceinline__ void xw_fragments(uint32_t (&xf)[kSteps][4],
                                             uint32_t xt, const float* wv,
                                             int kk0, int warp, int lane) {
  const int mi = lane / 8;
  const int tq = lane % 4;
#pragma unroll
  for (int j = 0; j < kSteps; ++j) {
    const int kk = kk0 + j;
    const int tt = 16 * kk + (mi / 2) * 8 + lane % 8;
    const int pc = 2 * warp + (mi & 1);
    ldsm_x4_trans(xt + tt * 128 + ((pc ^ (tt & 7)) << 4), xf[j]);
    const float2 wa = *reinterpret_cast<const float2*>(wv + 16 * kk + 2 * tq);
    const float2 wb =
        *reinterpret_cast<const float2*>(wv + 16 * kk + 8 + 2 * tq);
    xf[j][0] = scale_bf16(xf[j][0], wa);
    xf[j][1] = scale_bf16(xf[j][1], wa);
    xf[j][2] = scale_bf16(xf[j][2], wb);
    xf[j][3] = scale_bf16(xf[j][3], wb);
  }
}

// A holder hands its slabs of h over as soon as they are updated: the bf16
// copy for the next chunk's C h^T, once the other consumer has read the
// copy this buffer held.
template <int kNS, int c, int kHS>
__device__ __forceinline__ void hand_over(const WgCtx& w, int ci,
                                          float (&h)[kHS][32], int warp,
                                          int g, int tq) {
  using Hold = Holding<kNS, c>;
  if (ci + 1 < w.n_chunks) {
    const int q = (ci + 1) % 2;
    if (ci >= 2) mbar_wait(w.hempty(1 - c, q), ((ci - 2) / 2) & 1);
    uint8_t* const hb = w.gbase + (w.hcopy(q, 0) - w.base);
#pragma unroll
    for (int sl = Hold::lo; sl < Hold::hi; ++sl)
#pragma unroll
      for (int jn = 0; jn < 8; ++jn)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int p = 16 * warp + g + 8 * r;
          *reinterpret_cast<uint32_t*>(
              hb + sl * kHSlabBytes + p * 128 + ((jn ^ (p & 7)) << 4) +
              tq * 4) = pack_bf16(h[sl - Hold::lo][4 * jn + 2 * r],
                                  h[sl - Hold::lo][4 * jn + 2 * r + 1]);
        }
    fence_proxy_async();
    mbar_arrive(w.hfull(q));
  }
}

// The state update's pass over row tile kh of keys, where it is not fused
// into the products (kSepUpdate): each held slab of h += (x[kh] w)^T
// B[kh], one slab's products in flight while the next slab's are issued.
template <int kNS, int kRT, int c, int kh, int kHS>
__device__ __forceinline__ void ssd_update_pass(const WgCtx& w, int ci,
                                                int cs, int& slab,
                                                float (&h)[kHS][32]) {
  using Hold = Holding<kNS, c>;
  const int t = threadIdx.x % 128;
  const int warp = t / 32;
  const int lane = t % 32;
  uint32_t xf[8][4];
  xw_fragments<8>(xf, w.xtile(cs, kh), w.scalars(cs, kh) + 2 * kQ, 0, warp,
                  lane);
#pragma unroll
  for (int sl = 0; sl < kNS; ++sl, ++slab) {
    const int st = slab % w.slab_stages;
    mbar_wait(w.slab_full(st), (slab / w.slab_stages) & 1);
    const uint32_t bs_s = w.cslab(st) + kTileBytes;
    wgmma_fence();
    if (sl >= Hold::lo && sl < Hold::hi)
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        wgmma_rs_n64(h[sl - Hold::lo], xf[kk],
                     sw128_desc(bs_s + kk * 16 * 128, kTileBytes, 1024));
    wgmma_commit();
    if (sl > 0) {
      wgmma_wait<1>();
      __syncwarp();
      if (lane == 0) mbar_arrive(w.slab_empty((slab - 1) % w.slab_stages));
    }
  }
  wgmma_wait_all();
  __syncwarp();
  if (lane == 0) mbar_arrive(w.slab_empty((slab - 1) % w.slab_stages));
  if constexpr (kh == kRT - 1)
    hand_over<kNS, c>(w, ci, h, warp, (t % 32) / 4, t % 4);
}

// One pass of consumer c over the N slabs, for its rows of row tile rh
// against the keys of row tile kh <= rh: S = C[rh] B[kh]^T (the lower
// triangle where rh == kh, the whole square below it); then y += bf16(S .*
// L * dt) x[kh]. A row tile's first pass is its diagonal one, which also
// takes y = C[rh] h^T (from h's copy, h as it entered the chunk) and the
// held slabs' state update h += (x[kh] w)^T B[kh], one per row tile of
// keys: each pass then holds no more registers than a chunk of one row
// tile's single pass (the square's pass, the widest, updates nothing and
// keeps y live across it).
// ``slab`` counts the ring's slabs.
//
// No instruction but a wgmma writes an accumulator while products are in
// flight (ptxas would then serialize every wgmma of the kernel): the first
// product into an accumulator overwrites it (scale-d 0) instead of a zeroed
// register, and the state's decay is applied by volatile multiplies before
// the chunk's first product is issued.
template <int kNS, int kRT, int c, int rh, int kh, int kHS>
__device__ __forceinline__ void ssd_pass(const WgCtx& w, const SsdArgs& a,
                                         int ci, int cs, int& slab,
                                         float (&y)[32], float (&h)[kHS][32]) {
  using Hold = Holding<kNS, c>;
  constexpr bool kDiag = rh == kh;
  constexpr int kKeys = kDiag ? 64 * (c + 1) : 128;  // keys of these rows
  constexpr bool kUpd = Hold::slabs > 0 && kDiag && !kSepUpdate<kNS, kRT>;
  constexpr bool kChT = kDiag;  // the row tile's first pass
  // The holder's x fragments (32 registers) are built once a pass and kept
  // across its slabs where the accumulators leave room; else they are
  // rebuilt per slab in halves, each waited for.
  constexpr bool kXwOnce = kKeys / 2 + 32 + 32 * Hold::slabs + 32 <= 160;
  const int t = threadIdx.x % 128;
  const int warp = t / 32;
  const int lane = t % 32;
  const int g = lane / 4;    // the accumulator's row within 8
  const int tq = lane % 4;   // the accumulator's column pair
  const int wr = 4 * c + warp;  // this warp's 16-row tile of the row tile
  const int r0 = 16 * wr;
  const int i0 = r0 + g;     // this thread's rows: i0 and i0 + 8
  const int i1 = i0 + 8;
  const uint32_t xt = w.xtile(cs, kh);
  const float* wv = w.scalars(cs, kh) + 2 * kQ;

  float s[kKeys / 2];        // C B^T: these 64 rows x kKeys keys
  uint32_t xf[kUpd && kXwOnce ? 8 : 1][4];
  if constexpr (kUpd && kXwOnce)
    xw_fragments<8>(xf, xt, wv, 0, warp, lane);

  // slab by slab of N, one slab's products in flight while the next slab's
  // are issued
#pragma unroll
  for (int sl = 0; sl < kNS; ++sl, ++slab) {
    const int st = slab % w.slab_stages;
    mbar_wait(w.slab_full(st), (slab / w.slab_stages) & 1);
    const uint32_t cs_s = w.cslab(st);
    const uint32_t bs_s = cs_s + kTileBytes;
    const bool mine = kUpd && sl >= Hold::lo && sl < Hold::hi;
    const int hs = mine ? sl - Hold::lo : 0;
    uint32_t xh[kXwOnce ? 1 : 4][4];
    if constexpr (kUpd && !kXwOnce)
      if (mine)
        xw_fragments<4>(xh, xt, wv, 0, warp, lane);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kSlab / 16; ++ks) {
      const uint64_t dc =
          sw128_desc(cs_s + c * 64 * 128 + ks * 32, 16, 1024);
      const uint64_t db = sw128_desc(bs_s + ks * 32, 16, 1024);
      if constexpr (kKeys == 64)
        wgmma_ss_n64(s, dc, db, sl > 0 || ks > 0);
      else
        wgmma_ss_n128(s, dc, db, sl > 0 || ks > 0);
    }
    if (kChT && ci > 0)
#pragma unroll
      for (int ks = 0; ks < kSlab / 16; ++ks)
        wgmma_ss_n64(y, sw128_desc(cs_s + c * 64 * 128 + ks * 32, 16, 1024),
                     sw128_desc(w.hcopy(ci % 2, sl) + ks * 32, 16, 1024),
                     sl > 0 || ks > 0);
    if constexpr (kUpd) {
      if (mine) {
        if constexpr (kXwOnce) {
#pragma unroll
          for (int kk = 0; kk < 8; ++kk)
            wgmma_rs_n64(h[hs], xf[kk],
                         sw128_desc(bs_s + kk * 16 * 128, kTileBytes, 1024));
        } else {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_rs_n64(h[hs], xh[kk],
                         sw128_desc(bs_s + kk * 16 * 128, kTileBytes, 1024));
        }
      }
    }
    wgmma_commit();
    if constexpr (kUpd && !kXwOnce) {
      if (mine) {
        wgmma_wait_all();
        xw_fragments<4>(xh, xt, wv, 4, warp, lane);
        wgmma_fence();
#pragma unroll
        for (int kk = 4; kk < 8; ++kk)
          wgmma_rs_n64(h[hs], xh[kk - 4],
                       sw128_desc(bs_s + kk * 16 * 128, kTileBytes, 1024));
        wgmma_commit();
      }
    }
    if (sl > 0) {  // the previous slab's products are done: release it
      wgmma_wait<1>();
      __syncwarp();
      if (lane == 0) mbar_arrive(w.slab_empty((slab - 1) % w.slab_stages));
    }
  }
  wgmma_wait_all();
  __syncwarp();
  if (lane == 0) {
    mbar_arrive(w.slab_empty((slab - 1) % w.slab_stages));
    // the last pass that reads h's copies
    if (kChT && rh == kRT - 1 && ci > 0) mbar_arrive(w.hempty(c, ci % 2));
  }
  // the last update hands h over (the last row tile's diagonal pass)
  if constexpr (kUpd && kh == kRT - 1) hand_over<kNS, c>(w, ci, h, warp, g, tq);

  // y = (C h^T) exp(cum) + bf16(C B^T .* L * dt) x, with the rows' factors
  // from row tile rh and the keys' from row tile kh
  const float* sc = w.scalars(cs, rh);
  if (kChT && ci > 0) {
    const float e0 = sc[3 * kQ + i0], e1 = sc[3 * kQ + i1];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      y[4 * n] *= e0;
      y[4 * n + 1] *= e0;
      y[4 * n + 2] *= e1;
      y[4 * n + 3] *= e1;
    }
  }
  const float c0 = sc[i0], c1 = sc[i1];
  const float rf0 = __expf(c0 - sc[r0]), rf1 = __expf(c1 - sc[r0]);
  const float* kd = w.keyf(wr, kh);
  const float* cum = w.scalars(cs, kh);
  const float* dtv = cum + kQ;
  // the masked scores in bf16 as the A operand of the product with x:
  // keys 16 kk .. + 15 are the accumulator's column blocks 2 kk, 2 kk + 1
  uint32_t mf[kKeys / 16][4];
#pragma unroll
  for (int jb = 0; jb < kKeys / 8; ++jb) {
    const int kt = jb / 2;  // the 16-key tile
    const int key = 8 * jb + 2 * tq;
    float v0 = 0.f, v1 = 0.f, v2 = 0.f, v3 = 0.f;
    if (!kDiag || kt < wr) {  // wholly below this warp's diagonal tile
      const float2 f = *reinterpret_cast<const float2*>(kd + key);
      v0 = s[4 * jb] * rf0 * f.x;
      v1 = s[4 * jb + 1] * rf0 * f.y;
      v2 = s[4 * jb + 2] * rf1 * f.x;
      v3 = s[4 * jb + 3] * rf1 * f.y;
    } else if (kt == wr) {  // the diagonal tile: an exact 0 above it
      const float2 cj = *reinterpret_cast<const float2*>(cum + key);
      const float2 dj = *reinterpret_cast<const float2*>(dtv + key);
      if (i0 >= key) v0 = s[4 * jb] * __expf(c0 - cj.x) * dj.x;
      if (i0 >= key + 1) v1 = s[4 * jb + 1] * __expf(c0 - cj.y) * dj.y;
      if (i1 >= key) v2 = s[4 * jb + 2] * __expf(c1 - cj.x) * dj.x;
      if (i1 >= key + 1) v3 = s[4 * jb + 3] * __expf(c1 - cj.y) * dj.y;
    }
    mf[jb / 2][(jb % 2) * 2] = pack_bf16(v0, v1);
    mf[jb / 2][(jb % 2) * 2 + 1] = pack_bf16(v2, v3);
  }
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk)
    wgmma_rs_n64(y, mf[kk], sw128_desc(xt + kk * 16 * 128, kTileBytes, 1024),
                 kk > 0 || ci > 0 || !kChT);
  wgmma_commit();
  wgmma_wait_all();
}

// Row tile rh of chunk ci for consumer c: its warps' key factors, its
// passes (against row tile rh of keys, then those before it), and its y
// rows stored.
template <int kNS, int kRT, int c, int rh, int kHS>
__device__ __forceinline__ void ssd_row_tile(const CUtensorMap* ty,
                                             const WgCtx& w, const SsdArgs& a,
                                             int ci, int cs, int& slab,
                                             float (&y)[32],
                                             float (&h)[kHS][32]) {
  const int t = threadIdx.x % 128;
  const int warp = t / 32;
  const int lane = t % 32;
  const int g = lane / 4;
  const int tq = lane % 4;
  const int wr = 4 * c + warp;
  const int r0 = 16 * wr;
  // L below this warp's diagonal 16-row tile, factored around its first
  // row: exp(cum[i] - cum[j]) = exp(cum[i] - cum[r0]) exp(cum[r0] - cum[j]),
  // both at most 1; the key factors times dt in this warp's own rows, for
  // its own row tile's keys below r0 and every key of the tiles before
  {
    const float* sc = w.scalars(cs, rh);
    float* kd = w.keyf(wr, rh);
    const float cr = sc[r0];
    for (int j = lane; j < r0; j += 32)
      kd[j] = __expf(cr - sc[j]) * sc[kQ + j];
    if constexpr (rh > 0) {
      const float* sp = w.scalars(cs, 0);
      float* kp = w.keyf(wr, 0);
      for (int j = lane; j < kQ; j += 32)
        kp[j] = __expf(cr - sp[j]) * sp[kQ + j];
    }
  }
  __syncwarp();
  ssd_pass<kNS, kRT, c, rh, rh>(w, a, ci, cs, slab, y, h);
  if constexpr (rh == 1) ssd_pass<kNS, kRT, c, 1, 0>(w, a, ci, cs, slab, y, h);
  if (rh == kRT - 1) {  // the chunk's x tiles and scalars are read
    __syncwarp();
    if (lane == 0) mbar_arrive(w.chunk_empty(cs));
  }

  // y of this warpgroup's rows in bf16 into its tile (the 128B-swizzled
  // layout the TMA store reads), once the last store has read it; the TMA
  // store clips rows past S and columns past P
  if (t == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");
  {
    uint8_t* const yt = w.gbase + (w.ytile(c) - w.base);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = 16 * warp + g + 8 * r;
        *reinterpret_cast<uint32_t*>(yt + row * 128 +
                                     ((n ^ (row & 7)) << 4) + tq * 4) =
            pack_bf16(y[4 * n + 2 * r], y[4 * n + 2 * r + 1]);
      }
  }
  fence_proxy_async();
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");
  const int row0 = ci * a.Q + rh * w.R + 64 * c;
  if (t == 0 && 64 * c < w.R && row0 < a.S) {
    tma_store(ty, w.ytile(c), w.p0, w.head, row0, w.b);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  }
}

// A consumer warpgroup: rows 64 c .. 64 c + 63 of each row tile of each
// chunk, and the part of the state that Holding gives it.
template <int kNS, int kRT, int c>
__device__ __forceinline__ void ssd_consumer(const CUtensorMap* ty,
                                             const SsdArgs& a) {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  using Hold = Holding<kNS, c>;
  constexpr bool kHolds = Hold::slabs > 0;
  constexpr int kHS = kHolds ? Hold::slabs : 1;
  const WgCtx w = wg_context<kNS, kRT>(a);
  const int t = threadIdx.x % 128;
  const int warp = t / 32;
  const int lane = t % 32;
  const int g = lane / 4;
  const int tq = lane % 4;

  float y[32];        // y: 64 rows x 64
  float h[kHS][32];   // the held slabs of h, 64 x 64
#pragma unroll
  for (int sl = 0; sl < kHS; ++sl)
#pragma unroll
    for (int e = 0; e < 32; ++e) h[sl][e] = 0.f;

  int slab = 0;
  for (int ci = 0; ci < w.n_chunks; ++ci) {
    const int cs = ci % kChunkStages;
    mbar_wait(w.chunk_full(cs), (ci / kChunkStages) & 1);
    if constexpr (kHolds) {
      // exp(cum[Q-1]): the last row tile's last row
      const float decay = w.scalars(cs, kRT - 1)[4 * kQ - 1];
#pragma unroll
      for (int sl = 0; sl < Hold::slabs; ++sl)
#pragma unroll
        for (int e = 0; e < 32; ++e)
          asm volatile("mul.f32 %0, %0, %1;\n" : "+f"(h[sl][e]) : "f"(decay));
    }
    if constexpr (kSepUpdate<kNS, kRT>) {
      ssd_update_pass<kNS, kRT, c, 0>(w, ci, cs, slab, h);
      ssd_update_pass<kNS, kRT, c, 1>(w, ci, cs, slab, h);
    }
    if (ci > 0)  // the holders' copies of h for this chunk's C h^T
      mbar_wait(w.hfull(ci % 2), ((ci - 1) / 2) & 1);
    ssd_row_tile<kNS, kRT, c, 0>(ty, w, a, ci, cs, slab, y, h);
    if constexpr (kRT == 2)
      ssd_row_tile<kNS, kRT, c, 1>(ty, w, a, ci, cs, slab, y, h);
  }
  if (t == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");

  if constexpr (kHolds) {
    if (a.state != nullptr) {
      float* sb = a.state + ((long long)w.b * a.H + w.head) * a.P * a.N;
#pragma unroll
      for (int sl = Hold::lo; sl < Hold::hi; ++sl)
#pragma unroll
        for (int jn = 0; jn < 8; ++jn) {
          const int n = kSlab * sl + 8 * jn + 2 * tq;
          if (n >= a.N) continue;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int p = w.p0 + 16 * warp + g + 8 * r;
            if (p >= a.P) continue;
            *reinterpret_cast<float2*>(sb + (long long)p * a.N + n) =
                make_float2(h[sl - Hold::lo][4 * jn + 2 * r],
                            h[sl - Hold::lo][4 * jn + 2 * r + 1]);
          }
        }
    }
  }
}

// kNS: slabs of 64 state columns (N up to 64 kNS, the last slab zero past
// N); kRT: row tiles of 128 a chunk (Q up to 128 kRT). blockIdx.z picks the
// 64 columns of x (and rows of the state) that the block walks.
template <int kNS, int kRT>
__global__ void __launch_bounds__(kWgThreads, 1)
    ssd_scan_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                          const __grid_constant__ CUtensorMap tb,
                          const __grid_constant__ CUtensorMap tc,
                          const __grid_constant__ CUtensorMap ty0,
                          const __grid_constant__ CUtensorMap ty1,
                          const SsdArgs a) {
  if (a.tma && a.Q < kRT * kQ) {
    // a row tile of fewer than 128 positions lands as a box of R rows; the
    // rows past it, which no box writes, are zeros for the whole walk (dt
    // = 0 alone would not do: 0 x NaN is NaN)
    const WgCtx w = wg_context<kNS, kRT>(a);
    const int n16 = kChunkStages * kRT * kTileBytes / 16;
    const int s16 = a.slab_stages * 2 * kTileBytes / 16;
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    for (int i = threadIdx.x; i < n16; i += kWgThreads)
      reinterpret_cast<uint4*>(w.gbase)[i] = zero;
    for (int i = threadIdx.x; i < s16; i += kWgThreads)
      reinterpret_cast<uint4*>(w.gbase + (w.slabs - w.base))[i] = zero;
    fence_proxy_async();
  }
  if (threadIdx.x == 0) {
    const WgCtx w = wg_context<kNS, kRT>(a);
    const int copy_arrivals = a.tma ? 1 : 128;
    for (int st = 0; st < a.slab_stages; ++st) {
      mbar_init(w.slab_full(st), copy_arrivals);
      mbar_init(w.slab_empty(st), 8);  // lane 0 of each consumer warp
    }
    for (int cs = 0; cs < kChunkStages; ++cs) {
      // TMA: lane 0's expect_tx and the 32 scan lanes; cp.async: the 128
      // copying threads (the scan lanes among them)
      mbar_init(w.chunk_full(cs), a.tma ? 33 : 128);
      mbar_init(w.chunk_empty(cs), 8);
    }
    for (int q = 0; q < 2; ++q) {
      // every thread of each warpgroup that writes a part of h
      mbar_init(w.hfull(q), 128 * Holding<kNS, 0>::writers);
      for (int c = 0; c < 2; ++c) mbar_init(w.hempty(c, q), 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0)
    ssd_producer<kNS, kRT>(&tx, &tb, &tc, a);
  else if (wg == 1)
    ssd_consumer<kNS, kRT, 0>(&ty0, a);
  else
    ssd_consumer<kNS, kRT, 1>(&ty1, a);
}

template <int kNS, int kRT>
int launch_wgmma(SsdArgs a, cudaStream_t stream) {
  using L = WgSmem<kNS, kRT>;
  CUtensorMap tx{}, tb{}, tc{}, ty0{}, ty1{};
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const int R = a.Q / kRT;  // positions of a chunk in each row tile
  const cuuint64_t P = static_cast<cuuint64_t>(a.P);
  const cuuint64_t xd[4] = {P, static_cast<cuuint64_t>(a.H),
                            static_cast<cuuint64_t>(a.S),
                            static_cast<cuuint64_t>(a.batch)};
  // y (contiguous) in boxes of (64, 1 head, rows, 1): consumer c's rows of
  // a row tile, 64 or what the tile has past 64 c (consumer 1 stores
  // nothing for a tile of 64 or fewer); columns past P and rows past S are
  // not written
  const cuuint64_t ys[3] = {2ull * P, 2ull * P * a.H, 2ull * P * a.H * a.S};
  const cuuint32_t ybox0[4] = {kP, 1,
                               static_cast<cuuint32_t>(R < 64 ? R : 64), 1};
  const cuuint32_t ybox1[4] = {kP, 1,
                               static_cast<cuuint32_t>(R > 64 ? R - 64 : 64),
                               1};
  if (!bf16_map_4d(enc, &ty0, a.y, xd, ys, ybox0) ||
      !bf16_map_4d(enc, &ty1, a.y, xd, ys, ybox1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.tma) {
    // (P, H, S, batch) boxes of x and (N, G, S, batch) boxes of B and C,
    // each 64 wide by R positions: columns past P or N and rows past S
    // come back as zeros
    const cuuint32_t box[4] = {kSlab, 1, static_cast<cuuint32_t>(R), 1};
    const cuuint64_t nd[4] = {static_cast<cuuint64_t>(a.N),
                              static_cast<cuuint64_t>(a.G),
                              static_cast<cuuint64_t>(a.S),
                              static_cast<cuuint64_t>(a.batch)};
    const cuuint64_t xs[3] = {2ull * P, 2ull * a.x_ss, 2ull * a.x_sb};
    const cuuint64_t bs[3] = {2ull * a.N, 2ull * a.b_ss, 2ull * a.b_sb};
    const cuuint64_t cs[3] = {2ull * a.N, 2ull * a.c_ss, 2ull * a.c_sb};
    if (!bf16_map_4d(enc, &tx, a.x, xd, xs, box) ||
        !bf16_map_4d(enc, &tb, a.B, nd, bs, box) ||
        !bf16_map_4d(enc, &tc, a.C, nd, cs, box))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  // the deepest ring of B and C slabs that fits beside the rest
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int fit = (optin - 1024 - L::bytes(0)) / (2 * kTileBytes);
  a.slab_stages = fit < kMaxSlabStages ? fit : kMaxSlabStages;
  if (a.slab_stages < 2) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = L::bytes(a.slab_stages) + 1024;  // + room to align
  err = cudaFuncSetAttribute(ssd_scan_wgmma_kernel<kNS, kRT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the heads fastest, then the batch rows, then the 64-column parts of p
  const dim3 grid(a.H, a.batch, (a.P + kP - 1) / kP);
  ssd_scan_wgmma_kernel<kNS, kRT><<<grid, kWgThreads, smem, stream>>>(
      tx, tb, tc, ty0, ty1, a);
  return static_cast<int>(cudaGetLastError());
}

template <int kRT>
int launch_bf16_rt(SsdArgs a, cudaStream_t stream) {
  const int ns = (a.N + kSlab - 1) / kSlab;
  if (ns == 1) return launch_wgmma<1, kRT>(a, stream);
  if (ns == 2) return launch_wgmma<2, kRT>(a, stream);
  if (ns == 3) return launch_wgmma<3, kRT>(a, stream);
  return launch_wgmma<4, kRT>(a, stream);
}

int launch_bf16(SsdArgs a, cudaStream_t stream) {
  return a.Q > kQ ? launch_bf16_rt<2>(a, stream)
                  : launch_bf16_rt<1>(a, stream);
}

}  // namespace

// One launch on ``stream``. dtype 0 is float32 (the scalar route), 1 is bf16
// (x, B, C and y; the tensor-core route); ``state`` may be null (the final
// state is then not written). Strides are in elements. Returns the
// cudaError_t of the launch (0 on success), and cudaErrorInvalidValue for a
// head dim P or state dim N that is not a multiple of 8 up to 128 and 256,
// a chunk Q that is not a multiple of 16 up to 256, groups that do not
// divide the heads, or another dtype.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A,
                               const void* B, const void* C, void* y,
                               void* state, int batch, int S, int H, int G,
                               int N, int P, int Q, long long x_sb,
                               long long x_ss, long long b_sb, long long b_ss,
                               long long c_sb, long long c_ss, int dtype,
                               void* stream) {
  if (N % 8 != 0 || N > 256 || N < 8 || P % 8 != 0 || P > 2 * kP ||
      P < 8 || Q % 16 != 0 || Q > 2 * kQ || Q < 16 || G < 1 || H % G != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  float* sf = static_cast<float*>(state);
  if (dtype == 0)
    return launch_f32(x, dtf, Af, B, C, y, sf, batch, S, H, G, N, P, Q, x_sb,
                      x_ss, b_sb, b_ss, c_sb, c_ss, st);
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  SsdArgs a{static_cast<const __nv_bfloat16*>(x),
            static_cast<const __nv_bfloat16*>(B),
            static_cast<const __nv_bfloat16*>(C),
            dtf, Af, static_cast<__nv_bfloat16*>(y), sf,
            x_sb, x_ss, b_sb, b_ss, c_sb, c_ss, batch, S, H, G, N, P, Q, 0, 0};
  // TMA where every row start is on a 16-byte boundary; else cp.async
  a.tma = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(B) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(C) % 16 == 0 && x_sb % 8 == 0 &&
          x_ss % 8 == 0 && b_sb % 8 == 0 && b_ss % 8 == 0 && c_sb % 8 == 0 &&
          c_ss % 8 == 0;
  return launch_bf16(a, st);
}
