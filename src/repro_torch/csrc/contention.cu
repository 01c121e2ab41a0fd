// Batched contention solve for Hopper (sm_90a).
//
// Replaces the Pallas kernel _contention_kernel of
// src/repro/kernels/contention/kernel.py (wrapper contention_rates_pallas,
// jitted in ops.py::contention_rates), with the env axis written out.
//
// Per env e and substep s, F flows share L links (3 stages each):
//   eff[f,l,c]  = threads[e,f,c] * act[e,s,f] * onpath[e,s,f,l]
//   total[l,c]  = max(sum_f eff, 1e-9);  share = eff / total
// without objectives:
//   link_rate   = min(eff * tpt[l,c], share * bw[l,c])
// with per-flow floor/cap:
//   demand      = min(eff * tpt, cap[f]);  g = min(floor[f], demand)
//   g          *= min(1, bw / max(sum_f g, 1e-9))          (scaled floors)
//   residual    = max(bw - sum_f g, 0);  alloc = share * residual
//   headroom    = cap[f] - g             (inf when the flow is uncapped)
//   rounds x:   spill = sum_f max(alloc - headroom, 0)
//               alloc = min(alloc, headroom)
//               w = eff if alloc < headroom else 0;  wt = max(sum_f w, 1e-9)
//               alloc += (w / wt) * spill
//   (rounds > 0) alloc = min(alloc, headroom)
//   link_rate   = min(demand, g + alloc)
// then rate[f,c] = min over the flow's on-path links of link_rate (an
// off-path link is +inf), 0 for a flow with no path, times act[e,s,f].
// The operations are those of contention/ref.py in the same order. Every
// product that feeds a sum or difference is formed with __fmul_rn/__fadd_rn
// so nvcc cannot contract it into an FMA; the sums over flows are taken in
// another order than the plain version's, so the two agree to float32
// reassociation noise (2e-5 at rates of order 1), not bitwise.
//
// Infinities are data: an uncapped flow has cap = +inf (headroom = +inf),
// an off-path link is masked with +inf before the min over links, and a
// padded flow is simply inactive. The inputs are finite or +-inf, never
// NaN, so fminf/fmaxf (which drop a NaN operand where jnp.minimum would
// propagate it) give the reference's results. Build without fast-math.
//
// Design. One block per (env, substep), 32 to 256 threads (one warp per
// 32 flows, at most 8 warps); each thread walks its flows f = tid,
// tid + blockDim, ... in increasing order. Every sum over flows is a
// block reduction in a fixed order and without atomics: each thread adds
// its flows in order, a warp folds its 32 partial sums with xor shuffles
// (every lane ends with the same value), and each thread then adds the
// warps' partials from shared memory in warp order. The result is the same
// in every thread and from run to run. Per-flow values are recomputed from
// the inputs in each pass (they stay in L1/L2), so rounds = 0 needs no
// scratch; with rounds > 0 each flow's alloc lives in a global workspace
// the wrapper allocates, read and written only by the thread that owns the
// flow. The link count is a template bound (1 for the fleet, 8 for
// topologies); the wrapper refuses more links than the bound.
//
// What bounds it (chip_smoke.py computes the numbers): the bytes of one
// read of every input and one write of the output over 3.35 TB/s, or the
// dependent chain of the block reductions (about log2(F) dependent adds
// per sum, 1 sum deep without objectives, 2 + rounds with them). At the
// fleet's shapes (F = 4 to 4096) the work is a few microseconds or less
// either way, so the launch itself dominates; making it fast (several
// substeps per block, wider rows) is later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxWarps = kMaxThreads / 32;

// Sum v[0..N) over the block: in-thread partials -> xor-shuffle tree in
// each warp -> warp partials added in warp order. Every thread returns the
// same sums. ``scratch`` holds kMaxWarps * N floats.
template <int N>
__device__ void block_sum(float (&v)[N], float* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      v[i] = __fadd_rn(v[i], __shfl_xor_sync(0xffffffffu, v[i], off));
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) scratch[warp * N + i] = v[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float s = 0.f;
    for (int w = 0; w < n_warps; ++w) s = __fadd_rn(s, scratch[w * N + i]);
    v[i] = s;
  }
  __syncthreads();  // the scratch is reused by the next reduction
}

struct Args {
  const float* threads;  // (E, F, 3)
  const float* act;      // (E, S, F)
  const float* onpath;   // (E, S, F, L)
  const float* tpt;      // (E, S, L, 3)
  const float* bw;       // (E, S, L, 3)
  const float* floor;    // (E, F) or null
  const float* cap;      // (E, F) or null
  float* out;            // (E, S, F, 3)
  float* alloc;          // (E, S, F, L, 3) workspace, rounds > 0 only
  int E, S, F, L, rounds;
};

template <int MAXL, bool OBJ>
__global__ void __launch_bounds__(kMaxThreads)
contention_kernel(Args a) {
  constexpr int N = 3 * MAXL;
  __shared__ float scratch[kMaxWarps * 2 * N];
  const int e = blockIdx.x / a.S;
  const int s = blockIdx.x % a.S;
  const int L = a.L;
  const long long es = static_cast<long long>(e) * a.S + s;
  const float* thr = a.threads + static_cast<long long>(e) * a.F * 3;
  const float* act = a.act + es * a.F;
  const float* onp = a.onpath + es * a.F * L;
  float* out = a.out + es * a.F * 3;
  float* ws = a.alloc ? a.alloc + es * a.F * L * 3 : nullptr;

  float tpt[N], bw[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const bool on = j < 3 * L;
    tpt[j] = on ? a.tpt[es * L * 3 + j] : 0.f;
    bw[j] = on ? a.bw[es * L * 3 + j] : 0.f;
  }

  // eff of flow f on link l, stage c
#define EFF(f, l, c) \
  __fmul_rn(__fmul_rn(thr[3 * (f) + (c)], act[f]), onp[(f) * L + (l)])

  // pass 1: sum eff (and, with objectives, the unscaled guaranteed)
  float tot[N], gtot[N];
#pragma unroll
  for (int j = 0; j < N; ++j) tot[j] = gtot[j] = 0.f;
  for (int f = threadIdx.x; f < a.F; f += blockDim.x) {
    const float fl = OBJ ? a.floor[static_cast<long long>(e) * a.F + f] : 0.f;
    const float cp = OBJ ? a.cap[static_cast<long long>(e) * a.F + f] : 0.f;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      if (j < 3 * L) {
        const float x = EFF(f, j / 3, j % 3);
        tot[j] = __fadd_rn(tot[j], x);
        if (OBJ) {
          const float demand = fminf(__fmul_rn(x, tpt[j]), cp);
          gtot[j] = __fadd_rn(gtot[j], fminf(fl, demand));
        }
      }
    }
  }
  if (OBJ) {
    float both[2 * N];
#pragma unroll
    for (int j = 0; j < N; ++j) { both[j] = tot[j]; both[N + j] = gtot[j]; }
    block_sum<2 * N>(both, scratch);
#pragma unroll
    for (int j = 0; j < N; ++j) { tot[j] = both[j]; gtot[j] = both[N + j]; }
  } else {
    block_sum<N>(tot, scratch);
  }
#pragma unroll
  for (int j = 0; j < N; ++j) tot[j] = fmaxf(tot[j], 1e-9f);

  float scale[N], resid[N];
  if (OBJ) {
    // pass 2: sum of the scaled floors -> the residual capacity
    float g2[N];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      scale[j] = fminf(1.f, bw[j] / fmaxf(gtot[j], 1e-9f));
      g2[j] = 0.f;
    }
    for (int f = threadIdx.x; f < a.F; f += blockDim.x) {
      const float fl = a.floor[static_cast<long long>(e) * a.F + f];
      const float cp = a.cap[static_cast<long long>(e) * a.F + f];
#pragma unroll
      for (int j = 0; j < N; ++j) {
        if (j < 3 * L) {
          const float x = EFF(f, j / 3, j % 3);
          const float demand = fminf(__fmul_rn(x, tpt[j]), cp);
          g2[j] = __fadd_rn(g2[j], __fmul_rn(fminf(fl, demand), scale[j]));
        }
      }
    }
    block_sum<N>(g2, scratch);
#pragma unroll
    for (int j = 0; j < N; ++j) resid[j] = fmaxf(__fsub_rn(bw[j], g2[j]), 0.f);

    // water-fill rounds on the workspace
    if (a.rounds > 0) {
      for (int f = threadIdx.x; f < a.F; f += blockDim.x) {
#pragma unroll
        for (int j = 0; j < N; ++j) {
          if (j < 3 * L) {
            const float share = EFF(f, j / 3, j % 3) / tot[j];
            ws[f * L * 3 + j] = __fmul_rn(share, resid[j]);
          }
        }
      }
    }
    for (int r = 0; r < a.rounds; ++r) {
      float sw[2 * N];  // spill, then sum w
#pragma unroll
      for (int j = 0; j < 2 * N; ++j) sw[j] = 0.f;
      for (int f = threadIdx.x; f < a.F; f += blockDim.x) {
        const float fl = a.floor[static_cast<long long>(e) * a.F + f];
        const float cp = a.cap[static_cast<long long>(e) * a.F + f];
#pragma unroll
        for (int j = 0; j < N; ++j) {
          if (j < 3 * L) {
            const float x = EFF(f, j / 3, j % 3);
            const float demand = fminf(__fmul_rn(x, tpt[j]), cp);
            const float g = __fmul_rn(fminf(fl, demand), scale[j]);
            const float head = __fsub_rn(cp, g);
            const float al = ws[f * L * 3 + j];
            sw[j] = __fadd_rn(sw[j], fmaxf(__fsub_rn(al, head), 0.f));
            const float clipped = fminf(al, head);
            sw[N + j] = __fadd_rn(sw[N + j], clipped < head ? x : 0.f);
          }
        }
      }
      block_sum<2 * N>(sw, scratch);
      for (int f = threadIdx.x; f < a.F; f += blockDim.x) {
        const float fl = a.floor[static_cast<long long>(e) * a.F + f];
        const float cp = a.cap[static_cast<long long>(e) * a.F + f];
#pragma unroll
        for (int j = 0; j < N; ++j) {
          if (j < 3 * L) {
            const float x = EFF(f, j / 3, j % 3);
            const float demand = fminf(__fmul_rn(x, tpt[j]), cp);
            const float g = __fmul_rn(fminf(fl, demand), scale[j]);
            const float head = __fsub_rn(cp, g);
            const float clipped = fminf(ws[f * L * 3 + j], head);
            const float w = clipped < head ? x : 0.f;
            const float wt = fmaxf(sw[N + j], 1e-9f);
            ws[f * L * 3 + j] =
                __fadd_rn(clipped, __fmul_rn(w / wt, sw[j]));
          }
        }
      }
    }
  }

  // final pass: per-link rate, min over the on-path links, masks
  for (int f = threadIdx.x; f < a.F; f += blockDim.x) {
    const float fl = OBJ ? a.floor[static_cast<long long>(e) * a.F + f] : 0.f;
    const float cp = OBJ ? a.cap[static_cast<long long>(e) * a.F + f] : 0.f;
    float rate[3] = {INFINITY, INFINITY, INFINITY};
    float path = 0.f;
#pragma unroll
    for (int l = 0; l < MAXL; ++l) {
      if (l < L) {
        const float on = onp[f * L + l];
        path = __fadd_rn(path, on);
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const int j = 3 * l + c;
          const float x = EFF(f, l, c);
          const float share = x / tot[j];
          float link;
          if (OBJ) {
            const float demand = fminf(__fmul_rn(x, tpt[j]), cp);
            const float g = __fmul_rn(fminf(fl, demand), scale[j]);
            float al;
            if (a.rounds > 0) {
              al = fminf(ws[f * L * 3 + j], __fsub_rn(cp, g));
            } else {
              al = __fmul_rn(share, resid[j]);
            }
            link = fminf(demand, __fadd_rn(g, al));
          } else {
            link = fminf(__fmul_rn(x, tpt[j]), __fmul_rn(share, bw[j]));
          }
          if (on > 0.f) rate[c] = fminf(rate[c], link);
        }
      }
    }
    const float af = act[f];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      out[3 * f + c] = __fmul_rn(path > 0.f ? rate[c] : 0.f, af);
    }
  }
#undef EFF
}

template <int MAXL, bool OBJ>
int launch(const Args& a, cudaStream_t stream) {
  int threads = ((a.F + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  contention_kernel<MAXL, OBJ><<<a.E * a.S, threads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry, bound with ctypes. Every pointer is a device pointer of a
// contiguous float32 tensor; floor and cap are both null (no objectives)
// or both set; alloc is a workspace of E*S*F*L*3 floats when rounds > 0
// and objectives are set, else null. The launch goes on ``stream`` and
// does not synchronise. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for shapes the kernel does not take.
extern "C" int contention_max_links() { return 8; }

extern "C" int contention_launch(const void* threads, const void* act,
                                 const void* onpath, const void* tpt,
                                 const void* bw, const void* floor,
                                 const void* cap, void* out, void* alloc,
                                 int E, int S, int F, int L, int rounds,
                                 void* stream) {
  if (E <= 0 || S <= 0 || F <= 0) return static_cast<int>(cudaSuccess);
  if (L < 1 || L > 8 || rounds < 0 || (floor == nullptr) != (cap == nullptr)
      || (floor != nullptr && rounds > 0 && alloc == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{static_cast<const float*>(threads), static_cast<const float*>(act),
         static_cast<const float*>(onpath), static_cast<const float*>(tpt),
         static_cast<const float*>(bw), static_cast<const float*>(floor),
         static_cast<const float*>(cap), static_cast<float*>(out),
         static_cast<float*>(alloc), E, S, F, L, rounds};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool obj = floor != nullptr;
  if (!obj) a.rounds = 0;  // the water-fill only moves capped allocations
  if (L == 1) {
    return obj ? launch<1, true>(a, st) : launch<1, false>(a, st);
  }
  return obj ? launch<8, true>(a, st) : launch<8, false>(a, st);
}
