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
// another order than the plain version's (below), so the two agree to
// float32 reassociation noise (2e-5 at rates of order 1), not bitwise.
// tests/test_torch_contention_order.py emulates this order on the CPU.
//
// Infinities are data: an uncapped flow has cap = +inf (headroom = +inf),
// an off-path link is masked with +inf before the min over links, and a
// padded flow is simply inactive. The inputs are finite or +-inf, never
// NaN, so fminf/fmaxf (which drop a NaN operand where jnp.minimum would
// propagate it) give the reference's results. Build without fast-math.
//
// What bounds it (chip_smoke.py computes the numbers): the bytes of one
// read of every input and one write of the output over 3.35 TB/s, or the
// dependent chain of the sums over flows (about log2(F) dependent adds per
// sum, 1 sum deep without objectives, 2 + rounds with them).
//
// Design. The first design ran one block of at least 32 threads per (env,
// substep): at the fleet's F=4 only 4 lanes were live, every sum took two
// __syncthreads, every pass re-read the inputs and recomputed eff, demand
// and g, and with rounds > 0 each flow's alloc went through a global
// workspace in every round (96 us at 3 links and 8 rounds). Now:
//   - Each thread reads its flows' threads, act, onpath, floor and cap
//     once. eff, g and alloc stay in registers through every sum and every
//     water-fill round; demand and headroom are one or two operations from
//     them and are formed where used, which keeps the 8-link instance's
//     per-flow state at 72 registers. There is no workspace.
//   - The link count is a template (L = 1, 2, 3, 4, 8; 5 to 7 run the 8
//     instance with the missing links off-path), so 3 links carry 9
//     stage-link slots, not 24.
//   - F <= 32 (contention_kernel_group): G = the next power of two >= F
//     lanes serve one (env, substep), 32 / G pairs a warp (8 at the fleet's
//     F=4), 128 threads a block. A sum over flows is a butterfly of xor
//     shuffles of width G: no shared memory, no barrier, and every lane of
//     the group ends with the same bits.
//   - F > 32 (contention_kernel_block): one cluster of CL blocks of T
//     threads per (env, substep); flows are striped over the CL * T
//     threads, flow f = t + k * CL * T owned by thread t of the cluster
//     (k < kFlows). A sum is fixed in order and has no atomics: each thread
//     adds its flows in k order, a warp folds its lanes with an xor
//     butterfly, every warp folds the block's warp totals from shared
//     memory with the same butterfly (a serial walk over 32 warps cost as
//     much as the rest of the solve), and with CL > 1 every thread adds the
//     blocks' totals in rank order, read through distributed shared memory
//     (map_shared_rank after cluster.sync()). Two scratch buffers
//     alternate, so one barrier per sum (two with a cluster) suffices.
//     T is the instance's block size (BlockShape) or F rounded up to a
//     warp, and CL the smallest power of two up to 8 for which CL * T
//     threads hold F flows on chip. So the cluster only extends how many
//     flows fit: at the scale-out's F=4096 one block of 1024 threads holds
//     them, 4 a thread. Spreading that shape over more blocks did not pay:
//     in a trial on the card clusters of 2 ran no faster and clusters of 4
//     slower, since a 1024-thread block takes a whole SM's registers and
//     200 of them need two waves on 132 SMs (PERF.md §6).
//   - More flows than a cluster of 8 holds on chip (8 * T * kFlows: 16384
//     at 1 link, 8192 at 2, 4096 at 3, 2048 at 4 and 8 links;
//     contention_kernel_stream): the cluster of 8, each thread walking its
//     flows in a loop and recomputing their values in every pass from the
//     inputs and the per-slot values of the sums, held in shared memory.
//     The sums are taken in the same order. No per-flow value outlives a
//     pass, so the water-fill carries no alloc: it carries per slot the
//     prefix Q_r = sum over rounds i <= r of spill_i / wt_i. A flow's
//     alloc after round r is a0 + eff * Q_r (the reference's per-round
//     adds, reassociated) until the first round it reaches its headroom;
//     from then on it sits at the headroom, spills nothing and gets
//     nothing. So round r needs only Q_{r-1} and Q_{r-2}, and the final
//     alloc is min(a0 + eff * Q_R, headroom). A round in which no slot
//     spills leaves Q as it is and so does every later one: the rounds
//     stop there. Any F goes; the kernel takes no workspace.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kGroupThreads = 128;
constexpr int kMaxCluster = 8;  // the portable cluster size

// The block kernel's threads and on-chip flows per thread, by link count
// and objectives: the per-flow registers grow with 3 * L, and threefold
// with objectives (eff, g, alloc). The objective-free one-link instance
// takes 1024 threads, so one block covers the scale-out's 4096 flows
// without a cluster.
template <int L, bool OBJ> struct BlockShape {
  static constexpr int kThreads = L <= 2 ? 512 : 256;
  static constexpr int kFlows = L == 1 ? 4 : L <= 3 ? 2 : 1;
};
template <> struct BlockShape<1, false> {
  static constexpr int kThreads = 1024, kFlows = 4;
};

struct Args {
  const float* threads;  // (E, F, 3)
  const float* act;      // (E, S, F)
  const float* onpath;   // (E, S, F, L)
  const float* tpt;      // (E, S, L, 3)
  const float* bw;       // (E, S, L, 3)
  const float* floor;    // (E, F) or null
  const float* cap;      // (E, F) or null
  float* out;            // (E, S, F, 3)
  int E, S, F, L, rounds;
};

// Sums over the flows of one (env, substep) served by a group of G lanes
// (one flow each): an xor butterfly of width G. Every lane of the group
// returns the same sums.
struct GroupSum {
  int G;
  template <int N>
  __device__ __forceinline__ void operator()(float (&v)[N]) const {
    for (int off = G >> 1; off > 0; off >>= 1) {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        v[i] = __fadd_rn(v[i], __shfl_xor_sync(0xffffffffu, v[i], off, G));
      }
    }
  }
};

// Sums over the flows of one (env, substep) served by a cluster of blocks:
// in-thread partials (done by the caller) -> xor butterfly in each warp ->
// the warp totals by the same butterfly (zeros past the last warp) -> block
// totals in rank order. ``part`` holds
// 2 * kWarps * kMaxN floats and ``total`` 2 * kMaxN; the two halves
// alternate from one sum to the next.
template <int kWarps, int kMaxN>
struct BlockSum {
  float* part;
  float* total;
  int n_ranks;
  int buf = 0;
  template <int N>
  __device__ __forceinline__ void operator()(float (&v)[N]) {
    static_assert(N <= kMaxN, "scratch too small");
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
    float* p = part + buf * kWarps * kMaxN;
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < N; ++i) p[warp * kMaxN + i] = v[i];
    }
    __syncthreads();
    // every warp folds the warp totals the same way: lane w holds warp
    // w's (0 past the last warp), then the butterfly again
#pragma unroll
    for (int i = 0; i < N; ++i) {
      v[i] = lane < n_warps ? p[lane * kMaxN + i] : 0.f;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        v[i] = __fadd_rn(v[i], __shfl_xor_sync(0xffffffffu, v[i], off));
      }
    }
    if (n_ranks > 1) {
      cg::cluster_group cluster = cg::this_cluster();
      float* tb = total + buf * kMaxN;
      if (threadIdx.x == 0) {
#pragma unroll
        for (int i = 0; i < N; ++i) tb[i] = v[i];
      }
      cluster.sync();
#pragma unroll
      for (int i = 0; i < N; ++i) v[i] = 0.f;
      for (int r = 0; r < n_ranks; ++r) {
        const float* remote = cluster.map_shared_rank(tb, r);
#pragma unroll
        for (int i = 0; i < N; ++i) v[i] = __fadd_rn(v[i], remote[i]);
      }
    }
    buf ^= 1;
  }
};

// x / y for y > 0, with a zero numerator answered without the division:
// the same bits (0 / y == 0), but IEEE division takes its slow path on a
// zero numerator, and inactive, off-path and capped-out flows make zeros
// common (trial builds on the card ran the water-fill rounds about twice
// as fast with the guard).
__device__ __forceinline__ float quotient(float x, float y) {
  return x == 0.f ? 0.f : x / y;
}

// One flow's inputs, read once: its activity, its on-path flags, its floor
// and cap (0 without objectives), and eff = threads * act * onpath per
// stage-link slot. An invalid flow (past F, or of a thread past the last
// pair) reads nothing and is all zeros. Link slots past the runtime link
// count are off-path.
template <int L, bool OBJ>
__device__ __forceinline__ void load_flow(const Args& a, int e, long long es,
                                          int f, bool valid,
                                          float (&eff)[3 * L], float (&on)[L],
                                          float& act, float& fl, float& cp) {
  const int La = a.L;
  const long long ef = static_cast<long long>(e) * a.F + f;
  const long long esf = es * a.F + f;
  act = valid ? a.act[esf] : 0.f;
  fl = (OBJ && valid) ? a.floor[ef] : 0.f;
  cp = (OBJ && valid) ? a.cap[ef] : 0.f;
  float thr[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) thr[c] = valid ? a.threads[ef * 3 + c] : 0.f;
#pragma unroll
  for (int l = 0; l < L; ++l) {
    on[l] = (valid && l < La) ? a.onpath[esf * La + l] : 0.f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      eff[3 * l + c] = __fmul_rn(__fmul_rn(thr[c], act), on[l]);
    }
  }
}

// rate[c] = the min of link(j) over the flow's on-path links, 0 for a flow
// with no path, times act; written to out[e, s, f].
template <int L, class Link>
__device__ __forceinline__ void store_rate(const Args& a, long long es, int f,
                                           const float (&on)[L], float act,
                                           Link link) {
  float rate[3] = {INFINITY, INFINITY, INFINITY};
  float path = 0.f;
#pragma unroll
  for (int l = 0; l < L; ++l) {
    if (l < a.L) {
      path = __fadd_rn(path, on[l]);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float x = link(3 * l + c);
        if (on[l] > 0.f) rate[c] = fminf(rate[c], x);
      }
    }
  }
  float* out = a.out + (es * a.F + f) * 3;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    out[c] = __fmul_rn(path > 0.f ? rate[c] : 0.f, act);
  }
}

// The solve for one (env e, substep s) as seen by one thread, which owns
// the flows f0 + k * f_stride (k < K) below F and keeps their values in
// registers; ``live`` is false for a thread past the last (env, substep),
// which still takes part in every sum.
template <int L, bool OBJ, int K, class Sum>
__device__ __forceinline__ void solve(const Args& a, int e, int s, int f0,
                                      int f_stride, bool live, Sum& sum) {
  constexpr int N = 3 * L;
  const int La = a.L;
  const long long es = static_cast<long long>(e) * a.S + s;

  float tpt[N], bw[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const bool on = live && j < 3 * La;
    tpt[j] = on ? a.tpt[es * 3 * La + j] : 0.f;
    bw[j] = on ? a.bw[es * 3 * La + j] : 0.f;
  }

  // this thread's flows, read once: eff, and the per-flow scalars
  float eff[K][N], act[K], on[K][L], fl[K], cp[K];
  bool valid[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int f = f0 + k * f_stride;
    valid[k] = live && f < a.F;
    load_flow<L, OBJ>(a, e, es, f, valid[k], eff[k], on[k], act[k], fl[k],
                      cp[k]);
  }
  // demand = min(eff * tpt, cap); a zero slot gives min(0, 0) = 0
#define DEMAND(k, j) fminf(__fmul_rn(eff[k][j], tpt[j]), cp[k])

  // sum 1: eff (and, with objectives, the unscaled guaranteed)
  float tot[N];
  float g[OBJ ? K : 1][OBJ ? N : 1], alloc[OBJ ? K : 1][OBJ ? N : 1];
  if constexpr (!OBJ) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float t = 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k) t = __fadd_rn(t, eff[k][j]);
      tot[j] = t;
    }
    sum(tot);
#pragma unroll
    for (int j = 0; j < N; ++j) tot[j] = fmaxf(tot[j], 1e-9f);
  } else {
    float both[2 * N];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float t = 0.f, gt = 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        t = __fadd_rn(t, eff[k][j]);
        gt = __fadd_rn(gt, fminf(fl[k], DEMAND(k, j)));
      }
      both[j] = t;
      both[N + j] = gt;
    }
    sum(both);
    // sum 2: the scaled floors -> the residual capacity
    float g2[N];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      tot[j] = fmaxf(both[j], 1e-9f);
      const float scale = fminf(1.f, bw[j] / fmaxf(both[N + j], 1e-9f));
      float t = 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        g[k][j] = __fmul_rn(fminf(fl[k], DEMAND(k, j)), scale);
        t = __fadd_rn(t, g[k][j]);
      }
      g2[j] = t;
    }
    sum(g2);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float resid = fmaxf(__fsub_rn(bw[j], g2[j]), 0.f);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        alloc[k][j] = __fmul_rn(quotient(eff[k][j], tot[j]), resid);
      }
    }
    // the water-fill rounds, alloc in registers
#define HEAD(k, j) __fsub_rn(cp[k], g[k][j])
    for (int r = 0; r < a.rounds; ++r) {
      float sw[2 * N];  // spill, then sum w
#pragma unroll
      for (int j = 0; j < N; ++j) {
        float sp = 0.f, wt = 0.f;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const float head = HEAD(k, j);
          sp = __fadd_rn(sp, fmaxf(__fsub_rn(alloc[k][j], head), 0.f));
          alloc[k][j] = fminf(alloc[k][j], head);
          wt = __fadd_rn(wt, alloc[k][j] < head ? eff[k][j] : 0.f);
        }
        sw[j] = sp;
        sw[N + j] = wt;
      }
      sum(sw);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float wt = fmaxf(sw[N + j], 1e-9f);
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const float w = alloc[k][j] < HEAD(k, j) ? eff[k][j] : 0.f;
          alloc[k][j] =
              __fadd_rn(alloc[k][j], __fmul_rn(quotient(w, wt), sw[j]));
        }
      }
    }
    if (a.rounds > 0) {
#pragma unroll
      for (int j = 0; j < N; ++j) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          alloc[k][j] = fminf(alloc[k][j], HEAD(k, j));
        }
      }
    }
#undef HEAD
  }

  // per-link rate, min over the on-path links, masks
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (!valid[k]) continue;
    store_rate<L>(a, es, f0 + k * f_stride, on[k], act[k], [&](int j) {
      if constexpr (OBJ) {
        return fminf(DEMAND(k, j), __fadd_rn(g[k][j], alloc[k][j]));
      } else {
        return fminf(__fmul_rn(eff[k][j], tpt[j]),
                     __fmul_rn(quotient(eff[k][j], tot[j]), bw[j]));
      }
    });
  }
#undef DEMAND
}

// F <= 32: G lanes (one flow each) per (env, substep), 32 / G pairs a warp.
template <int L, bool OBJ>
__global__ void __launch_bounds__(kGroupThreads)
contention_kernel_group(Args a, int G) {
  const int gid = blockIdx.x * blockDim.x + threadIdx.x;
  const int pair = gid / G;
  const bool live = pair < a.E * a.S;
  GroupSum sum{G};
  solve<L, OBJ, 1>(a, live ? pair / a.S : 0, live ? pair % a.S : 0, gid % G,
                   G, live, sum);
}

// F > 32: a cluster of n_ranks blocks per (env, substep), flows striped
// over the cluster's threads.
template <int L, bool OBJ>
__global__ void __launch_bounds__(BlockShape<L, OBJ>::kThreads)
contention_kernel_block(Args a, int n_ranks) {
  constexpr int kWarps = BlockShape<L, OBJ>::kThreads / 32;
  constexpr int kMaxN = 2 * 3 * L;
  __shared__ float part[2 * kWarps * kMaxN];
  __shared__ float total[2 * kMaxN];
  const int pair = blockIdx.x / n_ranks;
  const int rank = blockIdx.x % n_ranks;  // the block's rank in its cluster
  BlockSum<kWarps, kMaxN> sum{part, total, n_ranks};
  solve<L, OBJ, BlockShape<L, OBJ>::kFlows>(
      a, pair / a.S, pair % a.S, rank * blockDim.x + threadIdx.x,
      n_ranks * blockDim.x, true, sum);
  // no block leaves while another may still read its totals
  if (n_ranks > 1) cg::this_cluster().sync();
}

// More flows than a cluster holds on chip: a cluster of kMaxCluster blocks
// per (env, substep); each thread walks its flows f0 + k * f_stride in
// every pass and recomputes their values, and the per-slot values of the
// sums sit in shared memory. The water-fill carries the prefix Q per slot,
// not alloc per flow (header note).
template <int L, bool OBJ>
__global__ void __launch_bounds__(BlockShape<L, OBJ>::kThreads)
contention_kernel_stream(Args a) {
  constexpr int N = 3 * L;
  constexpr int kWarps = BlockShape<L, OBJ>::kThreads / 32;
  __shared__ float part[2 * kWarps * 2 * N];
  __shared__ float total[2 * 2 * N];
  // per slot: the link's tpt and bw, the clamped eff total, the floors'
  // scale, the residual capacity, and the water-fill's Q_{r-1}, Q_{r-2}
  __shared__ float tpt[N], bw[N], tot[N], scale[N], resid[N], q1[N], q2[N];
  const int pair = blockIdx.x / kMaxCluster;
  const int e = pair / a.S;
  const long long es = static_cast<long long>(e) * a.S + pair % a.S;
  const int f0 = (blockIdx.x % kMaxCluster) * blockDim.x + threadIdx.x;
  const int f_stride = kMaxCluster * blockDim.x;
  BlockSum<kWarps, 2 * N> sum{part, total, kMaxCluster};
  if (threadIdx.x < N) {
    const int j = threadIdx.x;
    const bool on = j < 3 * a.L;
    tpt[j] = on ? a.tpt[es * 3 * a.L + j] : 0.f;
    bw[j] = on ? a.bw[es * 3 * a.L + j] : 0.f;
    q1[j] = 0.f;
    q2[j] = 0.f;
  }
  __syncthreads();

  float eff[N], on[L], act, fl, cp;
#define DEMAND(j) fminf(__fmul_rn(eff[j], tpt[j]), cp)
#define G(j) __fmul_rn(fminf(fl, DEMAND(j)), scale[j])
#define A0(j) __fmul_rn(quotient(eff[j], tot[j]), resid[j])
  // sum 1: eff (and, with objectives, the unscaled guaranteed)
  {
    float v[OBJ ? 2 * N : N];
#pragma unroll
    for (int j = 0; j < (OBJ ? 2 * N : N); ++j) v[j] = 0.f;
    for (int f = f0; f < a.F; f += f_stride) {
      load_flow<L, OBJ>(a, e, es, f, true, eff, on, act, fl, cp);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        v[j] = __fadd_rn(v[j], eff[j]);
        if constexpr (OBJ) v[N + j] = __fadd_rn(v[N + j], fminf(fl, DEMAND(j)));
      }
    }
    sum(v);
    if (threadIdx.x == 0) {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        tot[j] = fmaxf(v[j], 1e-9f);
        if constexpr (OBJ) {
          scale[j] = fminf(1.f, bw[j] / fmaxf(v[N + j], 1e-9f));
        }
      }
    }
    __syncthreads();
  }
  if constexpr (OBJ) {
    // sum 2: the scaled floors -> the residual capacity
    float v[N];
#pragma unroll
    for (int j = 0; j < N; ++j) v[j] = 0.f;
    for (int f = f0; f < a.F; f += f_stride) {
      load_flow<L, OBJ>(a, e, es, f, true, eff, on, act, fl, cp);
#pragma unroll
      for (int j = 0; j < N; ++j) v[j] = __fadd_rn(v[j], G(j));
    }
    sum(v);
    if (threadIdx.x == 0) {
#pragma unroll
      for (int j = 0; j < N; ++j) resid[j] = fmaxf(__fsub_rn(bw[j], v[j]), 0.f);
    }
    __syncthreads();
    // the water-fill rounds: round r adds up the spill of the flows that
    // reach their headroom in it, and the eff of those still below it
    for (int r = 1; r <= a.rounds; ++r) {
      float sw[2 * N];  // spill, then sum w
#pragma unroll
      for (int j = 0; j < 2 * N; ++j) sw[j] = 0.f;
      for (int f = f0; f < a.F; f += f_stride) {
        load_flow<L, OBJ>(a, e, es, f, true, eff, on, act, fl, cp);
#pragma unroll
        for (int j = 0; j < N; ++j) {
          const float head = __fsub_rn(cp, G(j));
          const float a0 = A0(j);
          const float u1 = __fadd_rn(a0, __fmul_rn(eff[j], q1[j]));
          const bool fresh =
              r == 1 || __fadd_rn(a0, __fmul_rn(eff[j], q2[j])) < head;
          sw[j] = __fadd_rn(sw[j],
                            fresh ? fmaxf(__fsub_rn(u1, head), 0.f) : 0.f);
          sw[N + j] = __fadd_rn(sw[N + j], u1 < head ? eff[j] : 0.f);
        }
      }
      sum(sw);  // every thread of the block is past its reads of q1, q2
      bool spilled = false;
#pragma unroll
      for (int j = 0; j < N; ++j) spilled = spilled || sw[j] > 0.f;
      if (threadIdx.x == 0) {
#pragma unroll
        for (int j = 0; j < N; ++j) {
          q2[j] = q1[j];
          q1[j] = __fadd_rn(q1[j], quotient(sw[j], fmaxf(sw[N + j], 1e-9f)));
        }
      }
      __syncthreads();
      if (!spilled) break;  // the same sums, so the same choice, everywhere
    }
  }

  // per-link rate, min over the on-path links, masks
  for (int f = f0; f < a.F; f += f_stride) {
    load_flow<L, OBJ>(a, e, es, f, true, eff, on, act, fl, cp);
    store_rate<L>(a, es, f, on, act, [&](int j) {
      if constexpr (OBJ) {
        const float g = G(j);
        const float a0 = A0(j);
        const float alloc =
            a.rounds > 0
                ? fminf(__fadd_rn(a0, __fmul_rn(eff[j], q1[j])),
                        __fsub_rn(cp, g))
                : a0;
        return fminf(DEMAND(j), __fadd_rn(g, alloc));
      } else {
        return fminf(__fmul_rn(eff[j], tpt[j]),
                     __fmul_rn(quotient(eff[j], tot[j]), bw[j]));
      }
    });
  }
#undef A0
#undef G
#undef DEMAND
  cg::this_cluster().sync();  // no block leaves while another may read it
}

// Launch ``kernel`` on ``blocks`` blocks of ``T`` threads in clusters of
// ``cl`` blocks.
template <class... Params, class... Actual>
int launch_cluster(void (*kernel)(Params...), unsigned blocks, int T, int cl,
                   cudaStream_t stream, Actual... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(T);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int L, bool OBJ>
int launch(const Args& a, cudaStream_t stream) {
  if (a.F <= 32) {
    int G = 1;
    while (G < a.F) G <<= 1;
    const long long lanes = static_cast<long long>(a.E) * a.S * G;
    const int blocks =
        static_cast<int>((lanes + kGroupThreads - 1) / kGroupThreads);
    contention_kernel_group<L, OBJ><<<blocks, kGroupThreads, 0, stream>>>(
        a, G);
    return static_cast<int>(cudaGetLastError());
  }
  constexpr int kT = BlockShape<L, OBJ>::kThreads;
  constexpr int kK = BlockShape<L, OBJ>::kFlows;
  const int T = min(kT, (a.F + 31) / 32 * 32);
  int cl = 1;  // the smallest cluster that holds the flows on chip
  while (cl < kMaxCluster && static_cast<long long>(cl) * T * kK < a.F) {
    cl <<= 1;
  }
  const unsigned blocks = static_cast<unsigned>(a.E) * a.S * cl;
  if (static_cast<long long>(cl) * T * kK < a.F) {  // more than it holds
    return launch_cluster(contention_kernel_stream<L, OBJ>, blocks, T, cl,
                          stream, a);
  }
  if (cl == 1) {
    contention_kernel_block<L, OBJ><<<blocks, T, 0, stream>>>(a, 1);
    return static_cast<int>(cudaGetLastError());
  }
  return launch_cluster(contention_kernel_block<L, OBJ>, blocks, T, cl,
                        stream, a, cl);
}

template <int L>
int launch_obj(const Args& a, bool obj, cudaStream_t st) {
  return obj ? launch<L, true>(a, st) : launch<L, false>(a, st);
}

}  // namespace

// Plain C entry, bound with ctypes. Every pointer is a device pointer of a
// contiguous float32 tensor; floor and cap are both null (no objectives)
// or both set. The launch goes on ``stream``, uses no workspace and does
// not synchronise. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for shapes the kernel does not take (more than
// contention_max_links() links).
extern "C" int contention_max_links() { return 8; }

extern "C" int contention_launch(const void* threads, const void* act,
                                 const void* onpath, const void* tpt,
                                 const void* bw, const void* floor,
                                 const void* cap, void* out, int E, int S,
                                 int F, int L, int rounds, void* stream) {
  if (E <= 0 || S <= 0 || F <= 0) return static_cast<int>(cudaSuccess);
  if (L < 1 || L > 8 || rounds < 0 || (floor == nullptr) != (cap == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool obj = floor != nullptr;
  Args a{static_cast<const float*>(threads), static_cast<const float*>(act),
         static_cast<const float*>(onpath), static_cast<const float*>(tpt),
         static_cast<const float*>(bw), static_cast<const float*>(floor),
         static_cast<const float*>(cap), static_cast<float*>(out),
         E, S, F, L,
         obj ? rounds : 0};  // the water-fill only moves capped allocations
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (L) {
    case 1: return launch_obj<1>(a, obj, st);
    case 2: return launch_obj<2>(a, obj, st);
    case 3: return launch_obj<3>(a, obj, st);
    case 4: return launch_obj<4>(a, obj, st);
    default: return launch_obj<8>(a, obj, st);
  }
}
