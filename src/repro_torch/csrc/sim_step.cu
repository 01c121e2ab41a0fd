// Batched dense-simulator interval for Hopper (sm_90a).
//
// Replaces the two Pallas kernels of src/repro/kernels/sim_step/kernel.py:
//   _sim_sched_kernel  (sim_interval_pallas): per-substep rates (E, S, 3),
//                      already multiplied by dt;
//   _sim_kernel        (sim_step_pallas): one constant rate (E, 3) per env,
//                      multiplied by dt inside the loop.
// Both are the same recurrence; each form has its kernel and its C entry:
// sim_interval_launch stages the per-substep rates (E, S, 3) on chip,
// sim_step_launch reads one rate (E, 3) per env and the scale dt.
//
// Per env, S sequential substeps of the capped read -> network -> write
// pipeline, carrying the sender/receiver buffers (s, r) and summing the
// bytes each stage moved:
//   read = max(min(rate_r, cap_s - s), 0);          s_mid = s + read
//   net  = max(min(min(rate_n, s_mid), cap_r - r), 0); r_mid = r + net
//   wr   = max(min(rate_w, r_mid), 0)
//   s = s_mid - net; r = r_mid - wr
// The order of operations is that of repro.core.simulator._scan_substeps.
// The constant form's rate * dt uses __fmul_rn so nvcc cannot contract it
// into an FMA, which keeps it bitwise equal to the product the caller would
// form; both kernels are bitwise equal to kernels/sim_step/ref.py.
//
// fminf/fmaxf return the non-NaN operand where jnp.minimum/maximum
// propagate NaN. The simulator's inputs are finite (clamped thread counts,
// finite schedule tables and capacities), so the two agree.
//
// What bounds it: the larger of two terms.
//   bytes  Per launch the kernel reads each env's buffers and caps (16 B)
//          and its rates (S * 12 B, or 12 B for the constant form), and
//          writes 20 B; over 3.35 TB/s.
//   chain  Each env is S dependent substeps. The sender buffer s carries 8
//          dependent f32 ops per substep (cap_s - s, min, max, + read, min,
//          min, max, - net), so one thread needs 8 * S ops, each waiting
//          about 4 cycles: S=50 is 400 ops, about 0.8 us at 1.98 GHz.
//          (All ops over the 67 TFLOP/s f32 rate are far below either.)
// The chain binds below about 4000 envs, the main path's 1 and 32
// included; the bytes bind above it (3.1 us at E=16384).
//
// Design of the per-substep form (sim_interval_kernel_staged). The first design read each
// substep's three rates straight from global memory inside the chain, 600
// bytes apart between neighbouring threads: one exposed L2 round trip per
// substep, about 300 cycles where the chain needs 35. Like the TPU kernel,
// which holds a (blk, S, 3) block of rates in VMEM, this one stages the
// rates on chip:
//   - One warp per block, one env per lane, so a block is 32 envs and the
//     barriers are __syncwarp. At E=32 the launch is one block whatever the
//     design; at E=16384 it is 512 blocks, about 4 per SM.
//   - A block's envs own one contiguous span of 32 * S * 3 floats. It is
//     copied in chunks of kChunk substeps into a ring of kStages slots in
//     shared memory with cp.async, kStages - 1 chunks ahead of the chain,
//     so chunks k+1.. land while the chain runs on chunk k. Any S and E go:
//     the last chunk and the last block are ragged and masked.
//   - 16-byte cp.async of aligned pieces. A row of S * 12 bytes is 16-byte
//     aligned only when S is a multiple of 4 (S=50 is not), so a 2-D TMA
//     tensor map (16-byte global strides) does not fit, and copies of 4 or
//     8 bytes take 3 to 6 times as many requests: a trial with 4-byte
//     cp.async ran slower than the first design (PERF.md §6). Instead
//     each env's chunk (3 * kChunk floats) is covered by the kPieces
//     aligned 16-byte pieces around it, copied whole into a row of the
//     slot; the env reads its chunk at the offset delta (0 to 3 floats) its
//     row start has within 16 bytes. kChunk is a multiple of 4, so delta is
//     the same for every chunk of an env, and a lane's pieces move by the
//     same stride from chunk to chunk: their addresses are planned once
//     (a trial that worked them out per chunk spent as long issuing the
//     copies as running the chain). A piece never crosses a 16-byte
//     boundary, so the few floats read around a chunk lie in the same
//     aligned 16 bytes as floats of the tensor; they are never used.
//   - A slot holds [env][kRow] floats, kRow = 4 * kPieces = 52. Rows are
//     16-byte aligned, so lanes reading the same offset of their rows meet
//     on 8 of the 32 banks (4-way conflicts where every delta is equal, S a
//     multiple of 4; 2-way at S=50). The loads are off the dependent chain
//     (the loop over a full chunk is unrolled), so the chain runs back to
//     back and the conflicts cost issue slots, not latency.
//   Shared memory: kStages * 32 * 52 * 4 = 19,968 bytes a block (static).
// The constant form (sim_interval_kernel_const) reads 3 floats per env and
// stages nothing: one thread per env, 128 a block, rate * dt formed once
// before the loop.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;              // envs per block of the staged form
constexpr int kChunk = 16;             // substeps per staged chunk (4 | kChunk)
constexpr int kStages = 3;             // chunks in the ring
// aligned 16-byte pieces that cover one env's chunk at any offset in 16
// bytes, and the padded row of one env in a slot
constexpr int kPieces = (3 * kChunk + 3 + 3) / 4;
constexpr int kRow = 4 * kPieces;
constexpr int kConstThreads = 128;     // envs per block of the constant form
static_assert(kChunk % 4 == 0, "a chunk must keep each env's offset");

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

// The aligned 16 bytes that hold *p, and p's offset in them, in floats.
__device__ __forceinline__ const float* aligned16(const float* p,
                                                  int& delta) {
  const unsigned long long a = reinterpret_cast<unsigned long long>(p);
  delta = static_cast<int>(a & 15) >> 2;
  return reinterpret_cast<const float*>(a & ~15ull);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// One substep of one env, in _scan_substeps' order.
__device__ __forceinline__ void substep(float rate_r, float rate_n,
                                        float rate_w, float cap_s,
                                        float cap_r, float& s, float& r,
                                        float& mr, float& mn, float& mw) {
  const float read = fmaxf(fminf(rate_r, cap_s - s), 0.f);
  const float s_mid = s + read;
  const float net = fmaxf(fminf(fminf(rate_n, s_mid), cap_r - r), 0.f);
  const float r_mid = r + net;
  const float wr = fmaxf(fminf(rate_w, r_mid), 0.f);
  s = s_mid - net;
  r = r_mid - wr;
  mr += read;
  mn += net;
  mw += wr;
}

// The pieces one lane copies, chunk after chunk: piece m of the lane is
// piece p = j % kPieces of env j / kPieces of the block, j = lane + 32 m.
// Chunk k of an env lies 3 * kChunk * k floats past its chunk 0, a whole
// number of 16-byte pieces, so each piece's source, slot offset and
// bound are set once here and only the chunk's offset moves.
struct Pieces {
  const float* src[kPieces];  // the piece's source in chunk 0
  int dst[kPieces];           // its floats' offset in a slot
  int lim[kPieces];           // copied while lim < the chunk's floats
};

__device__ __forceinline__ void plan_pieces(Pieces& pc,
                                            const float* block_rates,
                                            long long row, int n_block_envs) {
#pragma unroll
  for (int m = 0; m < kPieces; ++m) {
    const int j = threadIdx.x + kWarp * m;
    const int env = j / kPieces, p = j % kPieces;
    int delta;
    pc.src[m] = aligned16(block_rates + env * row, delta) + 4 * p;
    pc.dst[m] = env * kRow + 4 * p;
    pc.lim[m] = env < n_block_envs ? 4 * p - delta : 0x7fffffff;
  }
}

// Copy chunk k of the block's envs into its ring slot (nothing past the
// last chunk), then commit one cp.async group either way, so that the
// group count stays one per chunk index.
__device__ __forceinline__ void stage_chunk(float* slot, const Pieces& pc,
                                            int k, int n_chunks,
                                            int substeps) {
  if (k < n_chunks) {
    const int first = k * kChunk;
    const int words = 3 * min(kChunk, substeps - first);  // per env
#pragma unroll
    for (int m = 0; m < kPieces; ++m) {
      if (pc.lim[m] < words) {
        cp_async16(slot + pc.dst[m], pc.src[m] + 3 * first);
      }
    }
  }
  cp_async_commit();
}

// An env's buffers and caps in, its buffers and moved bytes out.
struct Env {
  float s = 0.f, r = 0.f, cap_s = 0.f, cap_r = 0.f;
  float mr = 0.f, mn = 0.f, mw = 0.f;

  __device__ __forceinline__ void load(const float* bufs, const float* cap,
                                       int e) {
    s = bufs[2 * e];
    r = bufs[2 * e + 1];
    cap_s = cap[2 * e];
    cap_r = cap[2 * e + 1];
  }
  __device__ __forceinline__ void step(float rate_r, float rate_n,
                                       float rate_w) {
    substep(rate_r, rate_n, rate_w, cap_s, cap_r, s, r, mr, mn, mw);
  }
  __device__ __forceinline__ void store(float* out_bufs, float* moved,
                                        int e) const {
    out_bufs[2 * e] = s;
    out_bufs[2 * e + 1] = r;
    moved[3 * e] = mr;
    moved[3 * e + 1] = mn;
    moved[3 * e + 2] = mw;
  }
};

// The constant-rate form: rate (E, 3) times rate_scale, held for every
// substep.
__global__ void __launch_bounds__(kConstThreads)
sim_interval_kernel_const(const float* __restrict__ bufs,
                          const float* __restrict__ rate, float rate_scale,
                          const float* __restrict__ cap,
                          float* __restrict__ out_bufs,
                          float* __restrict__ moved, int n_envs,
                          int substeps) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_envs) return;
  Env env;
  env.load(bufs, cap, e);
  const float rate_r = __fmul_rn(rate[3 * e], rate_scale);
  const float rate_n = __fmul_rn(rate[3 * e + 1], rate_scale);
  const float rate_w = __fmul_rn(rate[3 * e + 2], rate_scale);
#pragma unroll 4
  for (int i = 0; i < substeps; ++i) env.step(rate_r, rate_n, rate_w);
  env.store(out_bufs, moved, e);
}

// The per-substep form: rates (E, S, 3), staged on chip chunk by chunk.
__global__ void __launch_bounds__(kWarp)
sim_interval_kernel_staged(const float* __restrict__ bufs,
                           const float* __restrict__ rates,
                           const float* __restrict__ cap,
                           float* __restrict__ out_bufs,
                           float* __restrict__ moved, int n_envs,
                           int substeps) {
  __shared__ __align__(16) float ring[kStages][kWarp][kRow];
  const int lane = threadIdx.x;
  const int e0 = blockIdx.x * kWarp;
  const int e = e0 + lane;
  const bool live = e < n_envs;
  Env env;
  if (live) env.load(bufs, cap, e);
  const int n_block_envs = min(kWarp, n_envs - e0);
  const long long row = 3LL * substeps;  // floats per env
  const float* block_rates = rates + e0 * row;
  const int n_chunks = (substeps + kChunk - 1) / kChunk;
  int delta;  // this env's offset in its 16-byte pieces, every chunk
  aligned16(block_rates + lane * row, delta);
  Pieces pc;
  plan_pieces(pc, block_rates, row, n_block_envs);
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) {
    stage_chunk(&ring[k][0][0], pc, k, n_chunks, substeps);
  }
  for (int k = 0; k < n_chunks; ++k) {
    stage_chunk(&ring[(k + kStages - 1) % kStages][0][0], pc,
                k + kStages - 1, n_chunks, substeps);
    cp_async_wait<kStages - 1>();  // chunk k has landed (own copies)
    __syncwarp();                  // ... and every lane's
    const float* x = ring[k % kStages][lane] + delta;
    const int n = min(kChunk, substeps - k * kChunk);
    if (n == kChunk) {
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        env.step(x[3 * i], x[3 * i + 1], x[3 * i + 2]);
      }
    } else {
      for (int i = 0; i < n; ++i) {
        env.step(x[3 * i], x[3 * i + 1], x[3 * i + 2]);
      }
    }
    __syncwarp();  // every lane is done with the slot before it refills
  }
  if (live) env.store(out_bufs, moved, e);
}

}  // namespace

// Plain C entries, bound with ctypes. Every pointer is a device pointer of
// a contiguous float32 tensor; bufs, cap and out_bufs are (E, 2), moved is
// (E, 3). The launch goes on ``stream`` and does not synchronise. Each
// returns cudaGetLastError() after the launch, or cudaErrorInvalidValue.
//
// sim_interval_launch: rates (E, S, 3), already multiplied by dt.
extern "C" int sim_interval_launch(const void* bufs, const void* rates,
                                   const void* cap, void* out_bufs,
                                   void* moved, int n_envs, int substeps,
                                   void* stream) {
  if (n_envs <= 0) return static_cast<int>(cudaSuccess);
  if (substeps < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n_envs + kWarp - 1) / kWarp;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  sim_interval_kernel_staged<<<blocks, kWarp, 0, st>>>(
      static_cast<const float*>(bufs), static_cast<const float*>(rates),
      static_cast<const float*>(cap), static_cast<float*>(out_bufs),
      static_cast<float*>(moved), n_envs, substeps);
  return static_cast<int>(cudaGetLastError());
}

// sim_step_launch: rate (E, 3), multiplied by rate_scale (dt) in the kernel.
extern "C" int sim_step_launch(const void* bufs, const void* rate,
                               float rate_scale, const void* cap,
                               void* out_bufs, void* moved, int n_envs,
                               int substeps, void* stream) {
  if (n_envs <= 0) return static_cast<int>(cudaSuccess);
  if (substeps < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n_envs + kConstThreads - 1) / kConstThreads;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  sim_interval_kernel_const<<<blocks, kConstThreads, 0, st>>>(
      static_cast<const float*>(bufs), static_cast<const float*>(rate),
      rate_scale, static_cast<const float*>(cap),
      static_cast<float*>(out_bufs), static_cast<float*>(moved), n_envs,
      substeps);
  return static_cast<int>(cudaGetLastError());
}
