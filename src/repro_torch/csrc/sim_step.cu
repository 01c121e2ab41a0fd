// Batched dense-simulator interval for Hopper (sm_90a).
//
// Replaces the two Pallas kernels of src/repro/kernels/sim_step/kernel.py:
//   _sim_sched_kernel  (sim_interval_pallas): per-substep rates (E, S, 3),
//                      already multiplied by dt;
//   _sim_kernel        (sim_step_pallas): one constant rate (E, 3) per env,
//                      multiplied by dt inside the loop.
// Both are the same recurrence, so both are one kernel here: the constant-
// rate form passes a substep stride of 0 and the scale dt; the per-substep
// form passes a stride of 3 and the scale 1.0 (x * 1.0f == x exactly).
//
// Per env, S sequential substeps of the capped read -> network -> write
// pipeline, carrying the sender/receiver buffers (s, r) and summing the
// bytes each stage moved:
//   read = max(min(rate_r, cap_s - s), 0);          s_mid = s + read
//   net  = max(min(min(rate_n, s_mid), cap_r - r), 0); r_mid = r + net
//   wr   = max(min(rate_w, r_mid), 0)
//   s = s_mid - net; r = r_mid - wr
// The order of operations is that of repro.core.simulator._scan_substeps.
// The rate scale uses __fmul_rn so nvcc cannot contract it into an FMA,
// which keeps rate * dt bitwise equal to the product the caller would form.
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
// Design. One thread per env, 128 threads a block, ceil(E / 128) blocks,
// the tail masked. The loop over S keeps s, r and the three sums in
// registers and writes each env's 2 + 3 outputs once. Neighbouring
// threads read rates S * 12 bytes apart, so the rate loads are not
// coalesced; at the main path's E=32 the launch itself dominates. Staging
// the rates through shared memory, and batching many intervals into one
// launch, are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void sim_interval_kernel(const float* __restrict__ bufs,
                                    const float* __restrict__ rates,
                                    long long rate_env_stride,
                                    long long rate_sub_stride,
                                    float rate_scale,
                                    const float* __restrict__ cap,
                                    float* __restrict__ out_bufs,
                                    float* __restrict__ moved,
                                    int n_envs, int substeps) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_envs) return;
  float s = bufs[2 * e];
  float r = bufs[2 * e + 1];
  const float cap_s = cap[2 * e];
  const float cap_r = cap[2 * e + 1];
  float mr = 0.f, mn = 0.f, mw = 0.f;
  const float* rp = rates + e * rate_env_stride;
  for (int i = 0; i < substeps; ++i, rp += rate_sub_stride) {
    const float rate_r = __fmul_rn(rp[0], rate_scale);
    const float rate_n = __fmul_rn(rp[1], rate_scale);
    const float rate_w = __fmul_rn(rp[2], rate_scale);
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
  out_bufs[2 * e] = s;
  out_bufs[2 * e + 1] = r;
  moved[3 * e] = mr;
  moved[3 * e + 1] = mn;
  moved[3 * e + 2] = mw;
}

}  // namespace

// Plain C entry, bound with ctypes. Every pointer is a device pointer of a
// contiguous float32 tensor; the launch goes on ``stream`` and does not
// synchronise. Returns cudaGetLastError() after the launch.
extern "C" int sim_interval_launch(const void* bufs, const void* rates,
                                   long long rate_env_stride,
                                   long long rate_sub_stride,
                                   float rate_scale, const void* cap,
                                   void* out_bufs, void* moved, int n_envs,
                                   int substeps, void* stream) {
  if (n_envs <= 0) return static_cast<int>(cudaSuccess);
  const int blocks = (n_envs + kThreads - 1) / kThreads;
  sim_interval_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(bufs), static_cast<const float*>(rates),
      rate_env_stride, rate_sub_stride, rate_scale,
      static_cast<const float*>(cap), static_cast<float*>(out_bufs),
      static_cast<float*>(moved), n_envs, substeps);
  return static_cast<int>(cudaGetLastError());
}
