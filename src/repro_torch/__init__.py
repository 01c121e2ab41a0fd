"""repro_torch — the PyTorch and CUDA port of the AutoMDT system in
``repro``, for NVIDIA Hopper (H100).

The JAX package ``repro`` is the reference; this package imports nothing of
it and nothing of JAX. Layers ported so far:

  repro_torch.core       — schedule, utility, the batched dense simulator,
                           the multi-flow fleet, networks, single-flow and
                           fleet PPO, exploration, the Marlin and Globus
                           baselines, and the production AutoMDTController
                           and FleetController
  repro_torch.scenarios  — scenario families, ScenarioSpec, the fleet
                           samplers and the fleet evaluation harness
  repro_torch.runtime    — the heartbeat registry the fleet controller's
                           health check reads
  repro_torch.transfer   — the real 3-stage transfer engine (a copy)
  repro_torch.checkpoint — atomic, sha256-verified checkpoints of NumPy state
  repro_torch.nn         — the layers the networks use (linear, layernorm)
  repro_torch.optim      — AdamW with the reference's formulas
  repro_torch.kernels    — hand-written Hopper kernels (CUDA C++ in csrc/)
  repro_torch.convert    — parameters and optimizer state to and from the
                           JAX package's layout

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; without CUDA and without that request they raise.
"""

__version__ = "0.1.0"
