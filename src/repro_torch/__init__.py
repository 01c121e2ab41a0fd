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
  repro_torch.runtime    — heartbeats (the fleet controller's health
                           check), the straggler detector, the
                           fault-tolerant trainer, int8 gradient
                           compression and the elastic re-mesh
  repro_torch.sharding   — the flow axis of fleets and topologies split
                           over a torch DeviceMesh, and the LM sharding
                           rules (meshes: repro_torch.launch.mesh)
  repro_torch.transfer   — the real 3-stage transfer engine (a copy)
  repro_torch.checkpoint — atomic, sha256-verified checkpoints through the
                           transfer engine, blocking or async
  repro_torch.data       — the AutoMDT-tuned LM input pipeline (a copy)
  repro_torch.nn         — the layers the networks and language models use
                           (linear, norms, attention, MoE, the Mamba2 block)
  repro_torch.models     — the decoder (dense, MoE), ssm (mamba2) and
                           hybrid (zamba2) language models;
                           repro_torch.launch serves and trains them
  repro_torch.optim      — AdamW with the reference's formulas, LR schedules
  repro_torch.kernels    — hand-written Hopper kernels (CUDA C++ in csrc/)
  repro_torch.convert    — parameters and optimizer state to and from the
                           JAX package's layout

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; without CUDA and without that request they raise.
"""

__version__ = "0.1.0"
