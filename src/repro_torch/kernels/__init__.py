"""Hand-written Hopper kernels for the port's hot spots.

  sim_step/   the dense simulator's substep integration across an env batch
              (replaces repro/kernels/sim_step's two Pallas kernels)
  contention/ the fleet's per-substep contention solve across envs and
              substeps (replaces repro/kernels/contention's Pallas kernel)

Each kernel ships a CUDA C++ source under ``repro_torch/csrc/``, kernel.py
(the ctypes binding and launch), ops.py (the checked wrapper with its
launch count; CPU tensors take the plain version) and ref.py (the plain
PyTorch version). ``build`` compiles the sources with nvcc at first use,
one nvcc per source, all started together.
"""
