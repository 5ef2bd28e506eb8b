"""PyTorch/CUDA port of the MSP structural-plasticity simulator.

A second package beside the JAX reference (``repro``): the same module
names, plain torch functions on tensors, and hand-written CUDA kernels for
Hopper (``csrc/``) where the reference has Pallas kernels. It imports neither
``jax`` nor ``repro``. Entry points: ``repro_torch.sim.api.Simulator`` (the
brain simulator) and ``repro_torch.models.build_model`` (the LM stack's
serving path).
"""
