"""repro_torch.runtime: the runtime around the simulator, the port's copy of
the simulator half of the JAX package's ``repro.runtime``.

  sim_runner.py      ``SimulationRunner``: checkpoints, resume, rollback,
                     degradation, preemption and a heartbeat around
                     ``Simulator.run``
  elastic.py         ``remesh_restore_brain``: a brain checkpoint restored
                     on fewer ranks
  fault_tolerance.py the atomic heartbeat file
  chaos.py           faults injected on purpose to test recovery
"""
