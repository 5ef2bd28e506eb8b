"""The hand-written CUDA kernels' wrappers and their plain torch versions.

``ops`` is the public kernel API, under the JAX package's names and keyword
arguments: ``flash_attention`` (K9), ``gauss_probs`` (K7),
``fused_neuron_step`` (K8), ``bh_traverse`` (K2), ``radix_argsort`` (K6),
``morton_sort`` (K3), ``synapse_apply`` (K4), ``route_build`` (K5) and
``fused_activity_window`` (K1). ``ref`` holds the plain oracles under the JAX
names. A wrapper runs its kernel on a CUDA tensor (or raises) and its plain
version on a CPU tensor: the tensor's device decides, there is no
``interpret`` argument.

Importing these modules builds nothing: ``_build.library()`` compiles the
``csrc/`` sources on first use on a machine with ``nvcc`` and a card.
"""
