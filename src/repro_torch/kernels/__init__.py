"""The hand-written CUDA kernels' wrappers and their plain torch versions.

Importing these modules builds nothing: ``_build.library()`` compiles the
``csrc/`` sources on first use on a machine with ``nvcc`` and a card.
"""
