"""Hand-written CUDA kernels (``csrc/*.cu``) with their plain-PyTorch versions.

Each family keeps the reference's ``ref.py`` / ``ops.py`` split: ``ref.py``
holds the plain PyTorch version, ``ops.py`` the wrapper that launches the
kernel on a CUDA tensor (and counts the launch) or runs the plain version on a
CPU tensor.  :mod:`._build` compiles the sources with ``nvcc`` at first use.
"""
