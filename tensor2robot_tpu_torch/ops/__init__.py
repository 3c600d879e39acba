"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

* ``pool``: argmax-slot max pool forward (``csrc/pool.cu``).
* ``conv_s2d``: space-to-depth first-layer conv forward (``csrc/conv_s2d.cu``).

The kernels build from source at first use (``_build``); a CUDA tensor
launches the kernel and a CPU tensor runs the plain version
(``_dispatch``).
"""
