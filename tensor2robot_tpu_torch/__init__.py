"""tensor2robot on PyTorch and CUDA: the Hopper port of ``tensor2robot_tpu``.

The layout mirrors the JAX package module for module, so each port module
sits at the same relative path as the module it mirrors. The port imports
``torch`` and numpy only; it keeps its own copies of the pure-Python
pieces (specs, modes, padding rules) rather than importing them.

Covered so far: the QT-Opt Grasping44 serving path, from a numpy frame
through the predictor to the device-resident cross-entropy method, and
its training step (``train/``: TRAIN preprocessing, log loss, momentum SGD
with a staircase learning rate, parameter averaging), with hand-written
CUDA kernels for the argmax-slot max pool and the space-to-depth first
convolution, forward and backward (``ops/``).
"""
