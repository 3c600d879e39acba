"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

* ``pool``: argmax-slot max pool, forward and routing backward
  (``csrc/pool.cu``).
* ``conv_s2d``: space-to-depth first-layer conv, forward, dW and dx
  (``csrc/conv_s2d.cu``).
* ``flash_attention``: online-softmax attention, forward, dq and dk/dv
  (``csrc/flash_attention.cu``, ``csrc/flash_attention_bwd.cu``).
* ``photometric``: the fused brightness, contrast and clip pass
  (``csrc/photometric.cu``).
* ``fused_update``: the optimizer, average and guard update of a train
  step (``csrc/fused_update.cu``).

The kernels build from source at first use (``_build``); a CUDA tensor
launches the kernel and a CPU tensor runs the plain version
(``_dispatch``).

Importing this package registers the forwards as the custom ops
``t2r::pool_fwd``, ``t2r::conv_s2d_fwd``, ``t2r::flash_fwd`` and
``t2r::photometric``, which an exported serving program
(``export/exporters.py``) holds as nodes: a host that loads such a program
imports this package, and not the model's code.
"""

from tensor2robot_tpu_torch.ops import pool  # isort: skip
from tensor2robot_tpu_torch.ops import conv_s2d  # isort: skip
from tensor2robot_tpu_torch.ops import flash_attention  # isort: skip
from tensor2robot_tpu_torch.ops import photometric  # isort: skip
