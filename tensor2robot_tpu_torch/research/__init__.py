"""Research models ported from ``tensor2robot_tpu/research``."""
