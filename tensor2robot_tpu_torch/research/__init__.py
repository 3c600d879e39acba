"""Research models ported from ``tensor2robot_tpu/research``: Grasp2Vec,
pose_env, QT-Opt and the vrgripper models (each imported on demand)."""

__all__ = ['grasp2vec', 'pose_env', 'qtopt', 'vrgripper']
