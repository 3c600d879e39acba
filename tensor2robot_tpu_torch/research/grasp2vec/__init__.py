"""Grasp2Vec: the self-supervised grasping representation (two ResNet
towers, embedding-arithmetic losses, heatmap localization)."""

from tensor2robot_tpu_torch.research.grasp2vec import losses, visualization
from tensor2robot_tpu_torch.research.grasp2vec.grasp2vec_model import (
    Grasp2VecModel, Grasp2VecPreprocessor)
from tensor2robot_tpu_torch.research.grasp2vec.networks import Embedding

__all__ = ['Embedding', 'Grasp2VecModel', 'Grasp2VecPreprocessor', 'losses',
           'visualization']
