"""Network layers: the SNAIL blocks, the vision tower with its spatial
softmax head, and the ResNet v1/v2 towers with FiLM."""

from tensor2robot_tpu_torch.layers.resnet import (BLOCK_SIZES, FilmResNet,
                                                  LinearFilmGenerator, ResNet,
                                                  apply_film, resnet_model)

__all__ = ['BLOCK_SIZES', 'FilmResNet', 'LinearFilmGenerator', 'ResNet',
           'apply_film', 'resnet_model']
