"""Run modes. String-valued so they are trivially config friendly."""


class ModeKeys:
  TRAIN = 'train'
  EVAL = 'eval'
  PREDICT = 'predict'

  ALL = (TRAIN, EVAL, PREDICT)

