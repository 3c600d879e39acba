"""Utilities: the cross-entropy method and the JAX weight converter."""
