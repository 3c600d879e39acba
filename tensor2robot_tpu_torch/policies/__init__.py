"""Policies: predictor-backed action selection."""

from tensor2robot_tpu_torch.policies.policies import CEMPolicy, Policy

__all__ = ['CEMPolicy', 'Policy']
