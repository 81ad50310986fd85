"""Tensor algebra, the J2 return map and the banded gather engine."""
