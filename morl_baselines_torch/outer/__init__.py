"""Outer loops that pick the weights a multi-policy agent trains on."""

from .linear_support import LinearSupport

__all__ = ["LinearSupport"]
