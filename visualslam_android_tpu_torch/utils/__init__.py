"""Synthetic scenes, fixtures, tensor dataclasses and the state carry-over
from the JAX package's numpy trees."""
