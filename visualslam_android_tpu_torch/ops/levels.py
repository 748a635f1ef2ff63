"""Pyramid level coordinate transforms (capability parity with
jni/LevelHelpers.h:17-45). Level-N pixel centers are offset from level-0 by
the center-aligned convention: zero_pos = (pos + 0.5) * scale - 0.5."""

from __future__ import annotations


def level_scale(level):
    """LevelHelpers.h:17-19."""
    return 1 << level if isinstance(level, int) else 2**level


def level_zero_pos(pos, level):
    """Level-N coords -> level-0 coords (LevelHelpers.h:22-32)."""
    return (pos + 0.5) * level_scale(level) - 0.5


def level_n_pos(pos, level):
    """Level-0 coords -> level-N coords (LevelHelpers.h:35-45)."""
    return (pos + 0.5) / level_scale(level) - 0.5
