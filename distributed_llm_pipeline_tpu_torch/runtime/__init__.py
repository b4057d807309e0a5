"""The single-stream inference engine."""

from .engine import Engine, GenerationConfig, StopMatcher

__all__ = ["Engine", "GenerationConfig", "StopMatcher"]
