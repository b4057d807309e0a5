"""The single-stream inference engine and the parallel-slot scheduler."""

from .engine import Engine, GenerationConfig, StopMatcher
from .scheduler import QueueFull, SlotScheduler

__all__ = ["Engine", "GenerationConfig", "QueueFull", "SlotScheduler",
           "StopMatcher"]
