"""Shared utilities: the engine's event stream."""

from .events import Event, done, log, serving_identity, token

__all__ = ["Event", "done", "log", "serving_identity", "token"]
