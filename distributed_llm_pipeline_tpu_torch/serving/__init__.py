"""The /chat SSE server, the completion routes and the model registry."""

from .server import ChatServer
from .supervisor import EngineFailure, ModelRegistry, SupervisedEngine

__all__ = ["ChatServer", "EngineFailure", "ModelRegistry", "SupervisedEngine"]
