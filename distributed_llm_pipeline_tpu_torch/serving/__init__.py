"""The /chat SSE server."""

from .server import ChatServer

__all__ = ["ChatServer"]
