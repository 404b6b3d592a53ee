"""The web front end: the HTTP API of the task agent and the pathline viewer
(mirror of mops_tpu.frontend)."""

from .server import create_server, serve

__all__ = ["create_server", "serve"]
