"""Failure handling of the port: the HTTP retry policy and the trainer's
and serving engine's fault injection (copies of the JAX package's)."""

from .chaos import ServeChaos, TrainerChaos
from .retry import DEFAULT_HTTP_RETRY, RetryPolicy

__all__ = ["DEFAULT_HTTP_RETRY", "RetryPolicy", "ServeChaos", "TrainerChaos"]
