"""Observability of the port: Prometheus-style metrics."""

from .metrics import MetricsRegistry, parse_prometheus  # noqa: F401
