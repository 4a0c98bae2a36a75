"""Observability of the port: Prometheus-style metrics and the heartbeat's
metrics-history buffer."""

from .history import SeriesBuffer  # noqa: F401
from .metrics import MetricsRegistry, parse_prometheus  # noqa: F401
