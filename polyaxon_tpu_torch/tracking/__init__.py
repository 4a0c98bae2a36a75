"""Tracking of the port (a copy of the JAX package's ``tracking``): event
files under the run's artifacts directory and, when the control plane's
API host is given, statuses, outputs, heartbeats and lineage sent there."""

from .events import (
    V1ArtifactKind,
    V1Event,
    V1EventArtifact,
    V1EventConfusion,
    V1EventCurve,
    V1EventHistogram,
    V1EventImage,
    V1EventKind,
    V1EventSpan,
    V1RunArtifact,
)
from .resources import ResourceLogger
from .run import (
    Run, end, get_run, init, log_artifact, log_metrics, log_outputs,
)
from .spool import EventSpool
from .writer import EventFileWriter, LogWriter, list_event_names, read_events
