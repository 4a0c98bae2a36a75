"""Event schema of the port's tracking — its own copy of
``polyaxon_tpu/tracking/events.py`` with dataclasses in place of pydantic.

Events serialize as the JAX package's do (``schemas/base.py``: camelCase
keys, ``None`` fields left out), one JSON object per line, so either
package reads the other's event files into equal events.
"""

from __future__ import annotations

import dataclasses
import datetime
import json
from dataclasses import dataclass, field
from typing import Any, Optional


def to_camel(s: str) -> str:
    parts = s.split("_")
    return parts[0] + "".join(p.title() for p in parts[1:])


def _dump(value: Any, exclude_none: bool) -> Any:
    if isinstance(value, Schema):
        return value.to_dict(exclude_none)
    if isinstance(value, dict):
        return {k: _dump(v, exclude_none) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_dump(v, exclude_none) for v in value]
    return value


class Schema:
    """camelCase wire format, unknown keys refused (the JAX package's
    ``BaseSchema`` contract). ``_nested`` names the fields that hold
    another schema (a mapping given there is parsed into it); ``_floats``
    those whose numbers are floats — both coerced on construction, as
    pydantic does."""

    _nested: dict = {}
    _floats: tuple = ()

    def __post_init__(self) -> None:
        for name, cls in self._nested.items():
            value = getattr(self, name)
            if isinstance(value, dict):
                setattr(self, name, cls.from_dict(value))
        for name in self._floats:
            value = getattr(self, name)
            if isinstance(value, list):
                setattr(self, name, [float(v) for v in value])
            elif value is not None:
                setattr(self, name, float(value))

    def to_dict(self, exclude_none: bool = True) -> dict[str, Any]:
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if v is None and exclude_none:
                continue
            out[to_camel(f.name)] = _dump(v, exclude_none)
        return out

    @classmethod
    def from_dict(cls, data: dict[str, Any]):
        if not isinstance(data, dict):
            raise ValueError(f"{cls.__name__} needs a mapping, got {type(data).__name__}")
        names = {f.name: f.name for f in dataclasses.fields(cls)}
        names.update({to_camel(n): n for n in list(names)})
        unknown = sorted(set(data) - set(names))
        if unknown:
            raise ValueError(f"{cls.__name__}: unknown field(s) {unknown}")
        return cls(**{names[k]: v for k, v in data.items()})


class V1EventKind:
    METRIC = "metric"
    IMAGE = "image"
    HISTOGRAM = "histogram"
    AUDIO = "audio"
    VIDEO = "video"
    TEXT = "text"
    HTML = "html"
    CHART = "chart"
    CURVE = "curve"
    CONFUSION = "confusion"
    ARTIFACT = "artifact"
    MODEL = "model"
    DATAFRAME = "dataframe"
    SPAN = "span"

    ALL = {METRIC, IMAGE, HISTOGRAM, AUDIO, VIDEO, TEXT, HTML, CHART, CURVE,
           CONFUSION, ARTIFACT, MODEL, DATAFRAME, SPAN}


@dataclass
class V1EventImage(Schema):
    path: Optional[str] = None
    width: Optional[int] = None
    height: Optional[int] = None


@dataclass
class V1EventHistogram(Schema):
    values: list = field(default_factory=list)
    counts: list = field(default_factory=list)
    _floats = ("values", "counts")


@dataclass
class V1EventArtifact(Schema):
    kind: Optional[str] = None
    path: Optional[str] = None


@dataclass
class V1EventCurve(Schema):
    """An x/y curve sampled at one step (roc / pr / calibration)."""

    x: list = field(default_factory=list)
    y: list = field(default_factory=list)
    annotation: Optional[str] = None
    _floats = ("x", "y")


@dataclass
class V1EventConfusion(Schema):
    """A confusion matrix at one step: ``x``/``y`` the predicted/actual
    label axes, ``z`` the row-major counts."""

    x: list = field(default_factory=list)
    y: list = field(default_factory=list)
    z: list = field(default_factory=list)

    def __post_init__(self) -> None:
        self.z = [[float(v) for v in row] for row in self.z]
        super().__post_init__()


@dataclass
class V1EventSpan(Schema):
    """A tracing span on the epoch clock (the run timeline's unit)."""

    name: Optional[str] = None
    start: Optional[float] = None
    end: Optional[float] = None
    meta: Optional[dict] = None
    _floats = ("start", "end")


@dataclass
class V1Event(Schema):
    timestamp: Optional[str] = None
    step: Optional[int] = None
    metric: Optional[float] = None
    image: Optional[V1EventImage] = None
    histogram: Optional[V1EventHistogram] = None
    text: Optional[str] = None
    html: Optional[str] = None
    artifact: Optional[V1EventArtifact] = None
    span: Optional[V1EventSpan] = None
    curve: Optional[V1EventCurve] = None
    confusion: Optional[V1EventConfusion] = None
    _nested = {"image": V1EventImage, "histogram": V1EventHistogram,
               "artifact": V1EventArtifact, "span": V1EventSpan,
               "curve": V1EventCurve, "confusion": V1EventConfusion}
    _floats = ("metric",)

    @classmethod
    def make(cls, step: Optional[int] = None, **kwargs: Any) -> "V1Event":
        return cls(
            timestamp=datetime.datetime.now(datetime.timezone.utc).isoformat(),
            step=step,
            **kwargs,
        )

    @property
    def kind(self) -> str:
        for k in ("metric", "image", "histogram", "text", "html", "artifact",
                  "span", "curve", "confusion"):
            if getattr(self, k) is not None:
                return k
        return V1EventKind.METRIC

    def to_jsonl(self) -> str:
        return json.dumps(self.to_dict(), separators=(",", ":"))

    @classmethod
    def from_jsonl(cls, line: str) -> "V1Event":
        return cls.from_dict(json.loads(line))


class V1ArtifactKind:
    """Lineage artifact kinds."""

    MODEL = "model"
    AUDIO = "audio"
    VIDEO = "video"
    DATASET = "dataset"
    DATAFRAME = "dataframe"
    IMAGE = "image"
    TENSORBOARD = "tensorboard"
    CODEREF = "coderef"
    FILE = "file"
    DIR = "dir"
    DOCKERFILE = "dockerfile"
    METRIC = "metric"
    ENV = "env"
    CHECKPOINT = "checkpoint"
    PROFILE = "profile"  # torch.profiler traces

    ALL = {MODEL, AUDIO, VIDEO, DATASET, DATAFRAME, IMAGE, TENSORBOARD,
           CODEREF, FILE, DIR, DOCKERFILE, METRIC, ENV, CHECKPOINT, PROFILE}


@dataclass
class V1RunArtifact(Schema):
    """Lineage record linking a run to an artifact."""

    name: Optional[str] = None
    kind: Optional[str] = None
    path: Optional[str] = None
    state: Optional[str] = None
    summary: Optional[dict] = None
    is_input: Optional[bool] = None
