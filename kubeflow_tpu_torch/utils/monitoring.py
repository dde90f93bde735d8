"""Prometheus-style metrics: the part of kubeflow_tpu.utils.monitoring the
serving engine uses, copied so the port imports nothing of the JAX
package.

``Counter``, ``Gauge`` and ``Histogram`` (with per-band exemplars) live in
a ``MetricsRegistry`` that renders the text exposition format; names are
the same ``kftpu_serving_*`` the JAX engine registers. The read side is
kept to counts, exemplars and the exposition text.
"""

from __future__ import annotations

import bisect
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

LabelKV = Tuple[Tuple[str, str], ...]

DEFAULT_LATENCY_BUCKETS = (
    0.00005, 0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005,
    0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
)

#: Labelsets per histogram whose exemplars are retained.
EXEMPLAR_LABELSET_CAP = 64


def _fmt_value(v: float) -> str:
    f = float(v)
    if f != f:
        return "NaN"
    if f in (float("inf"), float("-inf")):
        return "+Inf" if f > 0 else "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _fmt_labels(labels: LabelKV) -> str:
    if not labels:
        return ""
    esc = lambda v: (str(v).replace("\\", "\\\\").replace('"', '\\"')  # noqa: E731
                     .replace("\n", "\\n"))
    return "{" + ",".join(f'{k}="{esc(v)}"' for k, v in labels) + "}"


def _label_key(kind: str, name: str, label_names: Tuple[str, ...],
               labels: Dict[str, str]) -> LabelKV:
    if set(labels) != set(label_names):
        raise ValueError(f"{kind} {name} expects labels {label_names}, "
                         f"got {tuple(sorted(labels))}")
    return tuple(sorted(labels.items()))


class Counter:
    def __init__(self, name: str, help_: str,
                 label_names: Tuple[str, ...] = ()):
        self.name = name
        self.help = help_
        self.label_names = tuple(label_names)
        self._values: Dict[LabelKV, float] = {}
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        key = _label_key("counter", self.name, self.label_names, labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels: str) -> float:
        key = _label_key("counter", self.name, self.label_names, labels)
        with self._lock:
            return self._values.get(key, 0.0)

    def render(self) -> List[str]:
        out = [f"# HELP {self.name} {self.help}",
               f"# TYPE {self.name} counter"]
        with self._lock:
            items = sorted(self._values.items())
        if not items and not self.label_names:
            out.append(f"{self.name} 0")
        for labels, v in items:
            out.append(f"{self.name}{_fmt_labels(labels)} {_fmt_value(v)}")
        return out


class Gauge:
    def __init__(self, name: str, help_: str,
                 label_names: Tuple[str, ...] = ()):
        self.name = name
        self.help = help_
        self.label_names = tuple(label_names)
        self._values: Dict[LabelKV, float] = {}
        self._lock = threading.Lock()

    def set(self, v: float, **labels: str) -> None:
        key = _label_key("gauge", self.name, self.label_names, labels)
        with self._lock:
            self._values[key] = float(v)

    def value(self, **labels: str) -> float:
        key = _label_key("gauge", self.name, self.label_names, labels)
        with self._lock:
            return self._values.get(key, 0.0)

    def render(self) -> List[str]:
        out = [f"# HELP {self.name} {self.help}",
               f"# TYPE {self.name} gauge"]
        if not self.label_names:
            out.append(f"{self.name} {_fmt_value(self.value())}")
            return out
        with self._lock:
            items = sorted(self._values.items())
        for labels, v in items:
            out.append(f"{self.name}{_fmt_labels(labels)} {_fmt_value(v)}")
        return out


class Histogram:
    """Cumulative ``_bucket{le=...}`` counts plus ``_sum``/``_count``.
    ``observe(v, exemplar=id)`` pins ``id`` to v's bucket band
    (latest-wins); the serving engine passes ``req:<rid>``."""

    def __init__(self, name: str, help_: str,
                 label_names: Tuple[str, ...] = (),
                 buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS):
        bs = sorted(set(float(b) for b in buckets))
        if not bs or any(b != b or abs(b) == float("inf") for b in bs):
            raise ValueError(f"histogram {name}: needs finite buckets "
                             "(+Inf is implicit)")
        self.name = name
        self.help = help_
        self.label_names = tuple(label_names)
        self.buckets = tuple(bs)
        self._counts: Dict[LabelKV, List[int]] = {}
        self._sums: Dict[LabelKV, float] = {}
        self._exemplars: Dict[LabelKV, Dict[int, Tuple[int, str, float]]] = {}
        self._exemplar_seq = 0
        self._lock = threading.Lock()

    def observe(self, value: float, exemplar: Optional[str] = None,
                **labels: str) -> None:
        key = _label_key("histogram", self.name, self.label_names, labels)
        v = float(value)
        with self._lock:
            counts = self._counts.get(key)
            if counts is None:
                counts = self._counts[key] = [0] * (len(self.buckets) + 1)
                self._sums[key] = 0.0
            band = bisect.bisect_left(self.buckets, v)
            counts[band] += 1
            self._sums[key] += v
            if exemplar:
                ex = self._exemplars.get(key)
                if ex is None:
                    if len(self._exemplars) >= EXEMPLAR_LABELSET_CAP:
                        return
                    ex = self._exemplars[key] = {}
                self._exemplar_seq += 1
                ex[band] = (self._exemplar_seq, exemplar, v)

    def count(self, **labels: str) -> int:
        """Observations over every labelset matching the label subset."""
        want = set(labels.items())
        with self._lock:
            return sum(sum(c) for k, c in self._counts.items()
                       if want <= set(k))

    def exemplars(self, **labels: str) -> List[Dict[str, object]]:
        """Retained exemplars of the matching labelsets, newest first."""
        want = set(labels.items())
        out = []
        with self._lock:
            for key, ex in self._exemplars.items():
                if not want <= set(key):
                    continue
                for band, (seq, trace_id, v) in ex.items():
                    le = (self.buckets[band] if band < len(self.buckets)
                          else float("inf"))
                    out.append({"seq": seq, "le": le, "trace_id": trace_id,
                                "value": v, "labels": dict(key)})
        out.sort(key=lambda e: -e["seq"])
        for e in out:
            del e["seq"]
        return out

    def render(self) -> List[str]:
        out = [f"# HELP {self.name} {self.help}",
               f"# TYPE {self.name} histogram"]
        with self._lock:
            items = sorted((k, list(c), self._sums[k])
                           for k, c in self._counts.items())
        for labels, bands, total in items:
            cum = 0
            for le, c in zip(self.buckets, bands):
                cum += c
                lv = labels + (("le", _fmt_value(le)),)
                out.append(f"{self.name}_bucket{_fmt_labels(lv)} {cum}")
            cum += bands[-1]
            lv = labels + (("le", "+Inf"),)
            out.append(f"{self.name}_bucket{_fmt_labels(lv)} {cum}")
            out.append(
                f"{self.name}_sum{_fmt_labels(labels)} {_fmt_value(total)}")
            out.append(f"{self.name}_count{_fmt_labels(labels)} {cum}")
        return out


def nearest_rank_quantile(values: Sequence[float], q: float) -> float:
    """Nearest-rank q-quantile of raw observations (0.0 when empty)."""
    if not values:
        return 0.0
    xs = sorted(values)
    return xs[min(len(xs) - 1, int(q * len(xs)))]


class MetricsRegistry:
    """Metrics by unique name; registering an existing name returns the
    existing instance."""

    def __init__(self) -> None:
        self._metrics: Dict[str, object] = {}
        self._lock = threading.Lock()

    def _register(self, name: str, cls: type,
                  factory: Callable[[], object]):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = factory()
        if not isinstance(m, cls):
            raise ValueError(
                f"metric {name} already registered as {type(m).__name__}")
        return m

    def counter(self, name: str, help_: str,
                labels: Tuple[str, ...] = ()) -> Counter:
        return self._register(name, Counter,
                              lambda: Counter(name, help_, labels))

    def gauge(self, name: str, help_: str,
              labels: Tuple[str, ...] = ()) -> Gauge:
        return self._register(name, Gauge, lambda: Gauge(name, help_, labels))

    def histogram(self, name: str, help_: str,
                  labels: Tuple[str, ...] = (),
                  buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS
                  ) -> Histogram:
        return self._register(
            name, Histogram, lambda: Histogram(name, help_, labels, buckets))

    def get(self, name: str) -> Optional[object]:
        with self._lock:
            return self._metrics.get(name)

    def render(self) -> str:
        with self._lock:
            metrics = list(self._metrics.values())
        lines: List[str] = []
        for m in metrics:
            lines.extend(m.render())  # type: ignore[attr-defined]
        return "\n".join(lines) + "\n"


global_registry = MetricsRegistry()
