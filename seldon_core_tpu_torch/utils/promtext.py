"""A small Prometheus metrics writer: counters, gauges and histograms with
label sets, rendered as the Prometheus text format (0.0.4) and as
OpenMetrics 1.0 with exemplars.

The JAX package builds its families with ``prometheus_client``; the port
stands on torch and the standard library alone, so it writes the same
families itself.  The API is the subset the flight recorder and the
metrics registry use (``CollectorRegistry``, ``Counter``, ``Gauge``,
``Histogram``, ``.labels(...)``, ``inc`` / ``set`` / ``observe`` with an
exemplar, ``generate_latest`` / ``generate_latest_openmetrics``), and the
output follows that library's layout: a counter ``x_total`` is the family
``x`` with ``x_total`` and ``x_created`` samples, a histogram's buckets end
at ``+Inf`` and carry their cumulative counts, numbers are spelled as Go
spells them, and OpenMetrics exemplars ride histogram buckets only.  A
scraper sees the same families, types, label sets and values.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = [
    "CONTENT_TYPE_LATEST",
    "OPENMETRICS_CONTENT_TYPE",
    "CollectorRegistry",
    "Counter",
    "Gauge",
    "Histogram",
    "generate_latest",
    "generate_latest_openmetrics",
    "float_to_go_string",
]

CONTENT_TYPE_LATEST = "text/plain; version=0.0.4; charset=utf-8"
OPENMETRICS_CONTENT_TYPE = "application/openmetrics-text; version=1.0.0; charset=utf-8"

_INF = float("inf")


def float_to_go_string(d) -> str:
    """A number as Go's ``strconv.FormatFloat(f, 'g', -1, 64)`` spells it
    for the values a metric takes (``+Inf``, ``NaN``, exponents past six
    integer digits)."""
    d = float(d)
    if d == _INF:
        return "+Inf"
    if d == -_INF:
        return "-Inf"
    if math.isnan(d):
        return "NaN"
    s = repr(d)
    dot = s.find(".")
    if d > 0 and dot > 6:
        mantissa = f"{s[0]}.{s[1:dot]}{s[dot + 1:]}".rstrip("0.")
        return f"{mantissa}e+0{dot - 1}"
    return s


def _escape_value(v: str) -> str:
    return v.replace("\\", r"\\").replace("\n", r"\n").replace('"', r"\"")


def _escape_help(doc: str) -> str:
    return doc.replace("\\", r"\\").replace("\n", r"\n")


def _labelstr(labels: Sequence[Tuple[str, str]]) -> str:
    if not labels:
        return ""
    return "{" + ",".join(f'{k}="{_escape_value(v)}"' for k, v in sorted(labels)) + "}"


class CollectorRegistry:
    """The families of one exposition, in registration order."""

    def __init__(self):
        self._metrics: List["_Metric"] = []
        self._lock = threading.Lock()

    def register(self, metric: "_Metric") -> None:
        with self._lock:
            if any(m.name == metric.name for m in self._metrics):
                raise ValueError(f"duplicated family {metric.name!r}")
            self._metrics.append(metric)

    def collect(self) -> List["_Metric"]:
        with self._lock:
            return list(self._metrics)


class _Child:
    """One label set's value(s)."""

    __slots__ = ("_lock", "value", "created", "buckets", "exemplars", "sum", "_bounds")

    def __init__(self, bounds: Optional[Tuple[float, ...]] = None):
        self._lock = threading.Lock()
        self.value = 0.0
        self.created = time.time()
        self._bounds = bounds
        if bounds is not None:
            self.buckets = [0.0] * len(bounds)
            self.exemplars: List[Optional[tuple]] = [None] * len(bounds)
            self.sum = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters can only be incremented by non-negative amounts")
        with self._lock:
            self.value += float(amount)

    def set(self, value: float) -> None:
        with self._lock:
            self.value = float(value)

    def observe(self, amount: float, exemplar: Optional[Dict[str, str]] = None) -> None:
        amount = float(amount)
        with self._lock:
            self.sum += amount
            for i, bound in enumerate(self._bounds):
                if amount <= bound:
                    self.buckets[i] += 1.0
                    if exemplar:
                        if sum(len(k) + len(v) for k, v in exemplar.items()) > 128:
                            raise ValueError("exemplar labels exceed 128 characters")
                        self.exemplars[i] = (dict(exemplar), amount, time.time())
                    break


    def add_counts(self, counts: Sequence[float], total: float) -> None:
        """Add ``counts[i]`` observations to bucket i (per bucket, not
        cumulative) and ``total`` to the sum: a histogram observed
        elsewhere, merged whole."""
        if len(counts) != len(self._bounds):
            raise ValueError(f"{len(counts)} bucket counts for {len(self._bounds)} buckets")
        with self._lock:
            for i, n in enumerate(counts):
                self.buckets[i] += float(n)
            self.sum += float(total)


class _Metric:
    kind = ""

    def __init__(self, name: str, documentation: str, labelnames: Sequence[str] = (),
                 registry: Optional[CollectorRegistry] = None):
        self.name = name
        self.documentation = documentation
        self.labelnames = tuple(labelnames)
        self._children: Dict[Tuple[str, ...], _Child] = {}
        self._lock = threading.Lock()
        self._bounds: Optional[Tuple[float, ...]] = None
        if not self.labelnames:
            self._children[()] = self._new_child()
        if registry is not None:
            registry.register(self)

    def _new_child(self) -> _Child:
        return _Child(self._bounds)

    def labels(self, *values, **kw) -> _Child:
        if values and kw:
            raise ValueError("labels by position or by name, not both")
        if kw:
            if set(kw) != set(self.labelnames):
                raise ValueError(f"{self.name}: labels {sorted(kw)} != {list(self.labelnames)}")
            values = tuple(str(kw[n]) for n in self.labelnames)
        else:
            values = tuple(str(v) for v in values)
        if len(values) != len(self.labelnames) or not self.labelnames:
            raise ValueError(f"{self.name}: wrong label count")
        child = self._children.get(values)
        if child is None:
            with self._lock:
                child = self._children.get(values)
                if child is None:
                    child = self._children[values] = self._new_child()
        return child

    def remove(self, *values) -> None:
        """Drop one labelled child (``prometheus_client``'s ``remove``): its
        series leaves the exposition.  KeyError when there is none."""
        values = tuple(str(v) for v in values)
        if len(values) != len(self.labelnames) or not self.labelnames:
            raise ValueError(f"{self.name}: wrong label count")
        with self._lock:
            del self._children[values]

    def _root(self) -> _Child:
        if self.labelnames:
            raise ValueError(f"{self.name} has labels: call .labels(...) first")
        return self._children[()]

    def children(self) -> List[Tuple[Tuple[Tuple[str, str], ...], _Child]]:
        with self._lock:
            items = list(self._children.items())
        return [(tuple(zip(self.labelnames, vals)), child) for vals, child in items]

    def samples(self) -> List[tuple]:
        """``(suffix, labels, value, exemplar)`` rows, child by child."""
        raise NotImplementedError


class Counter(_Metric):
    kind = "counter"

    def __init__(self, name: str, documentation: str, labelnames: Sequence[str] = (),
                 registry: Optional[CollectorRegistry] = None):
        if name.endswith("_total"):
            name = name[: -len("_total")]
        super().__init__(name, documentation, labelnames, registry)

    def inc(self, amount: float = 1.0) -> None:
        self._root().inc(amount)

    def samples(self):
        out = []
        for labels, c in self.children():
            out.append(("_total", labels, c.value, None))
            out.append(("_created", labels, c.created, None))
        return out


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float) -> None:
        self._root().set(value)

    def inc(self, amount: float = 1.0) -> None:
        c = self._root()
        with c._lock:
            c.value += float(amount)

    def samples(self):
        return [("", labels, c.value, None) for labels, c in self.children()]


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name: str, documentation: str, labelnames: Sequence[str] = (),
                 registry: Optional[CollectorRegistry] = None,
                 buckets: Sequence[float] = (.005, .01, .025, .05, .075, .1, .25, .5, .75,
                                             1.0, 2.5, 5.0, 7.5, 10.0)):
        bounds = [float(b) for b in buckets]
        if bounds != sorted(bounds):
            raise ValueError("buckets not in sorted order")
        if not bounds or bounds[-1] != _INF:
            bounds.append(_INF)
        if "le" in labelnames:
            raise ValueError("'le' is reserved in a histogram")
        self._pending_bounds = tuple(bounds)
        super().__init__(name, documentation, labelnames, registry)

    def _new_child(self) -> _Child:
        return _Child(self._pending_bounds)

    def observe(self, amount: float, exemplar: Optional[Dict[str, str]] = None) -> None:
        self._root().observe(amount, exemplar)

    def samples(self):
        out = []
        for labels, c in self.children():
            acc = 0.0
            with c._lock:
                counts, exemplars, total = list(c.buckets), list(c.exemplars), c.sum
            for bound, n, ex in zip(self._pending_bounds, counts, exemplars):
                acc += n
                out.append(("_bucket", labels + (("le", float_to_go_string(bound)),), acc, ex))
            out.append(("_count", labels, acc, None))
            out.append(("_sum", labels, total, None))
            out.append(("_created", labels, c.created, None))
        return out


def generate_latest(registry: CollectorRegistry) -> bytes:
    """The Prometheus text format (0.0.4): a counter's family is named
    ``x_total``, and every ``_created`` sample goes into a gauge family of
    its own after its metric, as ``prometheus_client`` writes them."""
    out: List[str] = []
    for m in registry.collect():
        mname = m.name + "_total" if m.kind == "counter" else m.name
        doc = _escape_help(m.documentation)
        out.append(f"# HELP {mname} {doc}\n# TYPE {mname} {m.kind}\n")
        created: List[str] = []
        for suffix, labels, value, _ex in m.samples():
            line = f"{m.name}{suffix}{_labelstr(labels)} {float_to_go_string(value)}\n"
            (created if suffix == "_created" else out).append(line)
        if created:
            out.append(f"# HELP {m.name}_created {doc}\n# TYPE {m.name}_created gauge\n")
            out.extend(created)
    return "".join(out).encode("utf-8")


def generate_latest_openmetrics(registry: CollectorRegistry, eof: bool = True) -> bytes:
    """OpenMetrics 1.0: families by base name, ``_created`` samples inside
    them, each histogram bucket's last exemplar after it, and the ``# EOF``
    terminator (left off with ``eof=False``, for a caller that appends
    more families)."""
    out: List[str] = []
    for m in registry.collect():
        out.append(f"# HELP {m.name} {_escape_value(m.documentation)}\n"
                   f"# TYPE {m.name} {m.kind}\n")
        for suffix, labels, value, ex in m.samples():
            exstr = ""
            if ex is not None:
                ex_labels, ex_value, ex_ts = ex
                exstr = f" # {_labelstr(tuple(ex_labels.items())) or '{}'} " \
                        f"{float_to_go_string(ex_value)} {ex_ts}"
            out.append(f"{m.name}{suffix}{_labelstr(labels)} "
                       f"{float_to_go_string(value)}{exstr}\n")
    if eof:
        out.append("# EOF\n")
    return "".join(out).encode("utf-8")
