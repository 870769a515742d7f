"""Process-global MetricsPlane: labeled metrics with an OpenMetrics
exposition — the port's copy of ``src/repro/obs/metrics.py`` (it imports
no JAX; what differs is named below).

Where the span :class:`~repro_torch.obs.recorder.Recorder` answers "what
happened during *this* run" (a bounded timeline you export once), the
MetricsPlane is the *continuous* layer a long-lived service scrapes:
monotone counters, point-in-time gauges, and latency histograms keyed by
small label sets, aggregated since process start.

Three metric kinds, all label-aware:

* :class:`CounterFamily`   — monotone ``inc``; exposed with the
  ``_total`` suffix OpenMetrics requires.
* :class:`GaugeFamily`     — ``set``; point-in-time values (live buffer
  bytes, kernel cost of a plan).
* :class:`HistogramFamily` — log-scaled **fixed** buckets plus a bounded
  ring of recent raw samples from which ``percentile`` is *exact*
  (numpy-equivalent linear interpolation) while the window has not
  evicted samples.

Label sets are cardinality-capped per family
(:data:`LABEL_CARDINALITY_CAP`): the first N distinct label sets get
their own child; later ones fold into a single ``overflow="true"`` child
and bump the plane's ``repro_metric_labels_dropped`` counter.

The process-global plane is **disabled** by default: every producer
(``EngineBase._dispatch``, the ops wrappers) guards with one attribute
read (``plane.enabled``), and a disabled plane changes no results and no
dispatch or launch counts — the same contract as ``instrument=False``
(``tests/test_torch_obs.py``).  Install one for a scope with::

    with obs.collecting_metrics() as plane:
        engine.run()
    text = plane.to_openmetrics()      # Prometheus scrape body
    snap = plane.snapshot()            # round-trippable JSON

**What differs from the reference.**  PyTorch compiles nothing per plan,
so the reference's compile accounting becomes build accounting: a
dispatch during which ``kernels/_build.py`` compiled a library is a
"build" dispatch, :meth:`MetricsPlane.note_build` counts them per plan
(``repro_plan_builds``, the reference's ``repro_plan_compiles``) and warns
once past :data:`RETRACE_STORM_THRESHOLD` (``repro_rebuild_storms``, the
reference's ``repro_retrace_storms``).  :class:`MetricsServer` arms the
FaultPlane's ``"metrics-server"`` point on every scrape and answers 503
when it fires, as the reference does.
"""
from __future__ import annotations

import collections
import contextlib
import http.server
import json
import math
import re
import threading
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

#: distinct label sets per metric family before folding into overflow
LABEL_CARDINALITY_CAP = 64

#: raw samples each histogram child retains for exact percentiles
HISTOGRAM_RING = 1024

#: builds of one (family, plan) label set before a storm warning (the
#: reference's compile threshold; ``analysis.retrace`` lints with it too)
RETRACE_STORM_THRESHOLD = 8

_LABELS_KEY = Tuple[Tuple[str, str], ...]

#: reserved label set new children fold into past the cardinality cap
_OVERFLOW_LABELS: _LABELS_KEY = (("overflow", "true"),)


class RetraceStormWarning(UserWarning):
    """One (family, plan) signature keeps building kernel libraries — a
    library path is churning and the build cache is useless for it."""


def log_buckets(lo: float = 1e-6, hi: float = 100.0,
                per_decade: int = 4) -> Tuple[float, ...]:
    """Log-spaced fixed bucket upper bounds covering [lo, hi].

    Default: 1µs…100s at 4 buckets per decade (33 bounds) — wide enough
    for a kernel build (seconds) and a steady-state dispatch (µs–ms) to land
    in distinct, well-resolved buckets.  ``+Inf`` is implicit.
    """
    if not (lo > 0 and hi > lo and per_decade >= 1):
        raise ValueError(f"bad bucket spec lo={lo} hi={hi} "
                         f"per_decade={per_decade}")
    n = int(round(math.log10(hi / lo) * per_decade))
    return tuple(lo * 10 ** (i / per_decade) for i in range(n + 1))


def _labels_key(labels: Dict[str, str]) -> _LABELS_KEY:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _escape_label_value(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _render_labels(key: _LABELS_KEY, extra: Tuple[Tuple[str, str], ...] = ()
                   ) -> str:
    items = key + extra
    if not items:
        return ""
    body = ",".join(f'{k}="{_escape_label_value(v)}"' for k, v in items)
    return "{" + body + "}"


def _fmt(v: float) -> str:
    """Number formatting for exposition: ints stay ints, floats use
    repr (round-trippable)."""
    if isinstance(v, bool):
        return "1" if v else "0"
    if float(v).is_integer() and abs(v) < 2 ** 53:
        return str(int(v))
    return repr(float(v))


# -- children ------------------------------------------------------------------

class _Value:
    """A counter/gauge child: one labeled time series."""

    __slots__ = ("value",)

    def __init__(self, value: float = 0.0):
        self.value = value

    def inc(self, amount: float = 1.0) -> None:
        self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.value -= amount

    def set(self, value: float) -> None:
        self.value = float(value)


class _HistValue:
    """A histogram child: fixed cumulative-ready bucket counts, running
    sum/count, and a bounded ring of recent raw samples for exact
    percentiles."""

    __slots__ = ("bounds", "counts", "sum", "count", "ring")

    def __init__(self, bounds: Tuple[float, ...],
                 ring: int = HISTOGRAM_RING):
        self.bounds = bounds
        self.counts = [0] * (len(bounds) + 1)   # last slot = +Inf
        self.sum = 0.0
        self.count = 0
        self.ring: collections.deque = collections.deque(maxlen=ring)

    def observe(self, value: float) -> None:
        v = float(value)
        # first bound >= v (linear scan is fine: ~33 bounds, and the
        # common case — small latencies — exits early)
        i = 0
        for i, b in enumerate(self.bounds):
            if v <= b:
                break
        else:
            i = len(self.bounds)
        self.counts[i] += 1
        self.sum += v
        self.count += 1
        self.ring.append(v)

    def percentile(self, q: float) -> float:
        """Exact percentile (numpy 'linear' method) over the retained
        sample window; NaN before the first observation."""
        if not self.ring:
            return float("nan")
        return float(np.percentile(np.asarray(self.ring, float), q))

    @property
    def p50(self) -> float:
        return self.percentile(50.0)

    @property
    def p95(self) -> float:
        return self.percentile(95.0)

    @property
    def p99(self) -> float:
        return self.percentile(99.0)


# -- families ------------------------------------------------------------------

class _Family:
    """One named metric with labeled children."""

    kind = "untyped"

    def __init__(self, plane: "MetricsPlane", name: str, help: str):
        _check_metric_name(name)
        self.plane = plane
        self.name = name
        self.help = help
        self.children: Dict[_LABELS_KEY, object] = {}

    def _new_child(self):
        raise NotImplementedError

    def labels(self, **labels: str):
        """The child for this label set (created on first use; label
        sets past the cardinality cap fold into ``overflow="true"``)."""
        key = _labels_key(labels)
        child = self.children.get(key)
        if child is None:
            if len(self.children) >= LABEL_CARDINALITY_CAP \
                    and key != _OVERFLOW_LABELS:
                self.plane._note_dropped_label(self.name)
                return self.labels(overflow="true")
            child = self._new_child()
            self.children[key] = child
        return child

    def child_items(self) -> List[Tuple[_LABELS_KEY, object]]:
        return sorted(self.children.items())


class CounterFamily(_Family):
    kind = "counter"

    def _new_child(self):
        return _Value()

    def inc(self, amount: float = 1.0, **labels) -> None:
        self.labels(**labels).inc(amount)


class GaugeFamily(_Family):
    kind = "gauge"

    def _new_child(self):
        return _Value()

    def set(self, value: float, **labels) -> None:
        self.labels(**labels).set(value)


class HistogramFamily(_Family):
    kind = "histogram"

    def __init__(self, plane, name, help,
                 buckets: Optional[Sequence[float]] = None,
                 ring: int = HISTOGRAM_RING):
        super().__init__(plane, name, help)
        self.bounds = tuple(float(b) for b in (buckets if buckets is not None
                                               else log_buckets()))
        if list(self.bounds) != sorted(self.bounds):
            raise ValueError("histogram buckets must be sorted ascending")
        self.ring = ring

    def _new_child(self):
        return _HistValue(self.bounds, ring=self.ring)

    def observe(self, value: float, **labels) -> None:
        self.labels(**labels).observe(value)


_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")


def _check_metric_name(name: str) -> None:
    if not _NAME_RE.match(name):
        raise ValueError(f"invalid metric name {name!r}")
    if name.endswith("_total"):
        raise ValueError(f"{name!r}: declare counters without the _total "
                         "suffix; the exposition appends it")


# -- the plane -----------------------------------------------------------------

class MetricsPlane:
    """Registry of metric families + the exposition/snapshot surface.

    Construct enabled; the module-global default is a disabled instance
    (see :func:`get_plane`).  ``counter``/``gauge``/``histogram`` are
    get-or-create: calling them twice with the same name returns the
    same family (a kind mismatch raises).
    """

    def __init__(self, enabled: bool = True, *,
                 retrace_storm_threshold: int = RETRACE_STORM_THRESHOLD):
        self.enabled = enabled
        self.families: Dict[str, _Family] = {}
        self.retrace_storm_threshold = retrace_storm_threshold
        self._build_counts: Dict[Tuple[str, str], int] = {}
        self._warned_storms: set = set()

    # -- family constructors ----------------------------------------------
    def _family(self, cls, name: str, help: str, **kw) -> _Family:
        fam = self.families.get(name)
        if fam is None:
            fam = cls(self, name, help, **kw)
            self.families[name] = fam
        elif not isinstance(fam, cls):
            raise ValueError(f"metric {name!r} already registered as "
                             f"{fam.kind}")
        return fam

    def counter(self, name: str, help: str = "") -> CounterFamily:
        return self._family(CounterFamily, name, help)

    def gauge(self, name: str, help: str = "") -> GaugeFamily:
        return self._family(GaugeFamily, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Optional[Sequence[float]] = None,
                  ring: int = HISTOGRAM_RING) -> HistogramFamily:
        return self._family(HistogramFamily, name, help, buckets=buckets,
                            ring=ring)

    # -- producer-side helpers --------------------------------------------
    def _note_dropped_label(self, name: str) -> None:
        fam = self.counter("repro_metric_labels_dropped",
                           "label sets folded into overflow past the "
                           "cardinality cap")
        key = _labels_key({"metric": name})
        child = fam.children.get(key)
        if child is None and len(fam.children) >= LABEL_CARDINALITY_CAP:
            return      # the drop counter itself stays bounded
        fam.labels(metric=name).inc()

    def note_build(self, family: str, plan: str) -> None:
        """Record one dispatch of (engine family, plan signature) during
        which a kernel library was built; warn once per plan when the
        same signature keeps building."""
        key = (family, plan)
        n = self._build_counts.get(key, 0) + 1
        self._build_counts[key] = n
        self.counter("repro_plan_builds",
                     "dispatches that built a kernel library, per (engine "
                     "family, plan signature)").inc(family=family, plan=plan)
        if n >= self.retrace_storm_threshold and key not in \
                self._warned_storms:
            self._warned_storms.add(key)
            self.counter("repro_rebuild_storms",
                         "plans that built kernel libraries past the storm "
                         "threshold").inc(family=family)
            warnings.warn(
                f"rebuild storm: {plan} built kernels in {n} dispatches "
                f"(threshold {self.retrace_storm_threshold}) — a library "
                "path is churning", RetraceStormWarning, stacklevel=2)

    # -- exposition --------------------------------------------------------
    def to_openmetrics(self) -> str:
        """Prometheus/OpenMetrics text exposition of every family."""
        lines: List[str] = []
        for name in sorted(self.families):
            fam = self.families[name]
            exposed = name + ("_total" if fam.kind == "counter" else "")
            if fam.help:
                lines.append(f"# HELP {exposed} "
                             f"{fam.help.replace(chr(10), ' ')}")
            lines.append(f"# TYPE {exposed} {fam.kind}")
            for key, child in fam.child_items():
                if fam.kind == "histogram":
                    acc = 0
                    for b, c in zip(child.bounds, child.counts):
                        acc += c
                        lines.append(
                            f"{name}_bucket"
                            f"{_render_labels(key, (('le', _fmt(b)),))} "
                            f"{acc}")
                    lines.append(
                        f"{name}_bucket"
                        f"{_render_labels(key, (('le', '+Inf'),))} "
                        f"{child.count}")
                    lines.append(f"{name}_sum{_render_labels(key)} "
                                 f"{_fmt(child.sum)}")
                    lines.append(f"{name}_count{_render_labels(key)} "
                                 f"{child.count}")
                else:
                    lines.append(f"{exposed}{_render_labels(key)} "
                                 f"{_fmt(child.value)}")
        return "\n".join(lines) + ("\n" if lines else "")

    # -- JSON snapshot ----------------------------------------------------
    def snapshot(self) -> dict:
        """Round-trippable JSON view (see :func:`load_snapshot`)."""
        fams = {}
        for name, fam in sorted(self.families.items()):
            f: dict = {"kind": fam.kind, "help": fam.help, "children": []}
            if fam.kind == "histogram":
                f["buckets"] = list(fam.bounds)
                f["ring"] = fam.ring
            for key, child in fam.child_items():
                c: dict = {"labels": dict(key)}
                if fam.kind == "histogram":
                    c.update(counts=list(child.counts), sum=child.sum,
                             count=child.count, ring=list(child.ring),
                             p50=child.p50, p95=child.p95, p99=child.p99)
                else:
                    c["value"] = child.value
                f["children"].append(c)
            fams[name] = f
        return {"metrics_schema": 1, "families": fams}

    def __repr__(self):
        state = "enabled" if self.enabled else "disabled"
        return f"MetricsPlane({state}, families={len(self.families)})"


def load_snapshot(doc: dict) -> MetricsPlane:
    """Rebuild a :class:`MetricsPlane` from :meth:`MetricsPlane.snapshot`
    (exposition-identical: ``load_snapshot(p.snapshot()).to_openmetrics()
    == p.to_openmetrics()``)."""
    if doc.get("metrics_schema") != 1:
        raise ValueError("not a MetricsPlane snapshot (metrics_schema != 1)")
    plane = MetricsPlane()
    for name, f in doc["families"].items():
        kind = f["kind"]
        if kind == "counter":
            fam = plane.counter(name, f.get("help", ""))
        elif kind == "gauge":
            fam = plane.gauge(name, f.get("help", ""))
        elif kind == "histogram":
            fam = plane.histogram(name, f.get("help", ""),
                                  buckets=f["buckets"],
                                  ring=f.get("ring", HISTOGRAM_RING))
        else:
            raise ValueError(f"unknown metric kind {kind!r}")
        for c in f["children"]:
            child = fam.labels(**c["labels"])
            if kind == "histogram":
                child.counts = list(c["counts"])
                child.sum = float(c["sum"])
                child.count = int(c["count"])
                child.ring.extend(c["ring"])
            else:
                child.value = c["value"]
    return plane


# -- a minimal OpenMetrics reader (round-trip tests, CI assertions) ------------

_SAMPLE_RE = re.compile(
    r'^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)'
    r'(?:\{(?P<labels>.*)\})?\s+(?P<value>\S+)$')
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:\\.|[^"\\])*)"')


def _unescape(v: str) -> str:
    return (v.replace("\\n", "\n").replace('\\"', '"')
            .replace("\\\\", "\\"))


def parse_openmetrics(text: str) -> Dict[str, dict]:
    """Parse an exposition back into ``{exposed_name: {"type": ...,
    "help": ..., "samples": [(sample_name, labels_dict, value)]}}``.

    Covers the subset :meth:`MetricsPlane.to_openmetrics` emits (which
    is the subset Prometheus scrapes); used by the round-trip tests and
    the CI smoke assertion.
    """
    out: Dict[str, dict] = {}
    current = None
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("# HELP "):
            _, _, rest = line.partition("# HELP ")
            name, _, help_ = rest.partition(" ")
            out.setdefault(name, {"type": "untyped", "help": "",
                                  "samples": []})["help"] = help_
            current = name
        elif line.startswith("# TYPE "):
            _, _, rest = line.partition("# TYPE ")
            name, _, kind = rest.partition(" ")
            out.setdefault(name, {"type": "untyped", "help": "",
                                  "samples": []})["type"] = kind
            current = name
        elif line.startswith("#"):
            continue
        else:
            m = _SAMPLE_RE.match(line)
            if not m:
                raise ValueError(f"unparseable sample line: {line!r}")
            sample = m.group("name")
            labels = {k: _unescape(v) for k, v in
                      _LABEL_RE.findall(m.group("labels") or "")}
            value = float(m.group("value")) \
                if m.group("value") != "+Inf" else math.inf
            # attribute histogram _bucket/_sum/_count samples to their
            # family; bare samples to the current TYPE block when the
            # names disagree (counter _total suffix)
            owner = sample
            if owner not in out and current is not None:
                owner = current
            out.setdefault(owner, {"type": "untyped", "help": "",
                                   "samples": []})
            out[owner]["samples"].append((sample, labels, value))
    return out


# -- SLO tracking --------------------------------------------------------------

class SLOTracker:
    """Sliding-window SLO on a latency stream: tracks the window's p99
    against a target and counts breaches.

    ``observe(seconds)`` appends one sample; when the window (last
    ``window`` samples, having seen at least ``min_samples``) has
    p99 > ``target_s``, the breach counter increments and the plane's
    ``repro_slo_breaches`` counter / ``repro_slo_p99_seconds`` gauge
    update (labels: the tracker's ``name``).
    """

    def __init__(self, target_s: float, *, window: int = 64,
                 min_samples: int = 8, name: str = "default",
                 plane: Optional[MetricsPlane] = None):
        if target_s <= 0:
            raise ValueError(f"target_s must be > 0, got {target_s}")
        self.target_s = float(target_s)
        self.name = name
        self.min_samples = min_samples
        self.samples: collections.deque = collections.deque(maxlen=window)
        self.breaches = 0
        self._plane = plane

    def _get_plane(self) -> MetricsPlane:
        return self._plane if self._plane is not None else get_plane()

    @property
    def p99(self) -> float:
        if not self.samples:
            return float("nan")
        return float(np.percentile(np.asarray(self.samples, float), 99.0))

    @property
    def breached(self) -> bool:
        return (len(self.samples) >= self.min_samples
                and self.p99 > self.target_s)

    def observe(self, seconds: float) -> bool:
        """Add one sample; returns whether the window is in breach."""
        self.samples.append(float(seconds))
        breach = self.breached
        if breach:
            self.breaches += 1
        plane = self._get_plane()
        if plane.enabled:
            plane.gauge("repro_slo_p99_seconds",
                        "sliding-window p99 latency tracked against the "
                        "SLO target").set(self.p99, slo=self.name)
            plane.gauge("repro_slo_target_seconds",
                        "SLO latency target").set(self.target_s,
                                                  slo=self.name)
            fam = plane.counter("repro_slo_breaches",
                                "windows whose p99 exceeded the SLO "
                                "target")
            fam.labels(slo=self.name).inc(1 if breach else 0)
        return breach


# -- /metrics endpoint ---------------------------------------------------------

class MetricsServer:
    """Stdlib ``/metrics`` + ``/healthz`` endpoint on a daemon thread.

    ``plane_getter`` is called per scrape (so a freshly-installed global
    plane is picked up); ``health_getter`` returns a JSON-serializable
    health payload for ``/healthz``.
    """

    def __init__(self, port: int, *, host: str = "127.0.0.1",
                 plane_getter=None, health_getter=None):
        plane_getter = plane_getter or get_plane
        health_getter = health_getter or (lambda: {"status": "ok"})

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):                      # noqa: N802 (stdlib API)
                from ..fault.plane import get_fault_plane
                try:
                    get_fault_plane().arm("metrics-server", path=self.path)
                except OSError as e:               # injected IOFault
                    self.send_error(503, f"injected fault: {e}")
                    return
                path = self.path.split("?", 1)[0]
                if path == "/metrics":
                    body = plane_getter().to_openmetrics().encode()
                    ctype = "text/plain; version=0.0.4; charset=utf-8"
                elif path == "/healthz":
                    body = (json.dumps(health_getter()) + "\n").encode()
                    ctype = "application/json"
                else:
                    self.send_error(404, "try /metrics or /healthz")
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):          # quiet scrapes
                pass

        self._httpd = http.server.ThreadingHTTPServer((host, port), Handler)
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="repro-metrics", daemon=True)
        self._thread.start()

    @property
    def port(self) -> int:
        """The bound port (useful with ``port=0``)."""
        return self._httpd.server_address[1]

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)


# -- process-global plumbing ---------------------------------------------------

_PLANE = MetricsPlane(enabled=False)


def get_plane() -> MetricsPlane:
    """The process-global plane (disabled unless one was installed)."""
    return _PLANE


def set_plane(plane: MetricsPlane) -> MetricsPlane:
    """Install ``plane`` as the process-global plane; returns the
    previous one (so callers can restore it)."""
    global _PLANE
    prev = _PLANE
    _PLANE = plane
    return prev


@contextlib.contextmanager
def collecting_metrics(plane: Optional[MetricsPlane] = None):
    """Install an enabled plane for the scope of the ``with`` block and
    restore the previous global on exit (exception included).  Yields
    the plane."""
    mp = MetricsPlane() if plane is None else plane
    prev = set_plane(mp)
    try:
        yield mp
    finally:
        set_plane(prev)


__all__ = [
    "MetricsPlane", "CounterFamily", "GaugeFamily", "HistogramFamily",
    "SLOTracker", "MetricsServer", "RetraceStormWarning",
    "get_plane", "set_plane", "collecting_metrics", "load_snapshot",
    "parse_openmetrics", "log_buckets",
    "LABEL_CARDINALITY_CAP", "HISTOGRAM_RING", "RETRACE_STORM_THRESHOLD",
]
