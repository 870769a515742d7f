"""Plan-kwarg lint, rebuild lint and generator dtype lint — the port's
counterpart of ``src/repro/analysis/retrace.py``.

Every engine's ``_plan_kwargs()`` and ``plan_signature()`` are the static
configuration a checkpoint rebuilds an engine from (ROADMAP A8) and a
metrics label keys on (A7).  A kwarg that is unhashable, non-canonical (a
numpy scalar instead of a Python int) or ``NaN`` (``NaN != NaN``, so no
two plans ever compare equal) makes every replan a new configuration.
Under jit that is a retrace storm; PyTorch traces nothing, so the lint
keeps the reference's rules for the keys' sake.  The port's own storm is
a rebuild storm: a kernel library whose path is not stable from call to
call, or two sources sharing one library, would rebuild a kernel on
every load (``rebuild-storm``).

The generator dtype lint backs the int32 edge-array contract
(``graphs/generators.py``): it rebuilds each benchmark family at a tiny
parameterization with ``CSRGraph.from_edges`` replaced by a recorder and
rejects any 64-bit edge array whose graph would fit int32.
"""
from __future__ import annotations

import math

import numpy as np

from .findings import Finding

CANONICAL_KWARG_TYPES = (bool, int, float, str, type(None))
#: compiles of one plan signature that the reference's MetricsPlane calls
#: a retrace storm (``src/repro/obs/metrics.py``); the port's copy until
#: its own metrics plane (ROADMAP A7)
RETRACE_STORM_THRESHOLD = 8

# Tiny parameterizations per benchmark family — structure-preserving,
# milliseconds to build.  A family present in BENCHMARK_GRAPHS but not
# here is itself a finding: every generator must be dtype-checked.
TINY_GRAPH_PARAMS: dict[str, dict] = {
    "ER": dict(n=256, m=1024, seed=1),
    "BA": dict(n=128, deg=4, seed=1),
    "RMAT": dict(n_log2=6, m=512, seed=1),
    "chain": dict(n=64),
    "layered": dict(n=256, layers=8, deg=2, seed=1),
    "sink_heavy": dict(n=256, m=512, sink_frac=0.5, seed=1),
}

REPLANS = 4  # identical plans built per family for the stability check


def _kwarg_findings(subject: str, kwargs: dict) -> list:
    findings: list[Finding] = []
    try:
        hash(tuple(sorted(kwargs.items())))
    except TypeError as e:
        findings.append(Finding(
            "unhashable-plan-kwargs", "error", subject,
            f"_plan_kwargs() is not hashable ({e}); it cannot key a cache "
            f"or a checkpoint round-trip"))
    for k, v in kwargs.items():
        if not isinstance(v, CANONICAL_KWARG_TYPES):
            findings.append(Finding(
                "non-canonical-kwarg", "error", subject,
                f"{k}={v!r} has type {type(v).__name__} — static plan "
                f"kwargs must be canonical python scalars (a numpy scalar "
                f"makes equal-looking plans distinct)"))
        if isinstance(v, float) and math.isnan(v):
            findings.append(Finding(
                "nan-kwarg", "error", subject,
                f"{k} is NaN; NaN != NaN makes every replan a fresh "
                f"configuration — a storm "
                f"(RETRACE_STORM_THRESHOLD={RETRACE_STORM_THRESHOLD}) "
                f"by construction"))
    return findings


def _tiny_graph():
    from ..core.graph import CSRGraph
    n = 8
    src = np.arange(n - 1, dtype=np.int32)
    return CSRGraph.from_edges(n, src, src + 1, device="cpu")


def _engine_probes():
    """(family, factory) pairs building one engine each on a tiny graph.
    The reference's ``trim-instrumented`` probe waits for ROADMAP A7
    (``instrument=True`` raises)."""
    from ..core.engine import plan
    from ..core.peel import plan_peel
    from ..core.reach import plan_reach
    from ..core.stream import plan_stream
    g = _tiny_graph()
    return (
        ("trim", lambda: plan(g, method="ac6", backend="dense", workers=2,
                              device="cpu")),
        ("reach", lambda: plan_reach(g, device="cpu")),
        ("peel", lambda: plan_peel(g, device="cpu")),
        ("stream", lambda: plan_stream(g)),
    )


def check_retrace_risk(probes=None) -> tuple[list, int]:
    """Probe each engine family: canonical kwargs + replan stability.

    ``probes`` (injection point for the mutation corpus) defaults to the
    real engine families.
    """
    if probes is None:
        probes = _engine_probes()
    findings: list[Finding] = []
    subjects = 0
    for family, factory in probes:
        subject = f"engine:{family}"
        subjects += 1
        try:
            engines = [factory() for _ in range(REPLANS)]
        except Exception as e:
            findings.append(Finding(
                "plan-failure", "error", subject,
                f"building the engine raised {type(e).__name__}: {e}"))
            continue
        findings.extend(_kwarg_findings(subject, engines[0]._plan_kwargs()))
        sigs = {e.plan_signature() for e in engines}
        try:
            kwset = {tuple(sorted(e._plan_kwargs().items()))
                     for e in engines}
        except TypeError:
            kwset = {0, 1}  # unhashable already reported; force distinct
        if len(sigs) > 1 or len(kwset) > 1:
            findings.append(Finding(
                "unstable-plan", "error", subject,
                f"{REPLANS} identical plans produced {len(sigs)} "
                f"signatures / {len(kwset)} kwarg sets — replans would "
                f"accumulate toward RETRACE_STORM_THRESHOLD="
                f"{RETRACE_STORM_THRESHOLD}"))
    return findings, subjects


def check_rebuilds(lib_path=None, sources=None) -> tuple[list, int]:
    """Each kernel source maps to one library path, stable from call to
    call, so a library is built once and then loaded.  ``lib_path`` and
    ``sources`` (injection points for the tests) default to the real
    ``kernels._build``."""
    from ..kernels import _build
    lib_path = lib_path or _build._lib_path
    if sources is None:
        sources = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    findings: list[Finding] = []
    owners: dict = {}
    for name in sources:
        subject = f"library:{name}"
        paths = {lib_path(name) for _ in range(REPLANS)}
        if len(paths) > 1:
            findings.append(Finding(
                "rebuild-storm", "error", subject,
                f"{REPLANS} lookups gave {len(paths)} library paths: every "
                f"load would rebuild the kernel"))
        for path in paths:
            other = owners.setdefault(path, name)
            if other != name:
                findings.append(Finding(
                    "rebuild-storm", "error", subject,
                    f"shares its library {path} with {other}: each build "
                    f"overwrites the other's"))
    return findings, len(sources)


def check_generator_dtypes(registry=None,
                           tiny=None) -> tuple[list, int]:
    """Rebuild each benchmark family tiny; reject 64-bit edge arrays.

    ``registry``/``tiny`` (injection points for the mutation corpus)
    default to the real ``BENCHMARK_GRAPHS`` and ``TINY_GRAPH_PARAMS``.
    """
    from ..core.graph import CSRGraph
    from ..graphs.generators import BENCHMARK_GRAPHS
    if registry is None:
        registry = BENCHMARK_GRAPHS
    if tiny is None:
        tiny = TINY_GRAPH_PARAMS
    findings: list[Finding] = []
    subjects = 0
    for name in sorted(registry):
        subject = f"generator:{name}"
        subjects += 1
        if name not in tiny:
            findings.append(Finding(
                "generator-unchecked", "error", subject,
                f"benchmark family {name!r} has no tiny parameterization "
                f"in analysis.retrace.TINY_GRAPH_PARAMS; add one so its "
                f"edge dtypes are linted"))
            continue
        factory, _ = registry[name]
        calls: list[tuple[int, str, str]] = []
        orig = CSRGraph.from_edges

        def recording(n, src, dst, device="cuda", _orig=orig, _calls=calls):
            _calls.append((n, str(np.asarray(src).dtype),
                           str(np.asarray(dst).dtype)))
            return _orig(n, src, dst, device=device)

        CSRGraph.from_edges = staticmethod(recording)
        try:
            factory(**tiny[name], device="cpu")
        except Exception as e:
            findings.append(Finding(
                "generator-failure", "error", subject,
                f"building the tiny graph raised {type(e).__name__}: {e}"))
            continue
        finally:
            CSRGraph.from_edges = staticmethod(orig)
        if not calls:
            findings.append(Finding(
                "generator-unchecked", "error", subject,
                "factory built no CSRGraph through from_edges"))
            continue
        for n, sdt, ddt in calls:
            fits = n <= np.iinfo(np.int32).max
            for which, dt in (("src", sdt), ("dst", ddt)):
                if fits and dt.endswith("64"):
                    findings.append(Finding(
                        "generator-int64", "error", subject,
                        f"{which} edge array is {dt} for n={n} (fits "
                        f"int32) — double the host-side edge memory on "
                        f"every build"))
    return findings, subjects
