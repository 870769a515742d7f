"""PlanCheck CLI for the port — run the whole static-analysis plane.

    PYTHONPATH=src python -m repro_torch.analysis.check --strict --json findings.json
    PYTHONPATH=src python -m repro_torch.analysis.check --mutants

``--strict`` (the CI gate) fails on warnings as well as errors.
``--mutants`` runs the mutation corpus instead of the real registry and
exits nonzero unless every mutant that runs is caught by its expected
checker (and the well-formed copy kernel comes out clean).  ``--json``
writes the machine-readable findings.  Also reachable as
``python -m repro_torch.launch.trim --app check``.  The report and the
exit codes are the reference's (``src/repro/analysis/check.py``); the
port lowers nothing, so there is no lowering-cache line.  Everything runs
on the CPU: kernels are captured on meta tensors, plans run on tiny CPU
graphs.
"""
from __future__ import annotations

import argparse
import sys

from .findings import Finding, Report


def run_registry_checks(report: Report | None = None) -> Report:
    """All checkers against the real kernel/plan/generator registries."""
    from . import races, retrace, syncs
    from .catalog import KERNEL_CATALOG, LAUNCH_DECLARATIONS, PLAN_CATALOG
    report = report or Report()

    f, n = races.check_races(list(KERNEL_CATALOG), LAUNCH_DECLARATIONS)
    report.extend(f)
    report.note_subjects("races", n)

    f, n = syncs.check_plan_syncs(PLAN_CATALOG)
    report.extend(f)
    report.note_subjects("syncs", n)

    f, n = syncs.check_host_dtypes(PLAN_CATALOG)
    report.extend(f)
    report.note_subjects("host-dtypes", n)

    f, n = retrace.check_retrace_risk()
    report.extend(f)
    report.note_subjects("retrace", n)

    f, n = retrace.check_rebuilds()
    report.extend(f)
    report.note_subjects("rebuilds", n)

    f, n = retrace.check_generator_dtypes()
    report.extend(f)
    report.note_subjects("generator-dtypes", n)
    return report


def run_mutant_checks() -> tuple[Report, bool]:
    """The mutation corpus: every mutant that runs must be caught by its
    checker, and the well-formed copy kernel must come out clean."""
    from .mutants import MUTANTS_WAITING, verify_controls, verify_mutants
    report = Report()
    all_caught = True
    results = verify_mutants()
    for r in results:
        subject = f"mutant:{r['name']}"
        if r["caught"]:
            report.extend([Finding(
                "mutant-caught", "info", subject,
                f"expected checker {r['expect']!r} fired")])
        else:
            all_caught = False
            fired = sorted({f.checker for f in r["findings"]}) or ["none"]
            report.extend([Finding(
                "mutant-missed", "error", subject,
                f"expected checker {r['expect']!r} did not fire "
                f"(fired: {', '.join(fired)}) — the analysis plane has "
                f"a blind spot")])
    for name, item in MUTANTS_WAITING.items():
        report.extend([Finding(
            "mutant-waiting", "info", f"mutant:{name}",
            f"not run yet: waits for ROADMAP {item}")])
    controls = verify_controls()
    for name, findings in controls:
        if findings:
            all_caught = False
            report.extend([Finding(
                "control-flagged", "error", f"mutant-control:{name}",
                f"the well-formed geometry was flagged: "
                f"{'; '.join(f.checker for f in findings)}")])
    report.note_subjects("mutants", len(results))
    report.note_subjects("mutant-controls", len(controls))
    return report, all_caught


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.check",
        description="static race/sync/retrace checks over the port's "
                    "kernel and plan registries")
    parser.add_argument("--strict", action="store_true",
                        help="fail on warnings as well as errors (CI gate)")
    parser.add_argument("--mutants", action="store_true",
                        help="run the mutation corpus instead of the real "
                             "registry; exit nonzero unless every mutant "
                             "is caught")
    parser.add_argument("--json", metavar="PATH",
                        help="write machine-readable findings JSON")
    parser.add_argument("--verbose", action="store_true",
                        help="also print info-level findings")
    args = parser.parse_args(argv)

    if args.mutants:
        report, ok = run_mutant_checks()
    else:
        report = run_registry_checks()
        ok = report.ok(strict=args.strict)

    if args.json:
        report.dump_json(args.json)
    print(report.render(verbose=args.verbose))
    if not ok:
        print("FAILED", file=sys.stderr)
        return 1
    print("OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
