"""Write-race and coverage detector over the port's launch records —
the counterpart of ``src/repro/analysis/races.py``.

For each captured :class:`~repro_torch.kernels._build.Launch` the grid is
enumerated concretely (the lattice in ``analysis.catalog`` keeps grids
small) and the declared map from a block index to the output block it
writes is evaluated at every block, for every output.  CUDA blocks run in
no order, so no grid axis is sequential: a block revisited by several
blocks is sound only when the output is declared ``atomic`` or
``data-dependent``.  Per output:

* **bounds** — every block index lies inside the output's block grid
  (``oob-write``; a block whose slice starts past the end is one too);
* **revisit axes** — grid axes along which the map is constant; an axis
  of extent > 1 on an ``owned`` output is ``undeclared-sequential``;
* **injectivity** — on the other axes the map of an ``owned`` output
  must be injective: two blocks writing one slice is a ``write-race``,
  reported with both witnesses;
* **coverage** — every output block is written by some block
  (``uncovered-block``);
* a ``data-dependent`` output without a declared guard is an
  ``oob-write``: nothing states why its slots stay in bounds.

Per launch: scratch across blocks needs an ordered protocol
(``carry-without-sequential``); a kernel or output without a declaration
is ``unregistered-kernel``; a grid beyond the card's limits (or too large
to sweep) is ``grid-too-large``.  Per lattice point: a wrapper that raises
is ``capture-failure``, one that launches nothing ``no-kernel-launch``.
"""
from __future__ import annotations

import itertools
import math

from .catalog import LaunchDecl
from .findings import Finding

# Hard guard against combinatorial blowup: the pinned lattice keeps every
# grid tiny; anything bigger is a catalog bug, not a kernel bug.
MAX_GRID_POINTS = 1_000_000
# the card's launch limits: grid x < 2^31, grid y and z <= 65,535, at most
# 1,024 threads a block
MAX_GRID = (2**31 - 1, 65_535, 65_535)
MAX_THREADS = 1024


def _revisit_axes(points, mapped, ndim: int) -> set[int]:
    """Axes along which the map is constant (same block revisited)."""
    revisit: set[int] = set()
    for axis in range(ndim):
        groups: dict = {}
        constant = True
        for p in points:
            key = p[:axis] + p[axis + 1:]
            if groups.setdefault(key, mapped[p]) != mapped[p]:
                constant = False
                break
        if constant:
            revisit.add(axis)
    return revisit


def _check_output(subject: str, name: str, launch, out, decl) -> list:
    findings: list[Finding] = []
    grid = tuple(launch.grid)
    shape = tuple(out.shape)
    if decl.mode == "data-dependent" and not decl.guard:
        findings.append(Finding(
            "oob-write", "error", subject,
            f"output {name}: data-dependent slots with no declared "
            f"capacity guard"))
    extent = tuple(decl.extent(launch, shape))
    nblocks = tuple(max(1, math.ceil(d / e))
                    for d, e in zip(shape or (1,), extent))

    points = list(itertools.product(*[range(g) for g in grid]))
    mapped = {}
    for p in points:
        try:
            mapped[p] = tuple(int(i) for i in decl.index(launch, shape, p))
        except Exception as e:  # a map that cannot be evaluated
            return findings + [Finding(
                "capture-failure", "error", subject,
                f"output {name}: index({p}) raised "
                f"{type(e).__name__}: {e}")]

    # Bounds: every block index inside the output block grid.
    for p, idx in mapped.items():
        for d, (i, nb) in enumerate(zip(idx, nblocks)):
            if not 0 <= i < nb:
                return findings + [Finding(
                    "oob-write", "error", subject,
                    f"output {name}: block {p} writes block {idx}, dim "
                    f"{d} outside [0, {nb})")]

    revisit = _revisit_axes(points, mapped, len(grid))
    if decl.mode == "owned":
        for axis in sorted(revisit):
            if grid[axis] > 1:
                findings.append(Finding(
                    "undeclared-sequential", "error", subject,
                    f"output {name}: grid axis {axis} (extent "
                    f"{grid[axis]}) revisits the same block, but the "
                    f"output is owned, not atomic (CUDA blocks run in no "
                    f"order)"))
        # Injectivity on the axes the map varies along: each block owns
        # one slice; two blocks claiming the same slice is a race.
        parallel = [a for a in range(len(grid)) if a not in revisit]
        owner: dict = {}
        for p in points:
            proj = tuple(p[a] for a in parallel)
            first = owner.setdefault(mapped[p], proj)
            if first != proj:
                findings.append(Finding(
                    "write-race", "error", subject,
                    f"output {name}: blocks {first} and {proj} "
                    f"(projection onto axes {parallel}) both write block "
                    f"{mapped[p]}"))
                return findings

    # Coverage: every block of the output is written by some block.
    expected = set(itertools.product(*[range(nb) for nb in nblocks]))
    missing = expected - set(mapped.values())
    if missing:
        findings.append(Finding(
            "uncovered-block", "error", subject,
            f"output {name}: {len(missing)} of {len(expected)} blocks "
            f"never written (e.g. {sorted(missing)[:4]})"))
    return findings


def check_capture(subject: str, launch, declarations: dict) -> list:
    """Run every race rule against one captured launch."""
    key = (launch.library, launch.kernel)
    decl: LaunchDecl | None = declarations.get(key)
    if decl is None:
        return [Finding(
            "unregistered-kernel", "error", subject,
            f"kernel {launch.library}/{launch.kernel} has no launch "
            f"declaration; register it in analysis.catalog "
            f"(LAUNCH_DECLARATIONS)")]
    grid, block = tuple(launch.grid), tuple(launch.block)
    total = math.prod(grid)
    if (len(grid) != 3 or len(block) != 3 or total > MAX_GRID_POINTS
            or any(g > lim for g, lim in zip(grid, MAX_GRID))
            or math.prod(block) > MAX_THREADS or min(grid + block) < 1):
        return [Finding(
            "grid-too-large", "error", subject,
            f"grid {grid} x block {block}: outside the card's limits "
            f"(grid {MAX_GRID}, {MAX_THREADS} threads a block, none 0) or "
            f"over {MAX_GRID_POINTS} blocks to sweep")]

    findings: list[Finding] = []
    if (launch.scratch or decl.scratch) and not decl.ordered:
        findings.append(Finding(
            "carry-without-sequential", "error", subject,
            f"kernel {launch.kernel} uses scratch across blocks but "
            f"declares no ordered protocol (CUDA blocks run in no order)"))
    for name in sorted(set(decl.outputs) - set(launch.outputs)):
        findings.append(Finding(
            "unregistered-kernel", "error", subject,
            f"declared output {name} of {launch.kernel} is not written"))
    for name, out in launch.outputs.items():
        out_decl = decl.outputs.get(name)
        if out_decl is None:
            findings.append(Finding(
                "unregistered-kernel", "error", subject,
                f"output {name} of {launch.kernel} has no declaration"))
            continue
        findings.extend(_check_output(subject, name, launch, out, out_decl))
    return findings


def check_races(entries, declarations: dict) -> tuple[list, int]:
    """Sweep the kernel catalog over its shape lattice.

    Returns the findings plus the number of (entry x lattice point x
    launch) subjects examined, so the report can prove the sweep was not
    silently empty.
    """
    findings: list[Finding] = []
    subjects = 0
    for entry in entries:
        for point in entry.points:
            label = ",".join(f"{k}={v}" for k, v in sorted(point.items()))
            subject = f"kernel:{entry.name}[{label}]"
            try:
                launches = entry.build(point)
            except Exception as e:
                findings.append(Finding(
                    "capture-failure", "error", subject,
                    f"running the wrapper on meta tensors failed: "
                    f"{type(e).__name__}: {e}"))
                continue
            if not launches:
                findings.append(Finding(
                    "no-kernel-launch", "error", subject,
                    "wrapper made no kernel launch under capture"))
                continue
            for k, launch in enumerate(launches):
                subjects += 1
                sub = subject if len(launches) == 1 else f"{subject}#call{k}"
                findings.extend(check_capture(sub, launch, declarations))
    return findings, subjects
