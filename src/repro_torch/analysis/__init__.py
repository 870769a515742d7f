"""Static-analysis plane of the port: race, sync and retrace checks over
the kernel and plan registries, without running anything on real data —
the counterpart of ``src/repro/analysis/``.

* **write-race freedom** (``analysis.races``): every Hopper kernel's
  launch, as its wrapper computes it (``analysis.capture`` records the
  ``kernels._build.launch`` funnel on meta tensors), writes each output
  block from one CUDA block unless the output is declared atomic or
  data-dependent, stays in bounds and covers the output;
* **host-sync discipline** (``analysis.syncs``): every fixpoint plan
  syncs with the host no more than its declared budget (rounds + probe
  micro-steps + a constant), copies nothing to the card inside its round
  loop, and takes no 64-bit arrays;
* **stable plans** (``analysis.retrace``): canonical, hashable plan
  kwargs and signatures, one library per kernel source, int32 generator
  edges.

``python -m repro_torch.analysis.check --strict`` gates the real
registry; ``--mutants`` proves every checker fires on the deliberately
broken twins in ``analysis.mutants`` (B10's copy kernel among them).
"""
from .capture import capture_kernel, captured_launches
from .catalog import (KERNEL_CATALOG, LAUNCH_DECLARATIONS, PLAN_CATALOG,
                      KernelEntry, LaunchDecl, OutputDecl, PlanEntry)
from .findings import Finding, Report
from .mutants import MUTANT_KERNELS, MUTANT_PLANS, MUTANTS_WAITING
from .races import check_races
from .retrace import (check_generator_dtypes, check_rebuilds,
                      check_retrace_risk)
from .syncs import check_host_dtypes, check_plan_syncs

__all__ = [
    "capture_kernel", "captured_launches",
    "KERNEL_CATALOG", "LAUNCH_DECLARATIONS", "PLAN_CATALOG",
    "KernelEntry", "LaunchDecl", "OutputDecl", "PlanEntry",
    "Finding", "Report",
    "MUTANT_KERNELS", "MUTANT_PLANS", "MUTANTS_WAITING",
    "check_races",
    "check_generator_dtypes", "check_rebuilds", "check_retrace_risk",
    "check_host_dtypes", "check_plan_syncs",
]
