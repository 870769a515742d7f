"""Host syncs a trim call makes (engine: ``core/engine.py`` ``plan`` /
``TrimEngine.run``, ``core/enginebase.py`` ``_dispatch``, and the
fixpoint's loop tests), counted by torch's sync debug mode over the
traced calls."""

MOVES = "trim_throughput"


def read(r):
    return r.host_syncs_per_call
