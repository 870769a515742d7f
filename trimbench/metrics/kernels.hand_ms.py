"""Device ms a call spends in the port's own CUDA kernels
(``kernels/ops.py`` -> ``kernels/csrc/*.cu``, named by the port's launch
catalog), from the profiler over the traced calls."""

MOVES = "trim_throughput"


def read(r):
    if r.profile is None or not r.calls:
        return None
    seconds = r.profile.seconds_in(r.hand_kernels)
    return seconds / r.calls * 1e3 if seconds > 0 else None
