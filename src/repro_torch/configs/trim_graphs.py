"""The paper's OWN workload configs: graph families for trimming
benchmarks and the distributed-trim dry-run (not one of the 40 cells);
the port's copy of ``src/repro/configs/trim_graphs.py``."""
import dataclasses

from ..graphs.generators import BENCHMARK_GRAPHS


@dataclasses.dataclass(frozen=True)
class TrimWorkload:
    name: str
    graph: str                  # key into BENCHMARK_GRAPHS
    methods: tuple = ("ac3", "ac4", "ac4*", "ac6")
    workers: tuple = (1, 2, 4, 8, 16, 32)


WORKLOADS = {name: TrimWorkload(name=name, graph=name)
             for name in BENCHMARK_GRAPHS}

# production-scale distributed trim (dry-run only): synthetic 512M-edge
DISTRIBUTED_TRIM = dict(n=64_000_000, m=512_000_000, method="ac6")
