from .generators import (BENCHMARK_GRAPHS, barabasi_albert, chain, cycle,
                         edge_dtype, erdos_renyi, layered_dag, make, rmat,
                         sink_heavy, with_tiny_scc_fringe)
from .sampler import NeighborSampler, SampledBlock

__all__ = [
    "BENCHMARK_GRAPHS", "make", "edge_dtype", "erdos_renyi",
    "barabasi_albert", "rmat", "chain", "cycle", "layered_dag", "sink_heavy",
    "with_tiny_scc_fringe", "NeighborSampler", "SampledBlock",
]
