"""Graph500 Kronecker generator, a frozen copy of the specification's
reference (``kronecker_generator.m``, graph500.org), on the device.

For each of ``scale`` bits every arc draws two uniforms: the source bit
is set when the first exceeds A + B, the target bit when the second
exceeds C / (1 - (A + B)) after a set source bit, A / (A + B) otherwise.
The arcs are then put in a random order.  Self-loops and duplicates are
kept as generated.

The structure (the bits and the arc order) comes from the
configuration's ``structure_seed``; the run's ``--seed`` draws the
vertex permutation that the specification applies to the labels.  So
every seed gives the same graph under other labels: the same rounds and
the same arcs examined, laid out and split over the workers differently.
"""
from __future__ import annotations

import torch

from trimbench import csr


def make(cfg: dict, seed: int, device):
    """``(indptr, indices)`` int32 of the configuration on ``device``."""
    scale = int(cfg["scale"])
    n = 1 << scale
    m = int(cfg["edgefactor"]) * n
    a, b, c = float(cfg["A"]), float(cfg["B"]), float(cfg["C"])
    ab = a + b
    c_norm = c / (1.0 - ab)
    a_norm = a / ab
    gen = csr.generator(cfg["structure_seed"], device)
    src = torch.zeros(m, dtype=torch.int32, device=device)
    dst = torch.zeros(m, dtype=torch.int32, device=device)
    for bit in range(scale):
        ii = torch.rand(m, generator=gen, device=device) > ab
        jj = torch.rand(m, generator=gen, device=device) > torch.where(
            ii, c_norm, a_norm)
        src |= ii.to(torch.int32) << bit
        dst |= jj.to(torch.int32) << bit
        del ii, jj
    order = torch.randperm(m, generator=gen, device=device)
    src, dst = src[order], dst[order]
    del order
    src, dst = csr.relabel(src, dst, n, seed)
    return csr.from_edges(n, src, dst)
