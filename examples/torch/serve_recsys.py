"""Serve a wide-deep model on the PyTorch port: batched CTR scoring and
1-vs-100k retrieval (the twin of ``examples/serve_recsys.py``).

    python examples/torch/serve_recsys.py                 # on the card
    python examples/torch/serve_recsys.py --device cpu

The reduced configuration, with weights drawn from seed 0 on the device
(:func:`build_model`); the batches come from numpy seed 0, as the
reference's.
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

import numpy as np
import torch

from repro_torch.configs import get
from repro_torch.models.recsys import WideDeep

#: the serve_p99 and retrieval_cand cells, scaled down as the reference's
BATCH, CANDIDATES, REPS = 256, 100_000, 20


def build_model(cfg, device):
    """The served model: the reduced config's weights from seed 0."""
    return WideDeep(cfg, device=device,
                    generator=torch.Generator(device=device).manual_seed(0))


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


@torch.no_grad()
def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: the card)")
    device = ap.parse_args(argv).device

    cfg = get("wide-deep").make_reduced()
    model = build_model(cfg, device)
    rng = np.random.default_rng(0)

    # batched online scoring (serve_p99 shape, scaled down)
    batch = {
        "dense": torch.as_tensor(rng.normal(size=(BATCH, cfg.n_dense)),
                                 dtype=torch.float32, device=device),
        "sparse_ids": torch.as_tensor(
            rng.integers(0, min(cfg.vocab_sizes),
                         (BATCH, cfg.n_sparse, cfg.ids_per_field)),
            dtype=torch.int32, device=device),
    }
    scores = model(batch)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(REPS):
        scores = model(batch)
    _sync(device)
    dt = (time.perf_counter() - t0) / REPS
    print(f"CTR scoring: batch {BATCH} in {dt*1e6:.0f} us "
          f"({BATCH/dt/1e3:.0f}k req/s single-core)")

    # retrieval: one query against the candidates (retrieval_cand, scaled)
    cand = torch.as_tensor(rng.normal(size=(CANDIDATES, cfg.retrieval_dim)),
                           dtype=torch.float32, device=device)
    rb = {"dense": batch["dense"][:1], "sparse_ids": batch["sparse_ids"][:1],
          "candidates": cand}
    vals, idx = model.retrieval_scores(rb)
    _sync(device)
    t0 = time.perf_counter()
    vals, idx = model.retrieval_scores(rb)
    _sync(device)
    print(f"retrieval: top-100 of {cand.shape[0]:,} candidates in "
          f"{(time.perf_counter()-t0)*1e3:.1f} ms; best={float(vals[0]):.3f}")
    return scores, vals, idx


if __name__ == "__main__":
    main()
