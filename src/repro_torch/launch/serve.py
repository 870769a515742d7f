"""Serving launcher of the port: batched prefill + greedy KV-cache decode
for the dense LM architectures (PyTorch port of ``serve_lm`` and the
``--app model`` part of ``src/repro/launch/serve.py``)::

    python -m repro_torch.launch.serve --arch qwen3-1.7b --smoke --device cpu
    python -m repro_torch.launch.serve --arch qwen3-1.7b          # the card

``--smoke`` serves the reduced configuration; without it the published
one, on ``--device`` (default ``cuda``; a missing card raises).  Weights
are random, drawn from seed 0 by a ``torch.Generator`` on the device;
prompts (32 tokens) are ``numpy.random.default_rng(0)`` draws, as in the
reference.  The prefill's attention runs the flash kernel
(``kernels.ops.flash_attention``); decode attends over the preallocated
cache with plain einsums.

Not ported yet, and raising :class:`NotImplementedError` that names the
ROADMAP item: ``--app trim-stream`` (A10), the recsys and GNN
architectures and the MoE LMs (A11).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import configs
from ..models.transformer import LM


def _sync(device) -> None:
    """Wait for the card, so a host clock times the work and not its
    enqueueing."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def generate(lm: LM, prompts, gen_len: int):
    """Prefill ``prompts`` (B, P) into a cache preallocated to P + gen_len,
    then ``gen_len`` greedy decode steps.  Returns ``(tokens (B, gen_len +
    1) int64 on the device, stats)``: the prefill's argmax and one token a
    step; ``stats`` holds ``prefill_ms`` (the prefill and its argmax) and
    ``decode_ms`` (one entry a step), each a synchronised host clock."""
    dev = lm.device
    prompt_len = prompts.shape[1]
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = lm.prefill(prompts, cache_len=prompt_len + gen_len)
    tok = logits.argmax(-1, keepdim=True)
    _sync(dev)
    stats = {"prefill_ms": (time.perf_counter() - t0) * 1e3, "decode_ms": []}
    out = [tok]
    for i in range(gen_len):
        t0 = time.perf_counter()
        logits, cache = lm.decode_step(cache, tok, prompt_len + i)
        tok = logits.argmax(-1, keepdim=True)
        out.append(tok)
        _sync(dev)
        stats["decode_ms"].append((time.perf_counter() - t0) * 1e3)
    return torch.cat(out, dim=1), stats


def serve_lm(arch_id: str, batch: int = 4, prompt_len: int = 32,
             gen_len: int = 16, seed: int = 0, *, smoke: bool = True,
             device="cuda", lm: LM | None = None,
             return_stats: bool = False):
    """Serve ``batch`` random prompts of ``prompt_len`` tokens and print
    the reference's line (tokens generated, decode ms, tok/s).  ``lm``
    replaces the random model (e.g. weights carried from the reference by
    ``models.convert.lm_from_numpy``).  Returns the (B, gen_len + 1) int32
    tokens as numpy, and with ``return_stats`` also :func:`generate`'s
    stats."""
    spec = configs.get(arch_id)
    if lm is None:
        cfg = spec.make_reduced() if smoke else spec.make_config()
        gen = torch.Generator(device=device).manual_seed(seed)
        lm = LM(cfg, device=device, generator=gen)
    rng = np.random.default_rng(seed)
    prompts = torch.as_tensor(
        rng.integers(0, lm.cfg.vocab, (batch, prompt_len)), device=lm.device)
    toks, stats = generate(lm, prompts, gen_len)
    dt = sum(stats["decode_ms"]) / 1e3
    print(f"[serve] {arch_id}: generated {gen_len} tokens x{batch} "
          f"in {dt*1e3:.1f} ms ({batch*gen_len/dt:.0f} tok/s)")
    toks = toks.to(torch.int32).cpu().numpy()
    return (toks, stats) if return_stats else toks


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--app", default="model",
                    choices=("model", "trim-stream"))
    ap.add_argument("--arch")
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced configuration (default: published)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: the card)")
    args = ap.parse_args(argv)
    if args.app == "trim-stream":
        raise NotImplementedError(
            "--app trim-stream is not ported yet: ROADMAP A10")
    if args.arch is None:
        ap.error("--arch is required for --app model")
    return serve_lm(args.arch, batch=args.batch, gen_len=args.gen_len,
                    smoke=args.smoke, device=args.device)


if __name__ == "__main__":
    main()
