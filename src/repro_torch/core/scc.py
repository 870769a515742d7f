"""SCC decomposition by Forward-Backward (FW-BW) search with graph
trimming — the paper's flagship application (§1.1) — as a batched
multi-pivot driver; PyTorch port of ``src/repro/core/scc.py``.

Trimming removes size-1 SCCs in bulk before any pivot search: a vertex
with no live successor (or no live predecessor) lies on no cycle.  FW-BW
then peels off one SCC per pivot, SCC(pivot) = FW(pivot) ∩ BW(pivot), and
recurses on the three remaining regions.

The driver advances the worklist in *generations*: all pending regions
(pairwise disjoint) are stacked into (B, n) masks and drained at once —

* one :meth:`TrimEngine.run_batch_stacked` for the trim phase (forward on
  odd generations, backward on even ones),
* one **trim-2** dispatch that labels size-1 and size-2 SCCs trimming
  cannot remove (self-loop singletons and mutually captive 2-cycles)
  before any pivot is spent on them,
* one :meth:`ReachEngine.run_batch` each for FW and BW.

Worklists wider than ``max_batch`` regions drain in equal pow2 chunks,
one dispatch per chunk.  Labels stay on the device until the one
materialization at the end; the host steers (region bookkeeping, pivot
picking).  The four engines (trim FW/BW, reach FW/BW) share one transpose
build: the backward engines sweep Gᵀ with their caches pre-seeded with G.

Each batched dispatch runs its rows one after another (see
``TrimEngine.run_batch_stacked``); the dispatch counts, labels and stats
equal the reference's.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import obs
from .engine import _to, plan
from .graph import CSRGraph, check_edge_ids, resolve_device
from .reach import plan_reach


def _pad_pow2(masks: np.ndarray) -> np.ndarray:
    """Pad a (B, n) mask stack with all-False rows up to the next power of
    two (the reference's bound on distinct batch widths, kept so the
    dispatch counts of ``max_batch`` chunking match); padded rows are
    empty regions and flow through trim and reach as no-ops."""
    b = masks.shape[0]
    bp = 1 << (b - 1).bit_length()
    if bp == b:
        return masks
    return np.concatenate(
        [masks, np.zeros((bp - b, masks.shape[1]), dtype=masks.dtype)])


def _chunks(masks, max_batch: int):
    """Split a pow2-padded (B, n) stack into ``max_batch``-row chunks
    (or the single whole stack when it fits)."""
    b = masks.shape[0]
    if b <= max_batch:
        return [masks]
    return [masks[i:i + max_batch] for i in range(0, b, max_batch)]


def _rowsum(indptr, per_edge):
    """Per-row sums of ``per_edge`` by an int64 prefix sum differenced at
    the row boundaries (the reference sums in int32 and may wrap on fat
    rows; only degree-1 rows are ever read, where both are exact)."""
    csum = torch.nn.functional.pad(
        torch.cumsum(per_edge, dim=0, dtype=torch.int64), (1, 0))
    return csum[indptr[1:]] - csum[indptr[:-1]]


def _trim2_detect(indptr, indices, t_indptr, t_indices, live):
    """Size-≤2 SCC detector over one (n,) live mask.

    A live pair {u, v} is a size-2 SCC detectable locally when the two are
    mutually captive (Wang et al.'s trim-2): every live out-edge of u goes
    to v and vice versa, or symmetrically every live in-edge.  With
    u == v the same predicate finds self-loop singletons.  The live
    out/in degree is a row count and the unique live successor/predecessor
    the row sum of live target ids — exact whenever the degree is 1, the
    only case that is read.  Returns ``(detected (n,) bool, partner (n,)
    int32)`` (partner == index for singletons and undetected rows)."""
    n = live.shape[0]
    idx = torch.arange(n, dtype=torch.int64, device=live.device)
    lt = live[indices]
    cnt_out = _rowsum(indptr, lt)
    succ = _rowsum(indptr, torch.where(lt, indices, 0))
    ts = live[t_indices]
    cnt_in = _rowsum(t_indptr, ts)
    pred = _rowsum(t_indptr, torch.where(ts, t_indices, 0))
    cap_out = live & (cnt_out == 1)
    s = succ.clamp(0, n - 1)
    pair_out = cap_out & cap_out[s] & (succ[s] == idx)
    cap_in = live & (cnt_in == 1)
    p = pred.clamp(0, n - 1)
    pair_in = cap_in & cap_in[p] & (pred[p] == idx)
    partner = torch.where(pair_out, succ, torch.where(pair_in, pred, idx))
    return pair_out | pair_in, partner.to(torch.int32)


def _trim2_batch(indptr, indices, t_indptr, t_indices, live):
    """The batched trim-2 detector (the reference's ``_trim2_runner``):
    ``live`` (B, n) -> ``(detected (B, n) bool, partner (B, n) int32)``,
    its rows one after another.  The driver counts each call as one
    trim-2 dispatch."""
    rows = [_trim2_detect(indptr, indices, t_indptr, t_indices, row)
            for row in live]
    return (torch.stack([r[0] for r in rows]),
            torch.stack([r[1] for r in rows]))


def scc_decompose(graph: CSRGraph, use_trim: bool = True,
                  trim_method: str = "ac6", trim_transpose: bool = True,
                  max_pivots: int = 1_000_000, trim_backend: str = "dense",
                  reach_backend: str = "windowed", window: int = 16,
                  counters: bool = False, max_batch: int = 1024,
                  active=None, trim2: bool = True, workers: int = 1,
                  chunk: int = 4096, frontier: str = "auto",
                  instrument: bool = False, max_rounds: int | None = None,
                  checkpoint_dir: str | None = None,
                  checkpoint_every: int = 0, checkpointer=None,
                  resume: bool = False, device="cuda"):
    """Return (labels, stats).  labels: (n,) int64 numpy component ids.

    ``active`` restricts decomposition to an induced subgraph: only
    vertices inside the (n,) bool mask are labeled (the rest get -1).
    ``trim_transpose=False`` trims forward on every generation.
    ``counters=True`` accumulates ``stats["trim_edges_traversed"]`` and the
    int64 ``(workers,)`` ``stats["per_worker_edges"]`` over every trim
    pass.  ``reach_backend`` defaults to "windowed" (the pull sweep
    through the ``frontier_expand`` kernel).  ``max_batch`` (a power of
    two) caps the regions of one dispatch.  ``trim2`` (default on) labels
    size-≤2 SCCs between the trim and pivot phases of every generation.
    ``frontier`` is threaded to all four engine plans.

    ``instrument=True`` plans all four engines with per-round stats
    (``max_rounds`` slots): ``stats["trim_rounds"]`` / ``["reach_rounds"]``
    sum the fixpoint rounds of every trim and reach pass.  Each generation
    is one ``obs`` span (cat ``"scc"``, with its region and pivot counts)
    when a recorder is active, so one ``obs.recording()`` around the call
    holds the generations and their engines' dispatch spans.

    ``checkpoint_dir`` + ``checkpoint_every=k`` (DESIGN.md §14) save the
    generation-level driver state (labels, the pending regions, the label
    counter and the stats) every k completed generations and once at the
    end, through ``fault.save_tree`` (``checkpointer``: an
    ``AsyncCheckpointer`` that takes the disk IO), in the reference's
    tree and metadata.  ``resume=True`` restores the latest checkpoint
    and continues: a generation is atomic and a function of (labels,
    regions, label counter, generation parity), so a resumed run's labels
    equal an uninterrupted run's.

    The graph moves to ``device`` (default the card; raises without one).
    """
    n = graph.n
    stats = {"generations": 0, "trim_passes": 0, "trimmed_total": 0,
             "pivots": 0, "trim_dispatches": 0, "reach_dispatches": 0,
             "trim2_removed": 0, "trim2_sccs": 0, "trim2_dispatches": 0,
             "trim_edges_traversed": 0 if counters else None,
             "per_worker_edges": (np.zeros(workers, np.int64)
                                  if counters else None),
             "trim_rounds": 0 if instrument else None,
             "reach_rounds": 0 if instrument else None,
             "engine_traces": 0, "transpose_builds": 1}
    if n == 0:
        return np.zeros(0, np.int64), stats
    if trim_backend == "sharded":
        raise ValueError(
            "the batched SCC driver needs a batchable trim backend "
            "('dense' or 'windowed'); shard at the region level instead")
    if max_batch < 1 or max_batch & (max_batch - 1):
        raise ValueError(f"max_batch must be a positive power of two, "
                         f"got {max_batch}")
    dev = resolve_device(device)
    graph = _to(graph, dev)

    def on_dev(x):
        return torch.as_tensor(x, device=dev)

    # four engines, one transpose build: the backward pair sweeps Gᵀ with
    # its transpose cache pre-seeded with G itself
    obs_kw = dict(instrument=instrument, max_rounds=max_rounds)
    if use_trim:
        fw_trim = plan(graph, method=trim_method, backend=trim_backend,
                       window=window, workers=workers, chunk=chunk,
                       frontier=frontier, device=dev, **obs_kw)
        gt = fw_trim.transpose           # the one and only build
        bw_trim = plan(gt, method=trim_method, backend=trim_backend,
                       window=window, transpose=graph, workers=workers,
                       chunk=chunk, frontier=frontier, device=dev, **obs_kw)
    else:
        fw_trim = bw_trim = None
        gt = graph.transpose()
    fw_reach = plan_reach(graph, backend=reach_backend, window=window,
                          transpose=gt, frontier=frontier, device=dev,
                          **obs_kw)
    bw_reach = plan_reach(gt, backend=reach_backend, window=window,
                          transpose=graph, frontier=frontier, device=dev,
                          **obs_kw)
    t2_arrs = (graph.indptr, graph.indices, gt.indptr, gt.indices)

    labels = torch.full((n,), -1, dtype=torch.int32, device=dev)
    next_label = 0
    if active is None:
        region0 = np.ones(n, dtype=bool)
    else:
        region0 = np.array(active.cpu() if isinstance(active, torch.Tensor)
                           else active, dtype=bool)
    if region0.shape != (n,):
        raise ValueError(f"active mask must have shape ({n},), got "
                         f"{region0.shape}")
    regions = [region0] if region0.any() else []
    idx = torch.arange(n, dtype=torch.int32, device=dev)

    # -- generation-level checkpoint/resume (DESIGN.md §14) ----------------
    ckpt_on = checkpoint_dir is not None and checkpoint_every > 0
    last_saved = -1

    def save_gen(gens):
        from ..fault.ckpt import save_tree
        tree = {"labels": labels,
                "regions": (np.stack(regions) if regions
                            else np.zeros((0, n), bool))}
        if counters:
            tree["per_worker_edges"] = stats["per_worker_edges"]
        drv_stats = {k: v for k, v in stats.items()
                     if k != "per_worker_edges"}
        save_tree(checkpoint_dir, gens, tree,
                  {"driver": {"kind": "scc", "next_label": next_label,
                              "stats": drv_stats}},
                  checkpointer=checkpointer)

    if resume and checkpoint_dir is not None:
        from ..train import checkpoint as _ckpt
        last = _ckpt.latest_step(checkpoint_dir)
        if last is not None:
            tree, _, meta = _ckpt.load_flat(checkpoint_dir, last)
            drv = meta["driver"]
            labels = on_dev(np.asarray(tree["labels"], np.int32))
            regions = [r.copy() for r in np.asarray(tree["regions"], bool)
                       if r.any()]
            next_label = int(drv["next_label"])
            stats.update(drv["stats"])
            if counters:
                stats["per_worker_edges"] = np.asarray(
                    tree["per_worker_edges"], np.int64).copy()
            last_saved = last

    while regions:
        if ckpt_on and stats["generations"] > max(last_saved, 0) \
                and stats["generations"] % checkpoint_every == 0:
            last_saved = stats["generations"]
            save_gen(last_saved)
        stats["generations"] += 1
        n_regions = len(regions)
        live_host = _pad_pow2(np.stack(regions))          # (B, n), disjoint
        regions = []
        with obs.span("generation", cat="scc", gen=stats["generations"],
                      regions=n_regions) as gen_sp:
            if use_trim:
                # one dispatch (per max_batch chunk) trims every pending
                # region; directions alternate by generation
                engine = (fw_trim if stats["generations"] % 2 == 1
                          or not trim_transpose else bw_trim)
                parts = [engine.run_batch_stacked(on_dev(c),
                                                  counters=counters)
                         for c in _chunks(live_host, max_batch)]
                stats["trim_passes"] += n_regions
                if counters:
                    # one (B, workers) int32 transfer; int64 sums on the
                    # host
                    pw = torch.cat([p[1] for p in parts])[:n_regions] \
                        .cpu().numpy().astype(np.int64)
                    stats["trim_edges_traversed"] += int(pw.sum())
                    stats["per_worker_edges"] += pw.sum(axis=0)
                if instrument:
                    stats["trim_rounds"] += int(torch.cat(
                        [p[2] for p in parts])[:n_regions].sum())
                status = torch.cat([p[0] for p in parts]) != 0
                live = on_dev(live_host)
                dead = live & ~status
                live = live & status
                # regions are disjoint: the union keeps one label a vertex
                dead_union = dead.any(dim=0)
                # one transfer serves the label counter and the worklist
                blob = torch.cat([dead_union[None], live]).cpu().numpy()
                dead_host, live_host = blob[0], blob[1:]
                k = int(dead_host.sum())
                if k:
                    rank = torch.cumsum(dead_union, dim=0,
                                        dtype=torch.int32) - 1
                    labels = torch.where(dead_union, next_label + rank, labels)
                    next_label += k
                    stats["trimmed_total"] += k

            if trim2 and live_host.any():
                # one dispatch (per max_batch chunk) detects size-≤2 SCCs in
                # every pending region; each pair/singleton gets one label
                # keyed by its representative (min endpoint)
                parts2 = [_trim2_batch(*t2_arrs, on_dev(c))
                          for c in _chunks(live_host, max_batch)]
                stats["trim2_dispatches"] += len(parts2)
                det = torch.cat([p[0] for p in parts2])
                partner = torch.cat([torch.where(p[0], p[1], -1)
                                     for p in parts2]).amax(dim=0)
                det_union = det.any(dim=0)
                is_rep = det_union & (idx <= partner)
                rep = torch.where(det_union, torch.minimum(idx, partner), idx)
                rank2 = torch.cumsum(is_rep, dim=0, dtype=torch.int32) - 1
                blob2 = torch.cat([is_rep[None], det_union[None],
                                   on_dev(live_host) & ~det]).cpu().numpy()
                n_sccs = int(blob2[0].sum())
                if n_sccs:
                    labels = torch.where(det_union, next_label + rank2[rep],
                                         labels)
                    next_label += n_sccs
                    stats["trim2_sccs"] += n_sccs
                    stats["trim2_removed"] += int(blob2[1].sum())
                    live_host = blob2[2:]

            keep = np.nonzero(live_host.any(axis=1))[0]
            if keep.size == 0:
                continue
            live_host = _pad_pow2(live_host[keep])
            B = keep.size                       # real regions; the rest is pad

            # one pivot per surviving region: its first live vertex
            pivots = live_host[:B].argmax(axis=1)
            stats["pivots"] += B
            if stats["pivots"] > max_pivots:
                raise RuntimeError("scc_decompose: pivot budget exceeded")
            seeds = np.zeros_like(live_host)
            seeds[np.arange(B), pivots] = True

            # all B pivots advance together: one dispatch per direction (per
            # max_batch chunk)
            def sweep(reach):
                outs = [reach.run_batch(on_dev(s), on_dev(a))
                        for s, a in zip(_chunks(seeds, max_batch),
                                        _chunks(live_host, max_batch))]
                if instrument:
                    stats["reach_rounds"] += int(sum(
                        np.asarray(o.rounds).sum() for o in outs))
                return torch.cat([o.mask for o in outs])[:B]
            fw = sweep(fw_reach)
            bw = sweep(bw_reach)
            live = on_dev(live_host[:B])
            scc = fw & bw
            scc_ids = next_label + torch.arange(B, dtype=torch.int32,
                                                device=dev)
            owner = torch.where(scc, scc_ids[:, None], -1).amax(dim=0)
            labels = torch.where(owner >= 0, owner, labels)
            next_label += B

            children = torch.cat([fw & ~scc, bw & ~scc,
                                  live & ~fw & ~bw]).cpu().numpy()
            regions = [r for r in children if r.any()]
            if gen_sp is not None:
                gen_sp.attrs["pivots"] = B

    if ckpt_on and stats["generations"] != last_saved:
        # the final state: an empty worklist, every label assigned; a
        # resumed run restores it and replays no generation
        save_gen(stats["generations"])

    labels = labels.cpu().numpy().astype(np.int64)  # the one materialization
    assert ((labels >= 0) | ~region0).all()
    engines = [e for e in (fw_trim, bw_trim, fw_reach, bw_reach)
               if e is not None]
    stats["engine_traces"] = sum(e.traces for e in engines)
    stats["transpose_builds"] = (sum(e.transpose_builds for e in engines)
                                 + (0 if use_trim else 1))
    if use_trim:
        stats["trim_dispatches"] = fw_trim.dispatches + bw_trim.dispatches
    stats["reach_dispatches"] = fw_reach.dispatches + bw_reach.dispatches
    return labels, stats


def scc_decompose_incremental(graph: CSRGraph, prev_labels,
                              deletions=None, insertions=None,
                              reach_backend: str = "windowed",
                              window: int = 16, device="cuda",
                              **scc_kwargs):
    """Re-decompose only the regions an edge-update batch dirtied.

    ``graph`` is the *updated* graph; ``prev_labels`` a valid SCC labeling
    of the graph before the batch; ``deletions`` / ``insertions`` the
    batch's ``(src, dst)`` pairs.  Returns ``(labels, stats)`` with labels
    valid for ``graph``: clean components keep their previous label,
    dirtied regions get fresh ids.

    * A deletion can only split the SCC that contained it, so only
      intra-component deletions dirty their component.
    * An insertion ``(u, v)`` merges exactly the vertices on new cycles
      through it, ``FW(v) ∩ BW(u)`` on the updated graph — two batched
      reach dispatches for the whole batch.  Every old component that
      meets a merge set is re-decomposed.

    The re-decomposition is one :func:`scc_decompose` call with
    ``active=dirty``.
    """
    n = graph.n
    prev = np.asarray(prev_labels, np.int64)
    if prev.shape != (n,):
        raise ValueError(f"prev_labels must have shape ({n},), got "
                         f"{prev.shape}")
    stats = {"dirty_vertices": 0, "dirty_components": 0,
             "reach_dispatches": 0, "recompute": None}

    def pairs(edges):
        if edges is None:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        return check_edge_ids(n, *edges)

    du, dv = pairs(deletions)
    iu, iv = pairs(insertions)
    dirty = np.zeros(n, bool)

    # deletions: only an intra-component deletion can split its SCC
    same = prev[du] == prev[dv]
    if same.any():
        dirty |= np.isin(prev, np.unique(prev[du[same]]))

    # insertions: merge set = FW(v) ∩ BW(u) on the updated graph, every
    # cross-component insertion in one dispatch per direction
    cross = prev[iu] != prev[iv]
    if cross.any():
        cu, cv = iu[cross], iv[cross]
        fw_engine = plan_reach(graph, backend=reach_backend, window=window,
                               device=device)
        bw_engine = plan_reach(fw_engine.transpose, backend=reach_backend,
                               window=window, transpose=fw_engine.graph,
                               device=device)
        b = cu.size
        fw_seeds = np.zeros((b, n), bool)
        bw_seeds = np.zeros((b, n), bool)
        fw_seeds[np.arange(b), cv] = True
        bw_seeds[np.arange(b), cu] = True
        fw = fw_engine.run_batch(_pad_pow2(fw_seeds)).mask
        bw = bw_engine.run_batch(_pad_pow2(bw_seeds)).mask
        merged = (fw[:b] & bw[:b]).any(dim=0).cpu().numpy()
        stats["reach_dispatches"] = (fw_engine.dispatches
                                     + bw_engine.dispatches)
        if merged.any():
            dirty |= np.isin(prev, np.unique(prev[merged]))

    stats["dirty_vertices"] = int(dirty.sum())
    stats["dirty_components"] = int(np.unique(prev[dirty]).size)
    if not dirty.any():
        return prev.copy(), stats

    sub_labels, sub_stats = scc_decompose(
        graph, reach_backend=reach_backend, window=window, active=dirty,
        device=device, **scc_kwargs)
    labels = prev.copy()
    labels[dirty] = (prev.max() + 1) + sub_labels[dirty]
    stats["recompute"] = sub_stats
    return labels, stats


def tarjan_oracle(indptr: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Iterative Tarjan SCC (numpy/python) — the test oracle (copy of the
    reference's)."""
    n = len(indptr) - 1
    index = np.full(n, -1, dtype=np.int64)
    low = np.zeros(n, dtype=np.int64)
    on_stack = np.zeros(n, dtype=bool)
    comp = np.full(n, -1, dtype=np.int64)
    stack: list[int] = []
    counter = 0
    n_comp = 0
    for root in range(n):
        if index[root] != -1:
            continue
        # iterative DFS: (vertex, next-edge-offset)
        work = [(root, indptr[root])]
        index[root] = low[root] = counter
        counter += 1
        stack.append(root)
        on_stack[root] = True
        while work:
            v, ei = work[-1]
            if ei < indptr[v + 1]:
                work[-1] = (v, ei + 1)
                w = int(indices[ei])
                if index[w] == -1:
                    index[w] = low[w] = counter
                    counter += 1
                    stack.append(w)
                    on_stack[w] = True
                    work.append((w, indptr[w]))
                elif on_stack[w]:
                    low[v] = min(low[v], index[w])
            else:
                work.pop()
                if work:
                    pv = work[-1][0]
                    low[pv] = min(low[pv], low[v])
                if low[v] == index[v]:
                    while True:
                        w = stack.pop()
                        on_stack[w] = False
                        comp[w] = n_comp
                        if w == v:
                            break
                    n_comp += 1
    return comp


def same_partition(a: np.ndarray, b: np.ndarray) -> bool:
    """Do two labelings induce the same partition of vertices?  (The
    reference's set-of-pairs test, computed with ``np.unique`` so it runs
    at millions of vertices.)"""
    a, b = np.asarray(a).reshape(-1), np.asarray(b).reshape(-1)
    if a.shape != b.shape:
        return False
    ua, ia = np.unique(a, return_inverse=True)
    ub, ib = np.unique(b, return_inverse=True)
    pairs = np.unique(ia.astype(np.int64) * max(len(ub), 1) + ib)
    return len(pairs) == len(ua) == len(ub)


__all__ = ["scc_decompose", "scc_decompose_incremental", "tarjan_oracle",
           "same_partition"]
