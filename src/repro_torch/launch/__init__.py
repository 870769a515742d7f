"""Entry points of the PyTorch port: ``python -m repro_torch.launch.trim``
(trimming, SCC, incremental trimming and k-core peeling on one named
graph, and ``--dryrun``), ``python -m repro_torch.launch.serve`` (LM,
recsys and trim-stream serving), ``python -m repro_torch.launch.train``
(LM, GNN and recsys training) and ``python -m repro_torch.launch.dryrun``
(every architecture x shape cell on the meta device for one H100, through
``cells`` and ``lowering``); ``perf_flags`` holds the performance toggles
and ``mesh`` the card's rates."""
