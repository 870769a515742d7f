"""Entry points of the PyTorch port: ``python -m repro_torch.launch.trim``
(trimming, SCC, incremental trimming and k-core peeling on one named
graph)."""
