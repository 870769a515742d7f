"""Entry points of the PyTorch port: ``python -m repro_torch.launch.trim``
(trimming, SCC, incremental trimming and k-core peeling on one named
graph) and ``python -m repro_torch.launch.serve`` (LM prefill + greedy
decode)."""
