"""wide-deep [arXiv:1606.07792] — 40 sparse fields, embed_dim 32,
MLP 1024-512-256, concat interaction."""
from ..models.recsys import WideDeepConfig, default_vocab_sizes
from .base import ArchSpec, recsys_shapes, register


def make_config() -> WideDeepConfig:
    return WideDeepConfig(name="wide-deep", n_sparse=40, embed_dim=32,
                          mlp=(1024, 512, 256), n_dense=13,
                          vocab_sizes=default_vocab_sizes(40))


def make_reduced() -> WideDeepConfig:
    return WideDeepConfig(name="wide-deep-smoke", n_sparse=6, embed_dim=8,
                          mlp=(32, 16), n_dense=4, vocab_sizes=(64,) * 6,
                          retrieval_dim=16)


SPEC = register(ArchSpec(
    id="wide-deep", family="recsys", make_config=make_config,
    make_reduced=make_reduced, shapes=recsys_shapes(),
    source="arXiv:1606.07792; paper"))
