"""minitron-4b [arXiv:2407.14679; dense] — pruned nemotron: 32L d=3072 24H
(GQA kv=8) d_ff=9216 vocab=256000."""
from ..models.layers import LMConfig
from .base import ArchSpec, lm_shapes, register


def make_config() -> LMConfig:
    return LMConfig(name="minitron-4b", n_layers=32, d_model=3072,
                    n_heads=24, n_kv_heads=8, d_head=128, d_ff=9216,
                    vocab=256000, rope_theta=1e4)


def make_reduced() -> LMConfig:
    return LMConfig(name="minitron-4b-smoke", n_layers=2, d_model=48,
                    n_heads=3, n_kv_heads=1, d_head=16, d_ff=144,
                    vocab=512, remat=False)


SPEC = register(ArchSpec(
    id="minitron-4b", family="lm", make_config=make_config,
    make_reduced=make_reduced, shapes=lm_shapes(full_attention=True),
    source="arXiv:2407.14679; hf"))
