"""deepseek-7b [arXiv:2401.02954; dense] — 30L d=4096 32H (GQA kv=32 = MHA)
d_ff=11008 vocab=102400, llama architecture."""
from ..models.layers import LMConfig
from .base import ArchSpec, lm_shapes, register


def make_config() -> LMConfig:
    return LMConfig(name="deepseek-7b", n_layers=30, d_model=4096,
                    n_heads=32, n_kv_heads=32, d_head=128, d_ff=11008,
                    vocab=102400, rope_theta=1e4)


def make_reduced() -> LMConfig:
    return LMConfig(name="deepseek-7b-smoke", n_layers=2, d_model=64,
                    n_heads=4, n_kv_heads=4, d_head=16, d_ff=160,
                    vocab=512, remat=False)


SPEC = register(ArchSpec(
    id="deepseek-7b", family="lm", make_config=make_config,
    make_reduced=make_reduced, shapes=lm_shapes(full_attention=True),
    source="arXiv:2401.02954; hf"))
