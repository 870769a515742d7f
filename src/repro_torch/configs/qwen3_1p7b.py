"""qwen3-1.7b [hf:Qwen/Qwen3-8B family; dense] — 28L d=2048 16H (GQA kv=8)
d_ff=6144 vocab=151936, qk_norm, GQA, head_dim 128."""
from ..models.layers import LMConfig
from .base import ArchSpec, lm_shapes, register


def make_config() -> LMConfig:
    return LMConfig(name="qwen3-1.7b", n_layers=28, d_model=2048,
                    n_heads=16, n_kv_heads=8, d_head=128, d_ff=6144,
                    vocab=151936, qk_norm=True, rope_theta=1e6)


def make_reduced() -> LMConfig:
    return LMConfig(name="qwen3-1.7b-smoke", n_layers=2, d_model=64,
                    n_heads=4, n_kv_heads=2, d_head=16, d_ff=128,
                    vocab=512, qk_norm=True, remat=False)


SPEC = register(ArchSpec(
    id="qwen3-1.7b", family="lm", make_config=make_config,
    make_reduced=make_reduced, shapes=lm_shapes(full_attention=True),
    source="hf:Qwen/Qwen3-8B; hf"))
