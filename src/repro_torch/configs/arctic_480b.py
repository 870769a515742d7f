"""arctic-480b [hf:Snowflake/snowflake-arctic-base; moe] — 35L d=7168 56H
(GQA kv=8) d_ff=4864 vocab=32000, MoE 128 experts top-2 + dense residual
(Arctic's dense-MoE hybrid)."""
from ..models.layers import LMConfig
from .base import ArchSpec, lm_shapes, register


def make_config() -> LMConfig:
    return LMConfig(name="arctic-480b", n_layers=35, d_model=7168,
                    n_heads=56, n_kv_heads=8, d_head=128, d_ff=4864,
                    vocab=32000, moe=True, n_experts=128, top_k=2,
                    moe_dense_residual=True, rope_theta=1e4)


def make_reduced() -> LMConfig:
    return LMConfig(name="arctic-480b-smoke", n_layers=2, d_model=64,
                    n_heads=4, n_kv_heads=2, d_head=16, d_ff=96,
                    vocab=512, moe=True, n_experts=8, top_k=2,
                    moe_dense_residual=True, remat=False)


SPEC = register(ArchSpec(
    id="arctic-480b", family="lm", make_config=make_config,
    make_reduced=make_reduced, shapes=lm_shapes(full_attention=True),
    source="hf:Snowflake/snowflake-arctic-base; hf"))
