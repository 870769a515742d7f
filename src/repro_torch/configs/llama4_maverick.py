"""llama4-maverick-400b-a17b [hf:meta-llama/Llama-4; moe, unverified] — 48L
d=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 128e top-1 + shared
expert, iRoPE chunked-local attention (3 local : 1 global per group,
chunk 8192) => sub-quadratic long context: long_500k RUNS for this arch."""
from ..models.layers import LMConfig
from .base import ArchSpec, lm_shapes, register


def make_config() -> LMConfig:
    return LMConfig(name="llama4-maverick-400b-a17b", n_layers=48,
                    d_model=5120, n_heads=40, n_kv_heads=8, d_head=128,
                    d_ff=8192, vocab=202048, moe=True, n_experts=128,
                    top_k=1, moe_shared_expert=True, attention="chunked",
                    chunk_size=8192, layer_group=4, rope_theta=5e5)


def make_reduced() -> LMConfig:
    return LMConfig(name="llama4-maverick-smoke", n_layers=4, d_model=64,
                    n_heads=4, n_kv_heads=2, d_head=16, d_ff=96,
                    vocab=512, moe=True, n_experts=8, top_k=1,
                    moe_shared_expert=True, attention="chunked",
                    chunk_size=8, layer_group=4, remat=False)


SPEC = register(ArchSpec(
    id="llama4-maverick-400b-a17b", family="lm", make_config=make_config,
    make_reduced=make_reduced, shapes=lm_shapes(full_attention=False),
    source="hf:meta-llama/Llama-4-Scout-17B-16E; unverified"))
