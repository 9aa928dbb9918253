"""Jamba v0.1 52B — hybrid Mamba+Attention 1:7 interleave, MoE 16e top-2.
[arXiv:2403.19887; hf] 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536. Attention every 8th layer; MoE every other layer."""
from .registry import ArchConfig

CONFIG = ArchConfig(
    name="jamba-v0.1-52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=65536,
    n_experts=16, top_k=2, moe_every=2, moe_offset=1,
    ssm_state=16, attn_every=8, d_inner_mult=2,
    fsdp=True, sub_quadratic=True,
)
