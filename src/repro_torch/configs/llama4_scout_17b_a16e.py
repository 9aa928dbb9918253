"""Llama-4 Scout 17B-A16E — MoE 16 experts top-1 + shared expert,
early fusion noted (text backbone per brief).
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified] 48L d_model=5120
40H (GQA kv=8) d_ff=8192 vocab=202048."""
from .registry import ArchConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=8192, vocab=202048, head_dim=128,
    n_experts=16, top_k=1, moe_every=2, moe_offset=1, shared_expert=True,
    fsdp=True,
)
