"""Qwen3-MoE 30B-A3B — 128 experts top-8, qk_norm.
[hf:Qwen/Qwen3-30B-A3B; hf] 48L d_model=2048 32H (GQA kv=4)
expert d_ff=768 vocab=151936."""
from .registry import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4,
    d_ff=768, vocab=151936, head_dim=128,
    n_experts=128, top_k=8, moe_every=1, moe_offset=0,
    qk_norm=True, fsdp=True,
)
