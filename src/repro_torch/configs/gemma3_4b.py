"""Gemma-3 4B — 5:1 local:global attention, 128k context.
[hf:google/gemma-3-1b-pt; unverified] 34L d_model=2560 8H (GQA kv=4)
d_ff=10240 vocab=262144. Sliding window 1024 on local layers."""
from .registry import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-4b", family="dense",
    n_layers=34, d_model=2560, n_heads=8, n_kv_heads=4,
    d_ff=10240, vocab=262144, head_dim=256,
    sliding_window=1024, local_global_ratio=5,
    sub_quadratic=True,   # 5/6 layers are O(w); global layers keep full KV
)
