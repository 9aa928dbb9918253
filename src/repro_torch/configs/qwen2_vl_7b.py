"""Qwen2-VL 7B — M-RoPE, dynamic resolution (patch frontend stubbed per
brief). [arXiv:2409.12191; hf] 28L d_model=3584 28H (GQA kv=4)
d_ff=18944 vocab=152064."""
from .registry import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-7b", family="vlm",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4,
    d_ff=18944, vocab=152064, head_dim=128,
    mrope=True, frontend_stub=True, frontend_len=256,
    fsdp=True,
)
