"""SeamlessM4T large v2 — encoder-decoder, multimodal (speech frontend
stubbed per brief). [arXiv:2308.11596; hf] 24L d_model=1024 16H (kv=16)
d_ff=8192 vocab=256206."""
from .registry import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2", family="audio",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=8192, vocab=256206,
    enc_layers=24, cross_attention=True,
    frontend_stub=True, frontend_len=4096,
)
