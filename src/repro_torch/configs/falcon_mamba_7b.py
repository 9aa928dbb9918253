"""Falcon-Mamba 7B — pure Mamba-1, attention-free.
[arXiv:2410.05355; unverified] 64L d_model=4096 vocab=65024 ssm_state=16."""
from .registry import ArchConfig

CONFIG = ArchConfig(
    name="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, n_heads=1, n_kv_heads=1,
    d_ff=0, vocab=65024,
    ssm_state=16, d_inner_mult=2,
    fsdp=True, sub_quadratic=True,
)
