"""Architecture registry: the ten architectures as data.

Ports ``src/repro/configs/registry.py`` (``ArchConfig``, ``smoke()``,
``hd``, ``get_arch``).  The arch files beside this one are copies of the
reference's, so both packages read the same numbers.  The dry-run shape
table is not ported: it belongs to ``launch/dryrun.py``, which the port
does not have yet.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass, replace


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str              # dense | moe | hybrid | ssm | encdec | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0        # 0 → d_model // n_heads
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_every: int = 1       # MoE on layers where (layer % moe_every == moe_offset)
    moe_offset: int = 1
    shared_expert: bool = False
    # SSM / hybrid
    ssm_state: int = 0
    attn_every: int = 0      # hybrid: attention on every k-th layer (jamba: 8)
    d_inner_mult: int = 2
    dt_rank: int = 0         # 0 → d_model // 16
    conv_width: int = 4
    # attention flavour
    qk_norm: bool = False
    sliding_window: int = 0
    local_global_ratio: int = 0   # gemma3: 5 local : 1 global
    mrope: bool = False
    # encoder-decoder
    enc_layers: int = 0
    cross_attention: bool = False
    frontend_stub: bool = False   # audio/vlm: frontend supplies embeddings
    frontend_len: int = 0         # stub sequence length (frames / patches)
    # numerics & distribution policy
    dtype: str = "bfloat16"
    norm_eps: float = 1e-6
    fsdp: bool = False            # shard params over the data axis too
    sub_quadratic: bool = False   # eligible for long_500k
    tie_embeddings: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def d_inner(self) -> int:
        return self.d_inner_mult * self.d_model

    @property
    def dt_rank_(self) -> int:
        return self.dt_rank or max(self.d_model // 16, 8)

    def is_moe_layer(self, layer: int) -> bool:
        return self.n_experts > 0 and (layer % self.moe_every == self.moe_offset % self.moe_every)

    def is_attn_layer(self, layer: int) -> bool:
        if self.family == "ssm":
            return False
        if self.attn_every:
            return layer % self.attn_every == self.attn_every - 1
        return True

    def is_global_attn_layer(self, layer: int) -> bool:
        if not self.local_global_ratio:
            return True
        return layer % (self.local_global_ratio + 1) == self.local_global_ratio

    def scaled(self, **kw) -> "ArchConfig":
        return replace(self, **kw)

    def smoke(self) -> "ArchConfig":
        """Reduced config of the same family for CPU smoke tests."""
        return replace(
            self,
            n_layers=max(2, (self.attn_every or 2)),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2),
            d_ff=128,
            vocab=512,
            head_dim=16,
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2),
            enc_layers=2 if self.enc_layers else 0,
            sliding_window=min(self.sliding_window, 16) if self.sliding_window else 0,
            frontend_len=8 if self.frontend_stub else 0,
            dt_rank=8,
            fsdp=False,
        )


def get_arch(arch_id: str) -> ArchConfig:
    arch_id = arch_id.replace("-", "_").replace(".", "_")
    mod = importlib.import_module(f"repro_torch.configs.{arch_id}")
    return mod.CONFIG
