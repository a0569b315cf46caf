"""Architecture configuration (twin of ``repro.configs.base``).

The port keeps its own copy of ``ArchConfig``: the same fields, the same
``smoke()`` reduction and the same separator-insensitive registry lookup,
so a config here equals its reference twin field for field.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

__all__ = ["ArchConfig", "register", "get_config", "list_configs"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    ffn_kind: str                # geglu | swiglu | gelu_mlp
    norm: str = "rms"            # rms | ln
    qkv_bias: bool = False
    qk_norm: bool = False
    logit_softcap: float = 0.0
    rope_theta: float = 10000.0
    mrope_sections: Tuple[int, ...] = ()
    # layer pattern, cycled over depth: attn | attn_local | rwkv | rglru
    pattern: Tuple[str, ...] = ("attn",)
    window: int = 0              # sliding window for attn_local
    # MoE
    moe: bool = False
    num_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    ep_cols: int = 0             # expert-parallel columns on the model axis
    etp: int = 1                 # intra-expert tensor parallel
    # recurrent
    lru_width: int = 0
    conv_k: int = 4
    # misc
    tie_embeddings: bool = True
    sub_quadratic: bool = False  # eligible for long_500k decode
    frontend_stub: str = ""      # "vision" | "audio" -> embeddings input
    fsdp_params: bool = False    # ZeRO-3-style non-expert param sharding
    source: str = ""

    @property
    def has_attention(self) -> bool:
        return any(p.startswith("attn") for p in self.pattern)

    def smoke(self) -> "ArchConfig":
        """Reduced same-family variant for CPU smoke tests."""
        d_model = min(self.d_model, 256)
        heads = max(2, min(self.num_heads, 4))
        kv = 1 if self.num_kv_heads == 1 else min(self.num_kv_heads, heads)
        head_dim = max(32, d_model // heads)
        experts = min(self.num_experts, 4) if self.moe else 0
        mrope = self.mrope_sections
        if mrope:
            # rescale the (t, h, w) section split to the reduced head_dim
            half = head_dim // 2
            base = [s * half // sum(mrope) for s in mrope]
            base[0] += half - sum(base)
            mrope = tuple(base)
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            num_layers=2 if len(self.pattern) <= 2 else len(self.pattern),
            d_model=d_model,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=head_dim,
            mrope_sections=mrope,
            d_ff=min(self.d_ff, 512),
            vocab=min(self.vocab, 512),
            window=min(self.window, 64) if self.window else 0,
            num_experts=experts,
            top_k=min(self.top_k, 2) if self.moe else 0,
            moe_d_ff=min(self.moe_d_ff, 128) if self.moe else 0,
            ep_cols=1,
            etp=1,
            lru_width=min(self.lru_width, d_model) if self.lru_width else 0,
            fsdp_params=False,
        )


_REGISTRY: Dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def _canonical(name: str) -> str:
    """Separator-insensitive lookup key: 'paper_gpt-32x1.3b' == 'paper-gpt-32x1.3b'."""
    return "".join(ch for ch in name.lower() if ch.isalnum())


def get_config(name: str) -> ArchConfig:
    """Look up an architecture config by name ('.', '-', '_' interchangeable)."""
    if name in _REGISTRY:
        return _REGISTRY[name]
    by_canon = {_canonical(k): v for k, v in _REGISTRY.items()}
    key = _canonical(name)
    if key in by_canon:
        return by_canon[key]
    raise KeyError(
        f"unknown architecture {name!r}; registered: "
        f"{', '.join(sorted(_REGISTRY))}")


def list_configs() -> Dict[str, ArchConfig]:
    return dict(_REGISTRY)
