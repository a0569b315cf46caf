"""OLMoE 1B-7B — 64 experts top-8 [arXiv:2409.02060].  EP 16 (k=4 slots)."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="olmoe-1b-7b", family="moe",
    num_layers=16, d_model=2048, num_heads=16, num_kv_heads=16, head_dim=128,
    d_ff=1024, vocab=50304, ffn_kind="swiglu",
    moe=True, num_experts=64, top_k=8, moe_d_ff=1024,
    ep_cols=16, etp=1,
    source="arXiv:2409.02060 (OLMoE)",
))
