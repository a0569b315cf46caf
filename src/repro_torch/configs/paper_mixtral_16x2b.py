"""The paper's Mixtral 16x2B config (Table 2): 32L, hidden 2048, 32 heads,
ffn 8192, 16 experts top-2."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="paper-mixtral-16x2b", family="moe",
    num_layers=32, d_model=2048, num_heads=32, num_kv_heads=8, head_dim=64,
    d_ff=8192, vocab=32000, ffn_kind="swiglu",
    moe=True, num_experts=16, top_k=2, moe_d_ff=8192,
    ep_cols=8, etp=2,
    source="MicroMoE paper Table 2 (Mixtral 16x2B)",
))
