"""The paper's own GPT 32x1.3B MoE config (Table 2): 24L, hidden 2048,
16 heads, ffn 8192, 32 experts top-2."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="paper-gpt-32x1.3b", family="moe",
    num_layers=24, d_model=2048, num_heads=16, num_kv_heads=16, head_dim=128,
    d_ff=8192, vocab=50304, ffn_kind="gelu_mlp", norm="ln",
    moe=True, num_experts=32, top_k=2, moe_d_ff=8192,
    ep_cols=16, etp=1,
    source="MicroMoE paper Table 2 (GPT 32x1.3B)",
))
