"""DBRX base 132B — fine-grained MoE, 16 experts top-4, GQA kv=8
[hf:databricks/dbrx-base].  EP 8 x expert-TP 2 on the 16-wide model axis
(k=2 replica slots per device — MicroEP's prerequisite, DESIGN.md §5);
non-expert params FSDP-sharded over the data axis (132B doesn't fit
replicated)."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="dbrx-132b", family="moe",
    num_layers=40, d_model=6144, num_heads=48, num_kv_heads=8, head_dim=128,
    d_ff=10752, vocab=100352, ffn_kind="swiglu",
    moe=True, num_experts=16, top_k=4, moe_d_ff=10752,
    ep_cols=8, etp=2, fsdp_params=True,
    source="hf:databricks/dbrx-base",
))

# Beyond-paper variant: sliding-window attention (window 4096) makes the MoE
# arch eligible for long_500k decode — demonstrates MicroEP under long
# context, where per-step MoE dispatch runs against a bounded ring cache.
import dataclasses as _dc

CONFIG_SWA = register(_dc.replace(
    CONFIG, name="dbrx-132b-swa",
    pattern=("attn_local",), window=4096, sub_quadratic=True,
    source=CONFIG.source + " (+SWA long-context variant, this repo)",
))
