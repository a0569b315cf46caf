"""Gemma 2B — GeGLU, head_dim 256, MQA [arXiv:2403.08295]."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="gemma-2b", family="dense",
    num_layers=18, d_model=2048, num_heads=8, num_kv_heads=1, head_dim=256,
    d_ff=16384, vocab=256000, ffn_kind="geglu",
    source="arXiv:2403.08295 (Gemma)",
))
