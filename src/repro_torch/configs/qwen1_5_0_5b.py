"""Qwen1.5 0.5B — QKV bias [hf:Qwen/Qwen1.5-0.5B]."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen1.5-0.5b", family="dense",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=16, head_dim=64,
    d_ff=2816, vocab=151936, ffn_kind="swiglu", qkv_bias=True,
    source="hf:Qwen/Qwen1.5-0.5B",
))
