"""RWKV-6 (Finch) 7B — attention-free SSM with data-dependent decay
[arXiv:2404.05892]."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="rwkv6-7b", family="ssm",
    num_layers=32, d_model=4096, num_heads=64, num_kv_heads=64, head_dim=64,
    d_ff=14336, vocab=65536, ffn_kind="gelu_mlp",  # channel-mix uses its own kind
    pattern=("rwkv",), sub_quadratic=True,
    source="arXiv:2404.05892 (Finch)",
))
