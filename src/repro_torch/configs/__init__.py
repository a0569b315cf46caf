"""Config registry of the port: the architectures its paths run (serving:
olmoe-1b-7b, paper-gpt-32x1.3b; the full-sequence forward: rwkv6-7b)."""
from . import olmoe_1b_7b, paper_gpt_32x1_3b, rwkv6_7b  # noqa: F401  (registers)
from .base import ArchConfig, get_config, list_configs, register

__all__ = ["ArchConfig", "get_config", "list_configs", "register"]
