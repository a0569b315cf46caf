"""Config registry of the port: the architectures its paths run (serving,
the full-sequence forward and training: olmoe-1b-7b, paper-gpt-32x1.3b,
paper-mixtral-16x2b, dbrx-132b, qwen1.5-0.5b, gemma-2b; serving and the
forward: rwkv6-7b; registered but refused by every path, for its
sliding-window attention: dbrx-132b-swa)."""
from . import (dbrx_132b, gemma_2b, olmoe_1b_7b,  # noqa: F401  (registers)
               paper_gpt_32x1_3b, paper_mixtral_16x2b, qwen1_5_0_5b,
               rwkv6_7b)
from .base import ArchConfig, get_config, list_configs, register

__all__ = ["ArchConfig", "get_config", "list_configs", "register"]
