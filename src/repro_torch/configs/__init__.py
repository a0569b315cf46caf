"""Config registry of the port: the architectures its serving path runs."""
from . import olmoe_1b_7b, paper_gpt_32x1_3b  # noqa: F401  (registers)
from .base import ArchConfig, get_config, list_configs, register

__all__ = ["ArchConfig", "get_config", "list_configs", "register"]
