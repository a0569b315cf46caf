"""Engine facade and typed configuration."""
from .config import ConfigError, ServeConfig
from .engine import MicroEPEngine

__all__ = ["ConfigError", "MicroEPEngine", "ServeConfig"]
