"""The smoke configs the port's dense and expert-tensor-parallel paths are
held to the reference on, shared by the ``test_torch_*`` parity tests.

``ArchConfig.smoke()`` sets ``etp`` to 1, so an expert-tensor-parallel case
sets it back with ``dataclasses.replace``; each case is built the same way
for the reference and (through :func:`port_config`) for the port."""
import dataclasses

from repro.configs import get_config
from repro_torch.configs.base import ArchConfig as TorchArchConfig


def _smoke(name: str, **change):
    return dataclasses.replace(get_config(name).smoke(), **change)


# id -> a function that makes the reference's config
DENSE_ETP_CASES = {
    "qwen1.5-0.5b": lambda: _smoke("qwen1.5-0.5b"),            # QKV bias, SwiGLU
    "gemma-2b": lambda: _smoke("gemma-2b"),                    # MQA, GeGLU
    "gemma-2b-hd256": lambda: _smoke("gemma-2b", num_heads=2,  # its head shape
                                     head_dim=256),
    "paper-gpt-dense": lambda: _smoke("paper-gpt-32x1.3b",     # ln, gelu_mlp
                                      moe=False),
    "paper-mixtral-etp2": lambda: _smoke("paper-mixtral-16x2b", etp=2),
}


def port_config(ref_cfg) -> TorchArchConfig:
    """The port's twin of a reference config, field for field."""
    return TorchArchConfig(**dataclasses.asdict(ref_cfg))
