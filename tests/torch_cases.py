"""The smoke configs the port's dense and expert-tensor-parallel paths are
held to the reference on, shared by the ``test_torch_*`` parity tests.

``ArchConfig.smoke()`` sets ``etp`` to 1, so an expert-tensor-parallel case
sets it back with ``dataclasses.replace``; each case is built the same way
for the reference and (through :func:`port_config`) for the port."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config
from repro.models import decoder as rdec
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


def plain(tree):
    """A tree of dicts, tuples and numpy arrays: what spawned ranks
    unpickle without importing JAX or the reference."""
    if isinstance(tree, dict):
        return {k: plain(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(plain(v) for v in tree)
    return np.asarray(tree)


def reference_params(ref_cfg) -> dict:
    """The reference session's weights for ``seed=0``, as a plain tree."""
    return plain(jax.tree_util.tree_map(
        np.asarray, rdec.init_params(jax.random.PRNGKey(0), ref_cfg,
                                     jnp.float32)))


def canonical(d: dict) -> dict:
    """A serving report's dict minus every wall-clock-derived field."""
    d = dict(d)
    for k in ("wall_s", "gen_tokens_per_s", "tokens_per_s", "latency_ms",
              "ttft_ms"):
        d.pop(k)
    d["per_request"] = [{k: v for k, v in r.items()
                         if k not in ("latency_ms", "ttft_ms")}
                        for r in d["per_request"]]
    return json.loads(json.dumps(d, sort_keys=True))
