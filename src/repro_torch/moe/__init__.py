"""MoE layer: router, dispatch/combine, expert FFN, and the baseline
systems' load models (``baselines``, imported here so that importing the
package fills the baseline registry, as the reference's does)."""
from . import baselines  # noqa: F401  (registers the baseline systems)
