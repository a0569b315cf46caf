"""String-keyed plugin registries for the MicroEP engine (the port's copy
of ``repro.engine.registry``).

Two extension points are registries instead of if/elif chains:

  * **placement strategies** — ``(rows, cols, num_experts, *, seed, loads)
    -> Placement`` factories (paper §6).  The built-ins (vanilla / random /
    latin / asymmetric / replicated) are registered below; adding a new
    strategy is one decorated function::

        from repro_torch.engine import register_placement_strategy

        @register_placement_strategy("my-strategy")
        def my_strategy(rows, cols, num_experts, *, seed=0, loads=None):
            return Placement(...)

  * **baseline systems** — ``(loads, num_devices, slots, hist=None) ->
    (max_device_load, dropped_fraction)`` load models of published systems
    (paper §7.1).  Built-ins live in ``repro_torch.moe.baselines`` and register
    themselves the same way via ``register_baseline_system``.

Unknown keys raise :class:`RegistryError` listing every registered option,
so a typo'd ``--placement`` flag fails with the menu instead of a bare
``ValueError(strategy)``.
"""
from __future__ import annotations

from typing import Callable, Iterator, Mapping, Optional

import numpy as np

from ..core.placement import (Placement, asymmetric_placement,
                              latin_placement, random_placement,
                              vanilla_placement)

__all__ = [
    "Registry",
    "RegistryError",
    "placement_strategies",
    "baseline_systems",
    "register_placement_strategy",
    "register_baseline_system",
    "get_placement_strategy",
    "get_baseline_system",
]


class RegistryError(KeyError, ValueError):
    """Unknown key or conflicting registration in a plugin registry.

    Subclasses KeyError so the Mapping protocol stays honest (``name in
    registry`` returns False instead of raising) and ValueError so callers
    treating a bad name as a bad value keep working.
    """

    def __str__(self) -> str:  # KeyError would repr() the message
        return self.args[0] if self.args else ""


class Registry(Mapping):
    """A named string -> callable mapping with helpful failure modes.

    Implements the read-only ``Mapping`` protocol so legacy dict-style
    consumers (``name in REG``, ``REG[name]``, iteration) keep working while
    lookups of unknown keys raise :class:`RegistryError` with the full menu
    of registered options.
    """

    def __init__(self, kind: str):
        self.kind = kind
        self._entries: dict[str, Callable] = {}

    # ------------------------------------------------------------ mutation
    def register(self, name: str, fn: Optional[Callable] = None, *,
                 override: bool = False):
        """Register ``fn`` under ``name``; usable as a decorator.

        Re-registering an existing name is an error unless ``override=True``
        (explicit replacement beats silent shadowing in plugin systems).
        """
        if not isinstance(name, str) or not name:
            raise RegistryError(
                f"{self.kind} name must be a non-empty string, got {name!r}")

        def _do(f: Callable) -> Callable:
            if name in self._entries and not override:
                raise RegistryError(
                    f"{self.kind} {name!r} is already registered "
                    f"(pass override=True to replace it)")
            self._entries[name] = f
            return f

        return _do if fn is None else _do(fn)

    def unregister(self, name: str) -> None:
        self._entries.pop(name, None)

    # ------------------------------------------------------------- lookup
    _RAISE = object()

    def get(self, name: str, default=_RAISE) -> Callable:
        """Lookup by name.  Without ``default`` an unknown key raises
        :class:`RegistryError` listing the registered options; with a
        ``default`` this follows ``Mapping.get`` and returns it instead."""
        try:
            return self._entries[name]
        except KeyError:
            if default is not Registry._RAISE:
                return default
            raise RegistryError(
                f"unknown {self.kind} {name!r}; registered options: "
                f"{', '.join(self.names()) or '(none)'}") from None

    def names(self) -> tuple[str, ...]:
        return tuple(sorted(self._entries))

    # ------------------------------------------------------ Mapping proto
    def __getitem__(self, name: str) -> Callable:
        return self.get(name)

    def __iter__(self) -> Iterator[str]:
        return iter(sorted(self._entries))

    def __len__(self) -> int:
        return len(self._entries)

    def __repr__(self) -> str:
        return f"Registry({self.kind!r}, {list(self.names())})"


placement_strategies = Registry("placement strategy")
baseline_systems = Registry("baseline system")


def register_placement_strategy(name: str, fn: Optional[Callable] = None, *,
                                override: bool = False):
    """Register ``fn(rows, cols, num_experts, *, seed=0, loads=None) ->
    Placement`` under ``name`` (decorator-friendly)."""
    return placement_strategies.register(name, fn, override=override)


def register_baseline_system(name: str, fn: Optional[Callable] = None, *,
                             override: bool = False):
    """Register ``fn(loads, num_devices, slots, hist=None) -> (max_load,
    dropped_fraction)`` under ``name`` (decorator-friendly)."""
    return baseline_systems.register(name, fn, override=override)


def get_placement_strategy(name: str) -> Callable:
    return placement_strategies.get(name)


def get_baseline_system(name: str) -> Callable:
    return baseline_systems.get(name)


# ---------------------------------------------------------------------------
# built-in placement strategies (paper §6.2-6.3)
# ---------------------------------------------------------------------------


@register_placement_strategy("vanilla")
def _vanilla(rows: int, cols: int, num_experts: int, *, seed: int = 0,
             loads=None) -> Placement:
    """Canonical Megatron EP layout (Fig. 3b scheduling space)."""
    return vanilla_placement(rows, cols, num_experts)


@register_placement_strategy("random")
def _random(rows: int, cols: int, num_experts: int, *, seed: int = 0,
            loads=None) -> Placement:
    """Independent random expert-level shuffle per row (Fig. 3c)."""
    return random_placement(rows, cols, num_experts, seed=seed)


@register_placement_strategy("latin")
def _latin(rows: int, cols: int, num_experts: int, *, seed: int = 0,
           loads=None) -> Placement:
    """Symmetric circulant / Cayley construction (Appendix B)."""
    return latin_placement(rows, cols, num_experts)


@register_placement_strategy("asymmetric")
def _asymmetric(rows: int, cols: int, num_experts: int, *, seed: int = 0,
                loads=None, num_samples: int = 64, slot_budgets=None,
                weights=None) -> Placement:
    """Greedy replica counts + Monte-Carlo placement on real loads (§6.3).
    ``num_samples`` (strategy-specific kwarg) sizes the Monte-Carlo search.
    Budget/weight-aware (DESIGN.md §11): ``slot_budgets`` caps per-device
    replica slots, ``weights`` scores candidates on weighted makespan —
    the engine passes both automatically when device profiles are set."""
    if loads is None:
        raise RegistryError(
            "placement strategy 'asymmetric' needs per-expert loads "
            "(PlacementSpec(loads=...) or the loads= argument)")
    return asymmetric_placement(rows, cols, num_experts,
                                np.asarray(loads, np.float64), seed=seed,
                                num_samples=num_samples,
                                slot_budgets=slot_budgets, weights=weights)


@register_placement_strategy("replicated")
def _replicated(rows: int, cols: int, num_experts: int, *, seed: int = 0,
                loads=None, slot_budgets=None, weights=None) -> Placement:
    """Replica-topology plan (DESIGN.md §12): water-filled replica counts
    + EPLB-style greedy pack onto the least-loaded devices.  Deterministic
    (``seed`` is unused).  ``loads`` default to uniform; the engine passes
    ``slot_budgets``/``weights`` automatically when device profiles are
    set.  This is the static seed topology the ``repro.replication``
    controller migrates at runtime.

    Imported lazily so the engine never loads ``replication`` (and its
    telemetry dependency) unless the strategy is actually used.
    """
    from ..replication.topology import replicated_placement
    return replicated_placement(
        rows, cols, num_experts,
        None if loads is None else np.asarray(loads, np.float64),
        slot_budgets=slot_budgets, weights=weights)
