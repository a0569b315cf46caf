"""Engine facade, typed configuration and the plugin registries."""
from .config import (ConfigError, DeviceProfile, DisaggConfig, FleetConfig,
                     MemoryConfig, PlacementSpec, ReplicationConfig,
                     ResilienceConfig, RuntimeConfig,
                     SchedulePolicy, ServeConfig, TelemetryConfig,
                     profile_slot_budgets, profile_weights)
from .registry import (Registry, RegistryError, baseline_systems,
                       get_baseline_system, get_placement_strategy,
                       placement_strategies, register_baseline_system,
                       register_placement_strategy)
from .engine import MicroEPEngine

__all__ = ["ConfigError", "DeviceProfile", "DisaggConfig", "FleetConfig",
           "MemoryConfig",
           "MicroEPEngine", "PlacementSpec", "Registry", "RegistryError", "ReplicationConfig",
           "ResilienceConfig",
           "RuntimeConfig",
           "SchedulePolicy", "ServeConfig", "TelemetryConfig",
           "baseline_systems", "get_baseline_system",
           "get_placement_strategy", "placement_strategies",
           "profile_slot_budgets", "profile_weights",
           "register_baseline_system", "register_placement_strategy"]
