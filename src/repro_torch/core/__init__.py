"""Context switching (the paper's dual-slot mechanism), its shared
reconfiguration policy, telemetry and device resolution; the Super-Sub
cascade and the reconfiguration simulator that run on it."""
from repro_torch.core.context import (
    ContextState, ContextDescriptor, ContextSlot, ContextSwitchEngine,
    ContextStore,
)
from repro_torch.core.policy import EnsureDecision, ReconfigPolicy
from repro_torch.core.scheduler import (
    simulate_conventional, simulate_preloaded, simulate_dynamic, time_saving,
)
from repro_torch.core import hwmodel
from repro_torch.core.cascade import SuperSubCascade
