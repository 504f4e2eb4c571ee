"""Context switching (the paper's dual-slot mechanism), its shared
reconfiguration policy, telemetry and device resolution."""
