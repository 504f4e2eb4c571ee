"""Dense decoder LM of the port: layers, parameter specs, assembly."""
