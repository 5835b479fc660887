"""Host-side utilities of the port: metrics and checkpoints."""
