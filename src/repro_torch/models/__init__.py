"""Models built on the port's sparse layers."""
