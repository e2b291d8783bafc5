"""Device operations of the port: hand-written kernels and their plain versions."""
