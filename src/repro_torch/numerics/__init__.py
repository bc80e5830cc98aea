"""Fixed-point numerics of the port."""
