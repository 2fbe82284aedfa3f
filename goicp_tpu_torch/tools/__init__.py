"""Command-line tools over the port's engines (the counterparts of the
repo's `tools/` scripts that drive the JAX package)."""
