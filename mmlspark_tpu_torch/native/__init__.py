"""Host image ops (numpy counterparts of the JAX package's native ones)."""
