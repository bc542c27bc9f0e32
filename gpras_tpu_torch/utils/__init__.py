"""Host utilities: serialization and JAX-free parameter conversion."""
