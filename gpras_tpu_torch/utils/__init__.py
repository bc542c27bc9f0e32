"""Host utilities: serialization, JAX-free parameter conversion, phase timers and
profiler traces, the owned CRS engine and file helpers."""
