"""Traffic drivers, one module per kind of traffic (a traffic file's
``driver`` key names it). A driver exposes ``setup(cell)``,
``run_window(state, seconds)``, ``end_to_end(state, window)``,
``layer_context(state, window)`` and ``check(state, window, precision)``."""
