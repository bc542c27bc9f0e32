"""Traffic drivers, one module per kind of traffic: a traffic file's
``driver`` key names it, and a configuration's ``limits`` hold, under the
same name, the limits of the numbers that driver's ``check`` compares. A
new kind of traffic is a new module here; nothing else names a driver.

A driver exposes the functions of ``PROTOCOL``:

``setup(cell)``
    Makes the inputs from ``cell.seed``, builds the system under test and
    warms up every shape the traffic uses; returns the run's state.
``run_window(state, seconds)``
    Runs the traffic until ``seconds`` have passed and the work in flight
    has finished; returns the window, a dict with ``attempted`` and
    ``failed`` among its keys.
``end_to_end(state, window)``
    The window's end-to-end quantities by name (``run.py`` adds
    ``setup_s``).
``layer_context(state, window)``
    What the per-layer metric readers read besides the cell, the trace and
    the window.
``check(state, window, precision)``
    Frees the program's state and compares what the window produced with
    the plain reference computed in ``precision``; returns
    ``(numbers, about)``: the numbers the configuration's limits judge, and
    what was compared.
``control_unit(state)``
    One unit of the traffic, as the window runs it, for ``control.py``.
``control_readings(state, unit, control)``
    The readings that limits are set from, as ``(reading, numbers,
    extra)`` rows: ``"program"``, the unit's numbers against the reference;
    where ``control`` is true, ``"control_tf32"``, the reference one
    precision lower put in the program's place, and any fault the traffic
    can have. ``extra`` holds detail printed beside the numbers.
"""

PROTOCOL = ("setup", "run_window", "end_to_end", "layer_context", "check",
            "control_unit", "control_readings")
