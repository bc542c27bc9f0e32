"""Per-layer metrics, one reader file each, named as in BENCHMARK.json (which
also says what each moves). A reader holds ``read(ctx)``, which returns the
metric's value or None where the traced window gave it nothing to read.
``<name>.json`` holding ``{"reads": <other>}`` points a metric at another
reader, or an end-to-end metric at another of the driver's quantities.
``ctx`` holds the cell, the ``DeviceTrace`` of the window, the window's
record and what the traffic driver's ``layer_context`` adds."""
