"""Card idle µs an iteration while the host is inside the solver's
``cg.product`` spans: ``op(p)``, the product's entry, its plan look-up and
its launches.  None where the program records no such span."""

from portbench.readers import per_iteration
from portbench.spans import idle_under


def read(reading):
    idle = idle_under(reading.view, "cg.product")
    return None if idle is None else per_iteration(reading, idle)
