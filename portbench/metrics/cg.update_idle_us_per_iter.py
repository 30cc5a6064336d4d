"""Card idle µs an iteration while the host is inside the solver's
``cg.update`` spans: the rest of the iteration, its dots, vector updates
and ``M``.  None where the program records no such span."""

from portbench.readers import per_iteration
from portbench.spans import idle_under


def read(reading):
    idle = idle_under(reading.view, "cg.update")
    return None if idle is None else per_iteration(reading, idle)
