"""Card idle µs an iteration while the host is inside the solver's
``cg.stop_test`` spans: the loop's test and its one host sync,
``bool(norm(r) > target)``.  None where the program records no such span."""

from portbench.readers import per_iteration
from portbench.spans import idle_under


def read(reading):
    idle = idle_under(reading.view, "cg.stop_test")
    return None if idle is None else per_iteration(reading, idle)
