"""Device µs a product of the operations the host launched inside the
program's ``dist.fixup`` spans: the edge terms the halo brings and their
adds into y.  None where the program records no such span."""

from portbench.exchange import launched_under


def read(reading):
    ops = launched_under(reading.view, "dist.fixup")
    return None if ops is None or not reading.calls else \
        sum(e["dur"] for e in ops) / reading.calls
