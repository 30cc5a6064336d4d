"""Device µs an iteration in the solve's operations other than its product:
vector updates, reductions, scalar arithmetic and casts."""

from portbench.readers import per_iteration, product_ops


def read(reading):
    ours = {id(e) for e in product_ops(reading)}
    rest = sum(e["dur"] for e in reading.view.device_ops if id(e) not in ours)
    return per_iteration(reading, rest) if reading.view.device_ops else None
