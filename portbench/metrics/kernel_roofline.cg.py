"""The share of its roofline of the SpMV inside the solves: the frozen bound
of one product over the mean device time of the solve's product kernels
(the kernels that one ``spmv(A, b)`` launched in the probe range, their
count in the window checked against the launch counters by the harness's
log line)."""

from portbench.readers import product_ops, roofline_percent


def read(reading):
    ops = product_ops(reading)
    if not ops:
        return None
    return roofline_percent(reading, sum(e["dur"] for e in ops) / len(ops))
