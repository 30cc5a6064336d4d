"""The cell finder of a planted fault, for the tests alone: the cell as
``BENCHMARK.json`` has it, run by a port whose ``DistSpmv`` skips the edge
fix-ups (the terms the halo brings).  ``ranks.run(..., cells=CELLS)``
plants it in every rank."""

from portbench import spec

CELLS = "portbench.tests.dist_fault:cell"


def cell(workload: str, bench: dict) -> spec.Cell:
    import cask_tpu_torch.parallel.dist as dist

    dist._bdia_edge_fixups = lambda sh, left, right: (None, None)
    return spec.cell(workload, bench)
