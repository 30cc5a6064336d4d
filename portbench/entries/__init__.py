"""The loops that drive the port's public entries, one module per entry
named by a traffic file's ``entry``: ``setup``, ``window``, ``end_to_end``,
``enqueue``, ``probe``, ``reading``, ``release``, ``judge`` and ``control``."""

import dataclasses
from typing import Optional


@dataclasses.dataclass
class Window:
    calls: int  # products or solves completed in the window
    elapsed_s: float  # from the first call's issue to the last's completion, host clock
    samples: dict  # call index -> its output, kept for the comparison
    iterations: Optional[list] = None  # each solve's iteration count
    launches: dict = dataclasses.field(default_factory=dict)  # counters moved over the window


@dataclasses.dataclass
class Reading:
    """What a per-layer reader takes from a traced run."""

    view: object  # portbench.tracing.TraceView
    calls: int
    counts: dict  # the frozen bytes and flops of one product
    dtype: str
    iterations: Optional[int] = None  # solver iterations in the traced window
    counter_launches: Optional[int] = None  # the product route's launch counters over it
    enqueue_us: Optional[list] = None  # host µs of one entry call, behind a spacer
