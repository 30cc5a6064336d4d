"""Device µs a product in which the halo exchange runs alone: an NCCL
kernel runs and no other kernel, copy or memset does (0 where no NCCL
kernel ran, as on a world of one rank)."""

from portbench.exchange import exposed_us


def read(reading):
    exposed = exposed_us(reading.view)
    return None if exposed is None or not reading.calls else exposed / reading.calls
