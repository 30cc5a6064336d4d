"""The share of the traced window of CG solves in which no kernel, copy or
memset runs on the card (the union of device intervals)."""

from portbench.readers import idle_percent


def read(reading):
    return idle_percent(reading)
