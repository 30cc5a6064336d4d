"""Host seconds the port spent building rank-local shards in this process
(``interop.bdia_shard_from_arrays.build_s``): the edge windows cut on the
card from the rows the rank holds.  None where the program keeps no such
counter or built no shard."""


def read(reading):
    from cask_tpu_torch import interop

    build = getattr(interop, "bdia_shard_from_arrays", None)
    return getattr(build, "build_s", None) if getattr(build, "builds", 0) else None
