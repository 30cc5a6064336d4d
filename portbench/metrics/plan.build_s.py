"""Host seconds the port's plan cache spent building plans in this process
(``PlanCache.build_s``, summed over kinds): in the SpMM cell the plans that
the set-up's first ``spmm`` derives, the scalar-DIA plan above all; the
window only hits the cache.  None where the program keeps no such counter
or built no plan."""


def read(reading):
    from cask_tpu_torch.ops.spmv import default_plan_cache

    build_s = getattr(default_plan_cache, "build_s", None)
    return sum(build_s.values()) if build_s else None
