"""Per-sweep readings of the program's own counters (tracs_tpu_torch's
runtime/profiling.py), which count whether or not the program records
spans: a counter's total over the number of sweeps the process made
(``sweep.runs``: one a ``pairsnp_stream`` call that sweeps), the set-up's
warm sweeps and the profiled ones included.  A program that keeps no
``sweep.runs`` reads None."""


def per_sweep(ctx, name: str):
    """``name``'s total a sweep, or None outside sweep units or where the
    program has no such counter."""
    if ctx.unit != "sweep":
        return None
    from tracs_tpu_torch.runtime import profiling

    counters = getattr(profiling, "counters", None)
    if not counters or not counters.get("sweep.runs") or name not in counters:
        return None
    return counters[name] / counters["sweep.runs"]
