"""Per-job readings of the program's own counters (tracs_tpu_torch's
runtime/profiling.py), which count whether or not the program records
spans: a counter's total over the number of ``distance`` stage runs the
process made (``stage.runs``), the set-up's warm job and the profiled jobs
included.  A program that keeps no such counters reads None."""


def per_job(ctx, name: str):
    """``name``'s total a stage run, or None outside job units or where the
    program has no such counter."""
    if ctx.unit != "job":
        return None
    from tracs_tpu_torch.runtime import profiling

    counters = getattr(profiling, "counters", None)
    if not counters or not counters.get("stage.runs") or name not in counters:
        return None
    return counters[name] / counters["stage.runs"]
