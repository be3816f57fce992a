"""pipeline.align_rounds_ms_per_protein: the port's profiler stage ``align_rounds`` (host
seconds, summed over the window's maps), in ms a protein mapped."""


def read(ctx):
    s = ctx["stages"].get("align_rounds")
    return None if s is None else 1e3 * s / ctx["proteins"]
