"""pipeline.pre_align_wait_ms_per_protein: the port's profiler stage ``pre_align_wait`` (host
seconds, summed over the window's maps), in ms a protein mapped."""


def read(ctx):
    s = ctx["stages"].get("pre_align_wait")
    return None if s is None else 1e3 * s / ctx["proteins"]
