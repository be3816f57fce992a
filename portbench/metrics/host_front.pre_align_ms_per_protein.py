"""host_front.pre_align_ms_per_protein: the port's profiler stage ``pre_align`` (host
seconds, summed over the window's maps), in ms a protein mapped."""


def read(ctx):
    s = ctx["stages"].get("pre_align")
    return None if s is None else 1e3 * s / ctx["proteins"]
