"""engine.launch_ms_per_protein: the profiler's span ``engine.launch``
(each batch's launch(): upload, K7 and the DP kernels' launches), summed
over the window's maps, in ms a protein mapped."""


def read(ctx):
    s = ctx["stages"].get("engine.launch")
    return None if s is None else 1e3 * s / ctx["proteins"]
