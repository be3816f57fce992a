"""engine.host_join_ms_per_protein: the pump's wait for the engine's
worker threads at the end of each round (the profiler's span
``engine.host_join``, after the card's wave is decoded), summed over the
window's maps, in ms a protein mapped.  Absent where the host share runs
on the pump's own thread."""


def read(ctx):
    st = ctx["stages"]
    if "engine.host_join" not in st:
        return None
    return 1e3 * st["engine.host_join"] / ctx["proteins"]
