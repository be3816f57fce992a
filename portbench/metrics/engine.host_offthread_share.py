"""engine.host_offthread_share: the host-routed DPs that ran on the
engine's worker threads (map_file(stats=) ``host_offthread``) over all
host-routed DPs (``n_host``), summed over the window's maps, in %."""


def read(ctx):
    st = [s for s in ctx["stats"] if "host_offthread" in s]
    n_host = sum(s.get("n_host", 0) for s in st)
    if not st or n_host <= 0:
        return None
    return 100.0 * sum(s["host_offthread"] for s in st) / n_host
