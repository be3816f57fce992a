"""device.host_dp_ms_per_protein: the engine's host-routed DPs
(map_file(stats=) ``host_dp_s``, summed over the window's maps), in ms
a protein mapped."""


def read(ctx):
    s = [st["host_dp_s"] for st in ctx["stats"] if "host_dp_s" in st]
    return 1e3 * sum(s) / ctx["proteins"] if s else None
