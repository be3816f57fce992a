"""map.dp_cells_per_protein: the DP cells of the window's maps, the
card's unpadded cells (the program's ``launched`` counts) plus the
host-routed DPs' (map_file(stats=) ``host_cells_by_reason``), in
millions a protein mapped; None where the program does not count its
host cells."""

from portbench import counts


def read(ctx):
    st = [s for s in ctx["stats"] if "host_cells_by_reason" in s]
    if not st or not ctx.get("proteins"):
        return None
    card = sum(v.get("cells", 0) for v in counts.launched(ctx).values())
    host = sum(sum(s["host_cells_by_reason"].values()) for s in st)
    return (card + host) / 1e6 / ctx["proteins"]
