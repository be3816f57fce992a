"""engine.card_cell_share: the unpadded cells (sum of nl * al) of the
DPs the card computed (the program's ``launched`` counts) over those
plus the host-routed DPs' cells (map_file(stats=)
``host_cells_by_reason``), over the window's maps, in %; None where
the program does not count its host cells."""

from portbench import counts


def read(ctx):
    st = [s for s in ctx["stats"] if "host_cells_by_reason" in s]
    if not st:
        return None
    card = sum(v.get("cells", 0) for v in counts.launched(ctx).values())
    host = sum(sum(s["host_cells_by_reason"].values()) for s in st)
    if card + host <= 0:
        return None
    return 100.0 * card / (card + host)
