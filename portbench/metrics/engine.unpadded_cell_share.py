"""engine.unpadded_cell_share: the unpadded cells (sum of nl * al) of
every problem the engine launched over the cells their batches compute
(bucket widths and rows times the batch's problems), over the window's
maps (the program's ``launched`` counts), in %."""

from portbench import counts


def read(ctx):
    c = counts.launched(ctx)
    padded = sum(v.get("padded_cells", 0) for v in c.values())
    if padded <= 0:
        return None
    return 100.0 * sum(v.get("cells", 0) for v in c.values()) / padded
