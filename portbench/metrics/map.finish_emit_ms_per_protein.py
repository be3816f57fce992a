"""map.finish_emit_ms_per_protein: the per-map work after the pump, the
profiler's stages ``finish_align`` and ``emit`` (output filters and
formatting), summed over the window's maps, in ms a protein mapped."""

STAGES = ("finish_align", "emit")


def read(ctx):
    st = ctx["stages"]
    if not any(k in st for k in STAGES):
        return None
    return 1e3 * sum(st.get(k, 0.0) for k in STAGES) / ctx["proteins"]
