"""engine.decode_ms_per_protein: the profiler's spans ``engine.decode``
(each collected batch's decode on the host: the CIGARs' run expansion,
the results' conversion) and ``engine.drain.decode`` (the same for the
batches a planes-cap drain collects, inside ``engine.drain``), summed
over the window's maps, in ms a protein mapped."""

SPANS = ("engine.decode", "engine.drain.decode")


def read(ctx):
    st = ctx["stages"]
    if "engine.decode" not in st:
        return None
    return 1e3 * sum(st.get(k, 0.0) for k in SPANS) / ctx["proteins"]
