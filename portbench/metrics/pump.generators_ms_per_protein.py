"""pump.generators_ms_per_protein: the align generators' host work in
the pump, the profiler's spans ``pump.prime`` (starting each absorbed
chunk's generators) and ``pump.advance`` (each round's sends: the
generators' work up to their next request, CIGAR assembly included),
summed over the window's maps, in ms a protein mapped."""

SPANS = ("pump.prime", "pump.advance")


def read(ctx):
    st = ctx["stages"]
    if not any(k in st for k in SPANS):
        return None
    return 1e3 * sum(st.get(k, 0.0) for k in SPANS) / ctx["proteins"]
