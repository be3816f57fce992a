"""engine.pack_ms_per_protein: the host's batch packing, the profiler's
spans ``pump.submit`` (handing a round's requests to the engine) and
``engine.pack`` (bucketing, batch building, host prep) less the spans
nested in the latter (``engine.launch``, ``engine.drain``,
``engine.host_dp.cig_spsc_donor``), summed over the window's maps, in
ms a protein mapped."""

NESTED = ("engine.launch", "engine.drain", "engine.host_dp.cig_spsc_donor")


def read(ctx):
    st = ctx["stages"]
    if "engine.pack" not in st:
        return None
    s = (st.get("pump.submit", 0.0) + st["engine.pack"]
         - sum(st.get(k, 0.0) for k in NESTED))
    return 1e3 * s / ctx["proteins"]
