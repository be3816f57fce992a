"""The program's own counts of the DP work it launched, and the least
time the card needs for them by ``work.py``'s yardstick.

A map of the port reports, in ``map_file(stats=)["launched"]``, per DP
recurrence ("ext", "cigar", "cigar32"), the problems of every batch its
engine launched: ``problems``, ``cells`` (sum of nl * al, unpadded),
``seq_bytes`` (sum of nl + al) and ``padded_cells``.  A port that does
not count them reports nothing, and the readers then return None."""

from __future__ import annotations

from portbench import work


def launched(ctx) -> dict:
    """{recurrence: {count: sum}} over every map of the window; {} where
    the maps report no counts."""
    out: dict = {}
    for st in ctx.get("stats") or []:
        for kind, c in st.get("launched", {}).items():
            acc = out.setdefault(kind, {})
            for k, v in c.items():
                acc[k] = acc.get(k, 0) + v
    return out


def least_seconds(counts: dict, kinds) -> float:
    """``work.least_seconds`` of the problems of recurrences ``kinds``
    from their sums alone: the larger of the operations' time at their
    rates and all bytes over the bandwidth."""
    op_s = nbytes = 0.0
    for kind in kinds:
        c = counts.get(kind)
        if not c:
            continue
        op_s += work.OPS_PER_CELL[kind] * c["cells"] / work.OPS_PER_S[kind]
        nbytes += c["seq_bytes"] + work.RESULT_BYTES[kind] * c["problems"]
    return max(op_s, nbytes / work.HBM_BYTES_PER_S)


def roofline(ctx, kinds, kernels) -> float | None:
    """The least time for the launched problems of ``kinds`` over the
    device time of the ``kernels`` that computed them in the traced
    window, in %; None where none of those kernels ran or nothing was
    counted."""
    t = ctx["trace"]
    counts = launched(ctx)
    if t is None or not any(counts.get(k, {}).get("problems")
                            for k in kinds):
        return None
    dev_s = sum(s for name, (_, s) in t["kernels"].items()
                if name in kernels)
    if dev_s <= 0:
        return None
    return 100.0 * least_seconds(counts, kinds) / dev_s
