"""mfu.map: the least time the card needs for all the DP work it ran in
the window (portbench/work.py, as ``kernels.dp_roofline``), over the
whole traced window, in %: the map's share of the card's peak.  A DP
moved off the card lowers it, where ``kernels.dp_roofline`` would only
fall silent or rise."""

from portbench import work


def read(ctx):
    t = ctx["trace"]
    if t is None or not ctx["launched"] or t["window_s"] <= 0:
        return None
    if sum(s for _, s in t["kernels"].values()) <= 0:
        return None  # no kernel ran on a card
    return 100.0 * work.least_seconds(ctx["launched"]) / t["window_s"]
