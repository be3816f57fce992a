"""kernels.dp_roofline: the least time the card needs for the DP work
it ran in the window (portbench/work.py: the unpadded cells of every
launched problem, by recurrence), over the summed device time of every
kernel in the window (all of them DP kernels and their helpers: the
index is built in set-up), in %."""

from portbench import work


def read(ctx):
    t = ctx["trace"]
    if t is None or not ctx["launched"]:
        return None
    dev_s = sum(s for _, s in t["kernels"].values())
    if dev_s <= 0:
        return None
    return 100.0 * work.least_seconds(ctx["launched"]) / dev_s
