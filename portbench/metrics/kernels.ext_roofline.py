"""kernels.ext_roofline: the least time the card needs for the
extension DPs the engine launched in the window (``work.py``'s
yardstick on the program's ``launched`` counts) over K1's device time
in the trace, in %; None where K1 did not run."""

from portbench import counts

KINDS = ("ext",)
KERNELS = ("ext_dp_kernel",)


def read(ctx):
    return counts.roofline(ctx, KINDS, KERNELS)
