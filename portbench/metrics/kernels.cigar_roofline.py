"""kernels.cigar_roofline: the least time the card needs for the
gap-filling DPs with traceback the engine launched in the window
(``work.py``'s yardstick on the program's ``launched`` counts, int16 and
int32) over the device time of the CIGAR route's kernels that ran (K2
and K3; K4, K4' and K5 on the striped route), in %; None where none
ran."""

from portbench import counts

KINDS = ("cigar", "cigar32")
KERNELS = ("scan_cigar_kernel", "run_walk_kernel", "striped_cigar_kernel",
           "striped32_kernel", "cell_walk_kernel")


def read(ctx):
    return counts.roofline(ctx, KINDS, KERNELS)
