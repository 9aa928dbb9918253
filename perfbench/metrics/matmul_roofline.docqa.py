"""matmul_roofline.docqa: kernel A's least time for the launches it ran in
the traced slice over its device time there, in percent.  A runs the MLP's
three products of each layer with an MLP for every whole chunk (the mix's
chunk rows): (c, d)·(d, ff) twice and (c, ff)·(ff, d), which read and write
the same bytes; the least time of each counts every operand byte once.  The
widths (d, ff) are the kind's (``mlp_widths``)."""
from harness import window, work
from kinds import kind


def read(rec):
    k = window.kernel(rec, "matmul_kernel")
    cfg = rec["config"]
    widths = kind(cfg["reference"]).mlp_widths(cfg)
    if k is None or widths is None:
        return None
    n, secs = k
    d, ff = widths
    each = work.matmul_bound_s(rec["mix"]["chunk"], d, ff)
    return 100.0 * n * each / secs
