"""matmul_roofline.docqa: kernel A's least time for the launches it ran in
the traced slice over its device time there, in percent.  A runs the MLP's
three products of each layer for every whole chunk (the mix's chunk rows):
(c, d)·(d, ff) twice and (c, ff)·(ff, d), which read and write the same
bytes; the least time of each counts every operand byte once."""
from harness import window, work


def read(rec):
    k = window.kernel(rec, "matmul_kernel")
    cfg = rec["config"]
    if k is None or "intermediate_size" not in cfg or cfg["reference"] != "dense_gqa":
        return None
    n, secs = k
    each = work.matmul_bound_s(rec["mix"]["chunk"], cfg["hidden_size"],
                               cfg["intermediate_size"])
    return 100.0 * n * each / secs
