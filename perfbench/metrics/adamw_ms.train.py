"""adamw_ms.train: the median over the traced steps of the device time of
each step's ``train.adamw`` spans (the program's own), in ms: the
optimizer, ``adamw.update``: the gradients' norm, clipping and the update
of every parameter."""
from harness import spans


def read(rec):
    if rec["kind"] != "train":
        return None
    return spans.step_median_ms(rec, "train.adamw")
