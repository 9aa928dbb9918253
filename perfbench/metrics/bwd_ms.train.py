"""bwd_ms.train: the median over the traced steps of the device time of
each step's ``train.backward`` spans (the program's own), in ms: the
gradients, ``torch.autograd.grad``, with the forward's recomputation."""
from harness import spans


def read(rec):
    if rec["kind"] != "train":
        return None
    return spans.step_median_ms(rec, "train.backward")
