"""fwd_ms.train: the median over the traced steps of the device time of
each step's ``train.forward`` spans (the program's own), in ms: the loss,
``lm_loss``, its activations checkpointed as the mix's ``remat`` says."""
from harness import spans


def read(rec):
    if rec["kind"] != "train":
        return None
    return spans.step_median_ms(rec, "train.forward")
