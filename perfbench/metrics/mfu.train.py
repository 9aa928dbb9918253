"""mfu.train: model FLOPs of the window's steps (forward and backward: three
times a forward's 2 per weight per token plus attention's causal products;
recomputation not counted) over the window's wall at the card's bf16 peak,
in percent."""
from harness import work


def read(rec):
    if rec["kind"] != "train":
        return None
    w0, w1 = rec["window"]
    mix = rec["mix"]
    flops = len(rec["steps"]) * work.train_flops(rec["config"], mix["batch"], mix["seq"])
    return 100.0 * flops / ((w1 - w0) * work.peaks()["bf16_flops"])
