"""train_tok_s: trained tokens of every step that ended in the window, over
the window's seconds."""


def read(rec):
    if rec["kind"] != "train":
        return None
    w0, w1 = rec["window"]
    n = sum(1 for _, end in rec["steps"] if w0 <= end <= w1)
    return n * rec["step_tokens"] / (w1 - w0)
