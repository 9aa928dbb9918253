"""plan_s: host seconds of the kernel plans' warm-up in set-up
(``warm_kernel_plans`` over every row count the traffic sends), by the
harness's clock."""


def read(rec):
    return rec.get("plan_s")
