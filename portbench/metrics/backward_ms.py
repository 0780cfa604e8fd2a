"""backward_ms.<kind>: device ms a step of the operations the backward
launched, on whatever thread: those launched under an autograd
`evaluate_function` op or under the span `dsw.train.backward`
(`portbench.spans`)."""

from portbench import spans


def read(r, kind):
    return spans.ms_per_time(r, kind, lambda d, t: t.backward)
