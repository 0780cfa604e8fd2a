"""outside_model_ms.<kind>: device ms a step (training) or a lead
(forecasts) of the operations tied to a `dsw.` span but to no
`dsw.model` (`portbench.spans`): in training the window gather, the loss,
the AR feedback, the gradient clipping and Adam; in forecasts the history
assembly, the inputs' concatenation and the feedback's clone and roll."""

from portbench import spans


def read(r, kind):
    return spans.ms_per_time(
        r, kind, lambda d, t: t.tied and not t.under(spans.MODEL))
