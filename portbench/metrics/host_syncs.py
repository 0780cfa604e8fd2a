"""host_syncs.<kind>: device-to-host copies (`Memcpy DtoH` operations) a
step (training) or a forecast launched inside the program's `dsw.` spans
(`portbench.spans`): each is a wait of the host for the device
(`.item()`, `.cpu()`, `bool(tensor)`, `nonzero`). The harness's own
copies and synchronisations lie outside the spans."""

from portbench import spans


def read(r, kind):
    if r.kind != kind or r.trace is None:
        return None
    tied = spans.ties(r.trace)
    if tied is None:
        return None
    n = sum(1 for d, t in tied if t is not None and t.tied
            and d.get("cat") == "gpu_memcpy" and "DtoH" in d["name"])
    return n / r.stretch_units
