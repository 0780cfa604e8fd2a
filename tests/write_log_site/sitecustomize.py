"""Write log of the port's CLIs (a helper, not a test): put this directory
on PYTHONPATH and name a file in DSW_WRITE_LOG, and every Python process
started with that environment (a CLI and the ranks it spawns) appends one
line per call of the port's writers of experiment outputs, `<pid> <time>
<path>`: the zarr store creation (`data.zarrstore.create_group`),
`SkillDataset.save`, `SWAG.save` and `config.write_config_file`; and, as
it exits, `<pid> <time> launches <json>`, the kernel launch counters
(`ops.bcsr.launch_counts`). tests/test_torch_cli_mesh.py and
chip_smoke.py's cli2rank read it: each output path once, by one process.
Torch and the port only."""

import atexit
import json
import os
import time

_LOG = os.environ.get("DSW_WRITE_LOG")


def _log(text):
    with open(_LOG, "a") as f:
        f.write(f"{os.getpid()} {time.time():.3f} {text}\n")


def _wrap(owner, name, at):
    """Log each call of owner.<name>; modules of the port that imported the
    function by name get the logged one too."""
    import sys

    fn = getattr(owner, name)

    def logged(*args, **kwargs):
        _log(os.path.abspath(str(args[at] if len(args) > at
                                 else kwargs.get("path"))))
        return fn(*args, **kwargs)
    setattr(owner, name, logged)
    for mod_name, mod in list(sys.modules.items()):
        if (mod_name.startswith("deepsphere_weather_torch")
                and getattr(mod, name, None) is fn):
            setattr(mod, name, logged)


if _LOG:
    from deepsphere_weather_torch.config import settings
    from deepsphere_weather_torch.data import zarrstore
    from deepsphere_weather_torch.ops import bcsr
    from deepsphere_weather_torch.prob.swag import SWAG
    from deepsphere_weather_torch.verif.deterministic import SkillDataset

    _wrap(zarrstore, "create_group", 0)
    _wrap(SkillDataset, "save", 1)
    _wrap(SWAG, "save", 1)
    _wrap(settings, "write_config_file", 1)
    atexit.register(lambda: _log("launches " + json.dumps(
        {k: int(v) for k, v in bcsr.launch_counts.items()})))
