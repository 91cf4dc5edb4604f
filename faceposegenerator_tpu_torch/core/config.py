"""Config system (port of `faceposegenerator_tpu/core/config.py`).

Configs are dataclasses with the parameter surface of the reference's
Python config modules, and each run dumps its config as JSON
(`train_ID-Booth.py:1316-1322`): `snapshot_config` writes the same JSON
object as the JAX package for the same config.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any


@dataclasses.dataclass
class ConfigBase:
    def replace(self, **kw) -> "ConfigBase":
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> dict:
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if dataclasses.is_dataclass(v):
                v = dataclasses.asdict(v)
            out[f.name] = v
        return out


def _jsonable(v: Any):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    return repr(v)


def snapshot_config(cfg: Any, output_dir: str, name: str = "training_config.json") -> str:
    """Dump the whole config as sorted JSON into the run directory; returns
    the file's path."""
    os.makedirs(output_dir, exist_ok=True)
    d = cfg.to_dict() if hasattr(cfg, "to_dict") else dict(cfg)
    path = os.path.join(output_dir, name)
    with open(path, "w") as f:
        json.dump({k: _jsonable(v) for k, v in d.items()}, f, indent=2, sort_keys=True)
    return path
