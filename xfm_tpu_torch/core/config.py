"""Task configs: YAML task configs, JSON vision sub-configs and CLI
overrides (`xfm_tpu/core/config.py`). PyYAML is imported inside the
functions that read or write YAML."""
from __future__ import annotations

import copy
import json
import os
from typing import Any, Mapping, Optional


def load_yaml(path: str) -> dict:
    import yaml

    with open(path, "r") as f:
        return yaml.safe_load(f) or {}


def load_json(path: str) -> dict:
    with open(path, "r") as f:
        return json.load(f)


def load_config(path: str,
                overrides: Optional[Mapping[str, Any]] = None) -> dict:
    """A task YAML with the non-None `overrides` set on top."""
    cfg = load_yaml(path)
    if overrides:
        for k, v in overrides.items():
            if v is not None:
                cfg[k] = v
    return cfg


def resolve_vision_config(cfg: dict,
                          config_root: Optional[str] = None) -> dict:
    """A copy of `cfg` with its `vision_config` JSON read into `_vision`
    (an empty dict where the file is missing); a relative path that does
    not exist is looked up by its base name under `config_root`."""
    cfg = copy.deepcopy(cfg)
    vpath = cfg.get("vision_config")
    if not vpath:
        return cfg
    if not os.path.exists(vpath) and config_root:
        cand = os.path.join(config_root, os.path.basename(vpath))
        if os.path.exists(cand):
            vpath = cand
    if os.path.exists(vpath):
        cfg["_vision"] = load_json(vpath)
    else:
        cfg.setdefault("_vision", {})
    return cfg


def dump_config(cfg: dict, path: str) -> None:
    """The config without its `_` keys, as YAML at `path`."""
    import yaml

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    clean = {k: v for k, v in cfg.items() if not k.startswith("_")}
    with open(path, "w") as f:
        yaml.safe_dump(clean, f, sort_keys=False)
