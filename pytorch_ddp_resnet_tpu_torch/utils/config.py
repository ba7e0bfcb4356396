"""YAML run-config system (own copy of pytorch_ddp_resnet_tpu/utils/
config.py): a run's ``config.yaml`` merged over programmatic defaults and
exposed dict-like, so call sites pick the keys they need."""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import yaml


class ConfigParser(dict):
    """Dict-like view over defaults merged with a YAML file; file keys win
    over defaults."""

    def __init__(self, defaults: Optional[Dict[str, Any]] = None) -> None:
        super().__init__()
        self._defaults = dict(defaults) if defaults else {}
        self._config: Optional[Dict[str, Any]] = None

    def read(self, config_path: str, verbose: bool = False) -> None:
        config = dict(self._defaults)
        with open(config_path, "rb") as f:
            loaded = yaml.safe_load(f)
        if loaded:
            config.update(loaded)
        self._config = config
        if verbose:
            for k in self._config:
                print(f"{k}: {self._config[k]}")

    def __getitem__(self, item: str) -> Any:
        return self._config[item]

    def __contains__(self, item: object) -> bool:
        return self._config is not None and item in self._config

    def get(self, item: str, default: Any = None) -> Any:
        return self._config.get(item, default)

    def items(self):
        return self._config.items()

    def keys(self):
        return self._config.keys()

    def values(self):
        return self._config.values()

    def __iter__(self):
        return iter(self._config)

    def __len__(self) -> int:
        return 0 if self._config is None else len(self._config)

    def as_dict(self) -> Dict[str, Any]:
        return dict(self._config)


def get_run_paths(models_dir: str, run_name: str) -> Dict[str, str]:
    """The per-run directory layout."""
    base_path = os.path.join(models_dir, run_name)
    return {
        "base_path": base_path,
        "config_path": os.path.join(base_path, "config.yaml"),
        "checkpoint_dir": os.path.join(base_path, "checkpoints"),
        "log_dir": os.path.join(base_path, "tensorboard_logs"),
    }


def get_config(
    models_dir: str,
    run_name: str,
    mode: str = "train",
    data_dir: str = "data_dir",
    verbose: bool = True,
    extra_defaults: Optional[Dict[str, Any]] = None,
) -> ConfigParser:
    """Load a run's config.yaml over the standard defaults."""
    paths = get_run_paths(models_dir, run_name)
    defaults = {
        "mode": mode,
        "data_dir": data_dir,
        "checkpoint_dir": paths["checkpoint_dir"],
        "log_dir": paths["log_dir"],
    }
    if extra_defaults:
        defaults.update(extra_defaults)
    config = ConfigParser(defaults=defaults)
    config.read(paths["config_path"], verbose=verbose)
    return config
