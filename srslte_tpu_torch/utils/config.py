"""Dotted-flag configuration: INI file + CLI overrides (main.cc equivalent).

Reference behavior: srsue/src/main.cc:66-515 — boost::program_options
merging a .conf (INI sections -> dotted keys like rf.device_args,
phy.nof_phy_threads) with command-line --section.key=value overrides and
typed defaults.
"""

from __future__ import annotations

import configparser
from dataclasses import dataclass, field


@dataclass
class Config:
    defaults: dict = field(default_factory=dict)  # dotted key -> default
    values: dict = field(default_factory=dict)

    def declare(self, key: str, default):
        self.defaults[key] = default

    def load_file(self, path: str):
        cp = configparser.ConfigParser()
        cp.read(path)
        for section in cp.sections():
            for k, v in cp.items(section):
                self.values[f"{section}.{k}"] = v

    def load_args(self, argv: list):
        """--section.key=value overrides; returns unconsumed args."""
        rest = []
        for a in argv:
            if a.startswith("--") and "=" in a:
                k, v = a[2:].split("=", 1)
                if "." in k:
                    self.values[k] = v
                    continue
            rest.append(a)
        return rest

    def get(self, key: str):
        """Typed get: the declared default's type coerces the string value."""
        if key not in self.defaults and key not in self.values:
            raise KeyError(f"undeclared config key {key}")
        default = self.defaults.get(key)
        if key not in self.values:
            return default
        raw = self.values[key]
        if isinstance(default, bool):
            return str(raw).lower() in ("1", "true", "yes", "on")
        if default is None or isinstance(raw, type(default)):
            return raw
        return type(default)(raw)

    def as_dict(self) -> dict:
        out = dict(self.defaults)
        for k in self.values:
            if k in self.defaults:
                out[k] = self.get(k)
            else:
                out[k] = self.values[k]
        return out
