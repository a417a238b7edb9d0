"""Boolean env-flag parsing shared by every ENDODAV_* switch.

Port of `endodav_tpu/utils/envflags.py`.  A/B switches are driven as
``FLAG=1 cmd`` against ``FLAG=0 cmd`` (or unset); a bare
``bool(os.environ.get(name))`` would treat "0" as enabled, so every
boolean ENDODAV_* flag goes through :func:`env_on`.  Nothing in the port
writes the environment: it only reads these switches.
"""

from __future__ import annotations

import os

__all__ = ["env_on", "env_auto"]

_FALSY = ("", "0", "false", "off", "no")


def env_on(name: str) -> bool:
    """Truthiness of an opt-in/opt-out env flag: the falsy spellings ("0",
    "false", "off", "no", "", any case, surrounding blanks) mean off."""
    return os.environ.get(name, "").strip().lower() not in _FALSY


def env_auto(name: str, default: bool) -> bool:
    """An explicitly set env var wins (with env_on's spellings, so FLAG=0
    still forces off); an unset one falls back to ``default``."""
    if name in os.environ:
        return env_on(name)
    return default
