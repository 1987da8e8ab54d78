"""Live-tunable debug parameters (headless); a copy of
`mobileposer_tpu/physics/debug_params.py`, pure Python.

Behavioral parity target: the reference's pybullet debug helpers
(`articulate/utils/bullet/bullet.py:19-84`), which expose tuning knobs as
bullet GUI sliders, read them each frame, and persist them to json
(schema: [{"name", "min", "max", "value"}, ...] — see the reference's
`_example_debug_params.json`). Servers are headless, so the slider UI
becomes a LIVE-RELOADED json file: edit the file while the system runs,
`poll()` picks the change up on mtime; values clamp to [min, max] exactly
like a slider would. `remove_collision` / `change_color` are bullet-GUI
cosmetics with no headless meaning and are intentionally not reproduced
(PARITY.md).

    params = DebugParams.from_json("debug_params.json")
    ...
    while running:
        params.poll()                      # re-reads if the file changed
        k = params["kp"]
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional


class DebugParams:
    """Clamped name->value store with json round-trip + live reload."""

    def __init__(self, attrs: Optional[List[dict]] = None,
                 path: Optional[str] = None):
        self._attrs: List[dict] = [dict(a) for a in (attrs or [])]
        self._path = path
        self._mtime = self._stat()
        for a in self._attrs:
            a["value"] = self._clamp(a, a.get("value", a.get("min", 0.0)))

    # -- json round trip (reference: bullet.py:38-84) -----------------------
    @classmethod
    def from_json(cls, path) -> "DebugParams":
        with open(path) as f:
            return cls(json.load(f), path=str(path))

    def save(self, path=None) -> str:
        if path is None and self._path is None:
            raise ValueError("no path: this DebugParams was built from "
                             "attrs — pass save(path=...)")
        path = str(path or self._path)
        with open(path, "w") as f:
            json.dump(self._attrs, f, indent=2)
        if path == self._path:
            self._mtime = self._stat()
        return path

    def values(self) -> Dict[str, float]:
        """All current values (reference: read_debug_param_values_*)."""
        return {a["name"]: a["value"] for a in self._attrs}

    # -- live reload (replaces reading bullet sliders each frame) -----------
    def poll(self) -> bool:
        """Re-read the backing file if it changed. Returns True on reload;
        a malformed mid-edit file is skipped and retried next poll (the
        mtime is only committed after a successful parse, so a completed
        write under the same timestamp is still picked up)."""
        if self._path is None:
            return False
        m = self._stat()
        if m == self._mtime:
            return False
        try:
            with open(self._path) as f:
                attrs = json.load(f)
        except (json.JSONDecodeError, OSError):
            return False
        self._mtime = m
        self._attrs = [dict(a) for a in attrs]
        for a in self._attrs:
            a["value"] = self._clamp(a, a.get("value", a.get("min", 0.0)))
        return True

    # -- dict-ish access ------------------------------------------------------
    def __getitem__(self, name: str) -> float:
        for a in self._attrs:
            if a["name"] == name:
                return a["value"]
        raise KeyError(name)

    def __setitem__(self, name: str, value: float) -> None:
        for a in self._attrs:
            if a["name"] == name:
                a["value"] = self._clamp(a, value)
                return
        raise KeyError(name)

    def __contains__(self, name: str) -> bool:
        return any(a["name"] == name for a in self._attrs)

    def __iter__(self):
        return iter(self.values())

    @staticmethod
    def _clamp(attr: dict, value: float) -> float:
        lo = attr.get("min", float("-inf"))
        hi = attr.get("max", float("inf"))
        return float(min(max(value, lo), hi))

    def _stat(self) -> Optional[float]:
        if self._path is None or not os.path.exists(self._path):
            return None
        return os.stat(self._path).st_mtime
