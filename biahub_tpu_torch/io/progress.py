"""Per-unit resume records keyed by a settings fingerprint.

Counterpart of ``biahub_tpu/io/progress.py``, with the same record layout:
``<plate>/.biahub_tpu_progress/<row>_<col>_<fov>.p<rank>.json`` holding
``token`` and ``done``. A unit is marked done only after its chunks are
written. Each process owns its own record file (one writer, atomic
replace), and a unit is done when any record of its position says so, so a
restarted run, with any process count, sees every finished unit. A changed
token (settings fingerprint) drops the records.
"""

from __future__ import annotations

import json
import os
import tempfile
from pathlib import Path

from biahub_tpu_torch.parallel.distributed import process_index

__all__ = ["ProgressStore"]


class ProgressStore:
    """Completion records for (t, c) work units of one output position."""

    def __init__(self, output_position_path: str | Path, token: str):
        output_position_path = Path(output_position_path)
        # Beside the plate: deleting the plate removes them too.
        plate_root = output_position_path.parents[2]
        self._rel = "_".join(output_position_path.parts[-3:])
        self._dir = plate_root / ".biahub_tpu_progress"
        self.path = self._dir / f"{self._rel}.p{process_index()}.json"
        self.token = token
        self._done: set[str] = set()
        self._load()

    @staticmethod
    def _key(t: int, c: int) -> str:
        return f"{t}.{c}"

    def _read_record(self, path: Path) -> set[str]:
        try:
            payload = json.loads(path.read_text())
        except (OSError, json.JSONDecodeError):
            return set()
        if payload.get("token") != self.token:
            return set()
        return set(payload.get("done", []))

    def _load(self) -> None:
        # Anchored at ".p<digits>": a bare f"{rel}*" would also match a
        # position whose name extends this one (A_1_0 vs A_1_01).
        for path in sorted(self._dir.glob(f"{self._rel}.p*.json")):
            if path.name[len(self._rel) + 2: -len(".json")].isdigit():
                self._done |= self._read_record(path)
        legacy = self._dir / f"{self._rel}.json"
        if legacy.exists():
            self._done |= self._read_record(legacy)

    def is_done(self, t: int, c: int) -> bool:
        return self._key(t, c) in self._done

    def mark_done(self, t: int, c: int) -> None:
        self._done.add(self._key(t, c))
        self._flush()

    def mark_many_done(self, units: list[tuple[int, int]]) -> None:
        self._done.update(self._key(t, c) for t, c in units)
        self._flush()

    def _flush(self) -> None:
        self._dir.mkdir(parents=True, exist_ok=True)
        payload = {"token": self.token, "done": sorted(self._done)}
        fd, tmp = tempfile.mkstemp(dir=self._dir, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f)
            os.replace(tmp, self.path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
