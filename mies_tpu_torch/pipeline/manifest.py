"""Run manifest: idempotent, resumable batch jobs (SURVEY.md sections 5.3-5.4).

A copy of ``mies_tpu.pipeline.manifest``: the same JSONL records under the
same ``PipelineConfig.cache_key()``, so a run either package began, the
other resumes.

The pipeline is stateless, so 'checkpoint/resume' for this framework is
a manifest of completed outputs keyed by (config hash, input id): a
re-run of the same job skips finished items and redoes the rest. Failure
detection is per-item — one corrupt file doesn't kill the batch job.

The manifest is an append-only JSONL file (crash-safe: a torn final
line is ignored), stored next to the outputs.
"""

from __future__ import annotations

import json
import os
import threading
from pathlib import Path
from typing import Any


class RunManifest:
    def __init__(self, path: str | Path, config_hash: str):
        self.path = Path(path)
        self.config_hash = config_hash
        self._done: dict[str, dict[str, Any]] = {}
        self._failed: dict[str, str] = {}
        # the batch runner appends from the decode-prefetch thread AND
        # the main thread concurrently
        self._lock = threading.Lock()
        if self.path.exists():
            self._load()

    def _load(self) -> None:
        for line in self.path.read_text().splitlines():
            if not line.strip():
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue  # torn tail from a crash — ignore
            if rec.get("config") != self.config_hash:
                continue  # different pipeline — not our progress
            if rec.get("status") == "done":
                self._done[rec["item"]] = rec
                self._failed.pop(rec["item"], None)
            elif rec.get("status") == "failed":
                self._failed[rec["item"]] = rec.get("error", "")

    def is_done(self, item: str) -> bool:
        return item in self._done

    def pending(self, items: list[str]) -> list[str]:
        return [i for i in items if i not in self._done]

    def mark_done(self, item: str, **extra: Any) -> None:
        self._append({"config": self.config_hash, "item": item, "status": "done", **extra})
        self._done[item] = extra
        # an item that failed in a PRIOR run and succeeds on resume is
        # done, not failed (matching how _load replays the journal)
        self._failed.pop(item, None)

    def mark_failed(self, item: str, error: str) -> None:
        self._append(
            {"config": self.config_hash, "item": item, "status": "failed", "error": error}
        )
        self._failed[item] = error

    def _append(self, rec: dict) -> None:
        with self._lock:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")
                f.flush()
                os.fsync(f.fileno())

    @property
    def done_count(self) -> int:
        return len(self._done)

    @property
    def failures(self) -> dict[str, str]:
        return dict(self._failed)
