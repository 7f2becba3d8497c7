"""The import check: neither JAX nor the JAX package may load.

A module's top-level name is the part of its name before the first dot,
compared whole: ``mies_tpu_torch`` is the port and allowed, ``mies_tpu``
is the JAX package and refused.
"""

from __future__ import annotations

import ast
import sys
from pathlib import Path

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "mies_tpu"})


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def loaded_forbidden(modules=None) -> list[str]:
    """The loaded modules (``sys.modules`` by default) whose top-level
    name is forbidden."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if top_level(n) in FORBIDDEN)


def imported_names(path: Path) -> set[str]:
    """Top-level names of every absolute import in one source file."""
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(top_level(a.name) for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(top_level(node.module))
    return names


def forbidden_in_sources(root: Path) -> dict[str, list[str]]:
    """Source file -> the forbidden top-level names it imports, for every
    ``*.py`` under ``root``."""
    found = {}
    for path in sorted(Path(root).rglob("*.py")):
        bad = sorted(imported_names(path) & FORBIDDEN)
        if bad:
            found[str(path)] = bad
    return found
