"""The shared plan's stages as the work needs them, from the
deployment's tables and templates alone (not from the program's
lowering): one scan per table that templates reference, one join per
(spine, fk column, PK table), one group-by per grouped template set.
Each stage lists the templates it serves; a stage's queries are the
slot capacities of those templates."""
from __future__ import annotations

from typing import Dict, List, Tuple


def scans(templates) -> Dict[str, List]:
    """table -> the templates that reference it (spine or join side)."""
    out: Dict[str, List] = {}
    for t in templates.values():
        for table in (t.spine,) + tuple(pk for _, pk in t.joins):
            if t not in out.setdefault(table, []):
                out[table].append(t)
    return out


def joins(templates) -> Dict[Tuple[str, str, str], List]:
    out: Dict[Tuple[str, str, str], List] = {}
    for t in templates.values():
        for fk, pk in t.joins:
            out.setdefault((t.spine, fk, pk), []).append(t)
    return out


def words(queries: int) -> int:
    return -(-queries // 32)
