"""Source passes: AST-level checks on the port's hot-path modules (the
JAX package's ``repro.analysis_static.source_passes``, pointed at
``src/repro_torch``).

The always-on engine must survive ``python -O``: a bare ``assert`` on a
hot path is a guard that silently vanishes under optimized bytecode, so
every invariant on the beat/fold path must be a ``raise``.  This pass
parses the shipped hot-path modules and reports any ``assert`` whose
failure would change behaviour (asserts inside ``tests/`` and in
clearly-dead ``TYPE_CHECKING`` blocks are out of scope — this list is
the serving surface only).
"""
from __future__ import annotations

import ast
import os
from typing import List, Optional, Sequence

from repro_torch.analysis_static.diagnostics import LintFinding
from repro_torch.analysis_static import registry as R
from repro_torch.analysis_static.registry import register_pass

#: Modules that execute on the beat / fold / load path, relative to the
#: package root (``src/repro_torch``).
HOT_PATH_MODULES = (
    "core/plan.py",
    "core/lowering.py",
    "core/executor.py",
    "core/storage.py",
    "core/dataquery.py",
    "core/operators.py",
    "core/folding.py",
    "core/backends.py",
    "core/graphs.py",
    "kernels/__init__.py",
    "kernels/fused_delta.py",
    "kernels/clockscan.py",
    "kernels/partitioned_join.py",
    "kernels/bitmask_join.py",
    "kernels/shared_groupby.py",
    "kernels/flash_attention.py",
)


def package_root() -> str:
    """Directory holding the ``repro_torch`` package sources."""
    import repro_torch
    return os.path.dirname(os.path.abspath(repro_torch.__file__))


class _AssertVisitor(ast.NodeVisitor):
    def __init__(self):
        self.hits: List[ast.Assert] = []

    def visit_Assert(self, node: ast.Assert):
        self.hits.append(node)
        self.generic_visit(node)


def lint_source_text(text: str, relpath: str) -> List[LintFinding]:
    """Report each bare ``assert`` statement in one module's source."""
    try:
        tree = ast.parse(text, filename=relpath)
    except SyntaxError as e:
        return [LintFinding(
            R.NO_BARE_ASSERT,
            f"could not parse: {e}", location=relpath)]
    v = _AssertVisitor()
    v.visit(tree)
    out = []
    for node in v.hits:
        frag = ast.unparse(node.test) if hasattr(ast, "unparse") else ""
        out.append(LintFinding(
            R.NO_BARE_ASSERT,
            f"bare assert on a hot path (stripped under python -O) — "
            f"raise instead: assert {frag}",
            location=f"{relpath}:{node.lineno}"))
    return out


@register_pass("no-bare-assert", "source", (R.NO_BARE_ASSERT,),
               "hot-path modules must guard with raises, not asserts")
def lint_hot_path_asserts(modules: Optional[Sequence[str]] = None
                          ) -> List[LintFinding]:
    root = package_root()
    out = []
    for rel in (modules or HOT_PATH_MODULES):
        path = os.path.join(root, rel)
        if not os.path.exists(path):
            # a hot-path module that moved would be linted by nobody
            raise FileNotFoundError(f"hot-path module {path} is missing")
        with open(path, "r", encoding="utf-8") as f:
            out.extend(lint_source_text(f.read(), f"repro_torch/{rel}"))
    return out
