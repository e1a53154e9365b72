"""The check that nothing a run loads is JAX or the JAX package, and that
the reference imports nothing of the port.  Names are compared by their
top-level part, whole: the port `srslte_tpu_torch` begins with the JAX
package's name `srslte_tpu` and is not it."""

from __future__ import annotations

import ast
import sys
from pathlib import Path

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "srslte_tpu"})
PROGRAM = "srslte_tpu_torch"


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden_loaded(modules=None) -> list:
    """The top-level names among `modules` (default: sys.modules) that are
    JAX, jaxlib, flax or the JAX package."""
    names = sys.modules if modules is None else modules
    return sorted({top_level(m) for m in names} & FORBIDDEN)


def imported_names(folder: Path) -> dict:
    """{file: top-level names it imports} over the Python files under
    `folder` (relative imports excluded)."""
    out = {}
    for f in sorted(folder.rglob("*.py")):
        names = set()
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            if isinstance(node, ast.Import):
                names |= {top_level(a.name) for a in node.names}
            elif isinstance(node, ast.ImportFrom) and not node.level and node.module:
                names.add(top_level(node.module))
        out[f] = names
    return out


def reference_violations(folder: Path) -> dict:
    """{file: names} of the reference's files that import JAX, the JAX
    package or the port."""
    bad = FORBIDDEN | {PROGRAM}
    return {f: sorted(n & bad) for f, n in imported_names(folder).items() if n & bad}
