"""Run the port's source-hazard linter over a tree and report findings.

The port of ``tools/lint.py``, over :mod:`fps_tpu_torch.analysis.lint`, the
AST layer of the program contract auditor. Rules FPS001-FPS011: late-bound
closures over loop variables, bool branches on tensor predicates, unsorted
dict iteration and host clocks inside compiled-fn builders, thread-starting
classes without a synchronisation primitive, internal imports of the
``utils.profiling`` shim, raw reads of checkpoint files, raw sockets,
hand-spelled tenant paths, whole-table copies in the serve hot path, and
blocking host work on the training thread (``--explain`` prints them).

``tests/test_torch_lint.py`` runs the linter over ``fps_tpu_torch/`` as a
tier-1 test expecting zero findings. Suppress a deliberate exception with
``# noqa: FPSNNN`` on the flagged line.

The linter module is loaded by file path, so neither torch nor jax is
imported. Run it by path:

  python fps_tpu_torch/examples/lint.py [PATHS...] [--json]
                                        [--select FPS002,FPS011] [--explain]
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def load_linter():
    """Load ``fps_tpu_torch/analysis/lint.py`` without importing the
    ``fps_tpu_torch`` package (whose ``__init__`` imports torch)."""
    path = os.path.join(_ROOT, "fps_tpu_torch", "analysis", "lint.py")
    spec = importlib.util.spec_from_file_location("_fps_torch_lint", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="fps_tpu_torch source-hazard linter "
                    "(fps_tpu_torch.analysis.lint)")
    ap.add_argument("paths", nargs="*",
                    default=[os.path.join(_ROOT, "fps_tpu_torch")],
                    help="files/directories to lint (default: the "
                         "fps_tpu_torch package)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="one JSON line: findings + rule table")
    ap.add_argument("--select", default=None,
                    help="comma-separated rule ids to enable "
                         "(default: all)")
    ap.add_argument("--explain", action="store_true",
                    help="print the rule table and exit")
    args = ap.parse_args(argv)

    lint = load_linter()
    if args.explain:
        for rule, why in sorted(lint.RULES.items()):
            print(f"{rule}: {why}")
        return 0
    select = frozenset(args.select.split(",")) if args.select else None
    findings = lint.lint_paths(args.paths, select=select)
    if args.as_json:
        print(json.dumps({
            "findings": [f.to_json() for f in findings],
            "count": len(findings),
            "rules": dict(sorted(lint.RULES.items())),
        }))
    else:
        for f in findings:
            print(f)
        print(f"{len(findings)} finding(s)", file=sys.stderr)
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
