"""Knob-registry auditor of the port: every ``AF2TPU_*`` env read,
cross-checked.

Port of ``alphafold2_tpu/analysis/knobs.py`` (the same rules, pure standard
library), pointed at the port: the names read in ``alphafold2_tpu_torch/``
and ``chip_smoke.py`` against the README's "PyTorch/CUDA port" section and
the port's ``config.py``. A knob nobody documents is a knob nobody can
operate, and a documented knob nobody reads is a lie in the README:

- **AF2K001** (error) — a knob read in the port's code that the README's
  port section never mentions.
- **AF2K002** (error) — a knob the port section documents that no port code
  (the port's tests included) ever reads.
- **AF2K003** (warning) — a ``*Config`` dataclass field of the port's
  ``config.py`` whose name is never referenced outside it.
- **AF2K004** (warning) — a ``*Config`` field with no ``#`` comment
  (trailing, or a block comment directly above) and no README mention.

Enumeration is exact-match AST: any string constant fully matching
``AF2TPU_[A-Z0-9_]+`` (comments and longer docstrings never match), plus
the variable of each ``# af2: gated-defect[ENV]`` marker, which the
concurrency audit reads (``analysis/concurrency.py``). A
literal with a trailing underscore is a prefix wildcard that keeps every
README name sharing the prefix alive. Reads in the port's tests
(``tests/test_torch_*.py``) count for liveness but carry no documentation
duty. ``--markdown`` prints the registry tables. CLI::

    python -m alphafold2_tpu_torch.analysis.knobs [--json|--markdown|--list-rules]
"""

from __future__ import annotations

import argparse
import ast
import json
import os
import re
import sys
from typing import Dict, Iterable, List, Optional, Tuple

from alphafold2_tpu_torch.analysis.lint import Finding, iter_python_files

RULES = {
    "AF2K001": "env knob read in code but undocumented in README",
    "AF2K002": "env knob documented in README but never read anywhere",
    "AF2K003": "config dataclass field never referenced outside config.py",
    "AF2K004": "config field with no comment (trailing or block-above) "
               "and no README mention",
}

_SEVERITY = {
    "AF2K001": "error",
    "AF2K002": "error",
    "AF2K003": "warning",
    "AF2K004": "warning",
}

_KNOB_RE = re.compile(r"AF2TPU_[A-Z0-9_]+_?")
_GATED_RE = re.compile(r"#\s*af2:\s*gated-defect\[([A-Z0-9_]+)\]")
_REPO = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def default_code_paths() -> list:
    return [
        os.path.join(_REPO, "alphafold2_tpu_torch"),
        os.path.join(_REPO, "chip_smoke.py"),
    ]


def default_liveness_paths() -> list:
    # the port's tests read knobs too; that keeps a README knob alive but
    # carries no documentation duty
    tests = os.path.join(_REPO, "tests")
    try:
        names = sorted(os.listdir(tests))
    except OSError:
        names = []
    return default_code_paths() + [
        os.path.join(tests, n) for n in names
        if n.startswith("test_torch_") and n.endswith(".py")
    ]


# the README section that documents the port
README_SECTION = "## PyTorch/CUDA port"


def collect_env_reads(paths: Iterable[str]) -> Dict[str, List[str]]:
    """knob name -> sorted read sites ("relpath:line"). Names ending in
    ``_`` are prefix wildcards used to build families dynamically."""
    out: Dict[str, List[str]] = {}
    for path in iter_python_files(paths):
        if os.path.abspath(path) == os.path.abspath(__file__):
            continue  # _GROUPS labels are classifications, not reads
        try:
            source = open(path, encoding="utf-8").read()
            tree = ast.parse(source)
        except (OSError, SyntaxError):
            continue
        rel = os.path.relpath(path, _REPO)
        # a concurrency fixture's gate is a read too: the concurrency audit
        # reads the variable its `# af2: gated-defect[ENV]` marker names
        for i, line in enumerate(source.splitlines(), start=1):
            m = _GATED_RE.search(line)
            if m and _KNOB_RE.fullmatch(m.group(1)):
                out.setdefault(m.group(1), []).append(f"{rel}:{i}")
        for node in ast.walk(tree):
            if (
                isinstance(node, ast.Constant)
                and isinstance(node.value, str)
                and _KNOB_RE.fullmatch(node.value)
            ):
                out.setdefault(node.value, []).append(
                    f"{rel}:{node.lineno}"
                )
    return {k: sorted(set(v)) for k, v in out.items()}


def collect_documented(readme_path: Optional[str] = None) -> set:
    """Every ``AF2TPU_*`` name in the README's port section (from its
    heading to the next level-2 heading)."""
    path = readme_path or os.path.join(_REPO, "README.md")
    try:
        text = open(path, encoding="utf-8").read()
    except OSError:
        return set()
    start = text.find(README_SECTION + "\n")
    if start < 0:
        return set()
    end = text.find("\n## ", start + len(README_SECTION))
    section = text[start:end if end >= 0 else len(text)]
    return set(re.findall(r"AF2TPU_[A-Z0-9_]+", section))


def collect_config_fields(
    config_path: Optional[str] = None,
) -> List[Tuple[str, str, int, bool]]:
    """-> [(ClassName, field, line, has_trailing_comment)] for every
    ``*Config`` dataclass field in config.py."""
    path = config_path or os.path.join(_REPO, "alphafold2_tpu_torch", "config.py")
    source = open(path, encoding="utf-8").read()
    lines = source.splitlines()
    tree = ast.parse(source)
    out = []
    for node in ast.walk(tree):
        if not (isinstance(node, ast.ClassDef)
                and node.name.endswith("Config")):
            continue
        for item in node.body:
            if isinstance(item, ast.AnnAssign) and isinstance(
                item.target, ast.Name
            ):
                end = item.end_lineno or item.lineno
                commented = "#" in lines[end - 1] or (
                    item.lineno >= 2
                    and lines[item.lineno - 2].lstrip().startswith("#")
                )
                out.append(
                    (node.name, item.target.id, item.lineno, commented)
                )
    return out


def collect_referenced_names(
    paths: Iterable[str], exclude: str
) -> set:
    """Every attribute-access and keyword-argument name outside
    ``exclude`` — the (loose) liveness universe for config fields,
    collected in ONE pass so the per-field check is set membership."""
    names: set = set()
    for path in iter_python_files(paths):
        if os.path.abspath(path) == os.path.abspath(exclude):
            continue
        try:
            tree = ast.parse(open(path, encoding="utf-8").read())
        except (OSError, SyntaxError):
            continue
        for node in ast.walk(tree):
            if isinstance(node, ast.Attribute):
                names.add(node.attr)
            elif isinstance(node, ast.keyword) and node.arg:
                names.add(node.arg)
    return names


def audit(
    code_paths: Optional[Iterable[str]] = None,
    liveness_paths: Optional[Iterable[str]] = None,
    readme_path: Optional[str] = None,
    config_path: Optional[str] = None,
) -> List[Finding]:
    code_paths = list(code_paths or default_code_paths())
    liveness_paths = list(liveness_paths or default_liveness_paths())
    config_path = config_path or os.path.join(
        _REPO, "alphafold2_tpu_torch", "config.py"
    )
    reads = collect_env_reads(code_paths)
    live_reads = collect_env_reads(liveness_paths)
    documented = collect_documented(readme_path)
    prefixes = {k for k in live_reads if k.endswith("_")}
    findings: List[Finding] = []

    # AF2K001 — read but undocumented (prefix literals document their
    # whole family: the README must mention the prefix itself)
    for name, sites in sorted(reads.items()):
        key = name  # prefix literals must appear verbatim in README too
        if key not in documented:
            path, _, line = sites[0].rpartition(":")
            findings.append(Finding(
                "AF2K001", _SEVERITY["AF2K001"],
                os.path.join(_REPO, path), int(line), 0,
                f"env knob {name} is read here but the README's port "
                "section never mentions it — document it there (the "
                "tables: `python -m alphafold2_tpu_torch.analysis.knobs "
                "--markdown`)",
            ))

    # AF2K002 — documented but never read (a code prefix literal keeps
    # its README family alive)
    readme_file = readme_path or os.path.join(_REPO, "README.md")
    for name in sorted(documented):
        if name in live_reads or name + "_" in prefixes:
            continue
        if any(name.startswith(p) for p in prefixes):
            continue
        findings.append(Finding(
            "AF2K002", _SEVERITY["AF2K002"], readme_file, 0, 0,
            f"README's port section documents env knob {name} but no port "
            "code (incl. its tests) ever reads it — dead documentation",
        ))

    # AF2K003/004 — config-field surface
    referenced = collect_referenced_names(liveness_paths, config_path)
    for cls, field, line, commented in collect_config_fields(config_path):
        if field not in referenced:
            findings.append(Finding(
                "AF2K003", _SEVERITY["AF2K003"], config_path, line, 0,
                f"{cls}.{field} is never referenced outside config.py — "
                "a dead knob in the config surface",
            ))
        if not commented and field not in documented:
            findings.append(Finding(
                "AF2K004", _SEVERITY["AF2K004"], config_path, line, 0,
                f"{cls}.{field} has no `#` comment (trailing or "
                "block-above) and no README mention — undocumented "
                "config",
            ))
    return findings


# ---------------------------------------------------------------- markdown


_GROUPS = [
    ("AF2TPU_FLEET_", "fleet frontend"),
    ("AF2TPU_SERVE_", "serving fault hooks"),
    ("AF2TPU_KERNELS", "kernel selection"),
    ("AF2TPU_AUDIT_", "concurrency audit controls"),
    ("AF2TPU_LIVENESS_", "liveness watchdog"),
    ("AF2TPU_", "core / misc"),
]


def markdown_registry(reads: Optional[Dict[str, List[str]]] = None) -> str:
    """The knob registry tables of the README's port section, by family."""
    reads = reads if reads is not None else collect_env_reads(
        default_code_paths()
    )
    grouped: Dict[str, list] = {title: [] for _p, title in _GROUPS}
    for name in sorted(reads):
        for prefix, title in _GROUPS:
            if name.startswith(prefix):
                grouped[title].append(name)
                break
    lines: List[str] = []
    for _prefix, title in _GROUPS:
        names = grouped[title]
        if not names:
            continue
        lines.append(f"**{title}:**")
        lines.append("")
        lines.append("| knob | read at |")
        lines.append("|---|---|")
        for name in names:
            sites = reads[name]
            shown = ", ".join(f"`{s}`" for s in sites[:2])
            if len(sites) > 2:
                shown += f" (+{len(sites) - 2})"
            lines.append(f"| `{name}` | {shown} |")
        lines.append("")
    return "\n".join(lines)


# --------------------------------------------------------------------- CLI


def main(argv: Optional[list] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m alphafold2_tpu_torch.analysis.knobs",
        description=__doc__.splitlines()[0],
    )
    parser.add_argument("--json", action="store_true")
    parser.add_argument("--markdown", action="store_true",
                        help="emit the README Knob registry tables")
    parser.add_argument("--select", help="comma-separated rule ids")
    parser.add_argument("--list-rules", action="store_true")
    args = parser.parse_args(argv)

    if args.list_rules:
        for rule in sorted(RULES):
            print(f"{rule} [{_SEVERITY[rule]}] {RULES[rule]}")
        return 0
    if args.markdown:
        print(markdown_registry())
        return 0

    findings = audit()
    if args.select:
        wanted = {s.strip().upper() for s in args.select.split(",")}
        findings = [f for f in findings if f.rule in wanted]
    if args.json:
        print(json.dumps(
            {
                "tool": "af2_knobs",
                "findings": [f.to_dict() for f in findings],
                "counts": {
                    sev: sum(1 for f in findings if f.severity == sev)
                    for sev in ("error", "warning")
                },
            },
            indent=2,
        ))
    else:
        for f in findings:
            print(f.format())
        if not findings:
            reads = collect_env_reads(default_code_paths())
            print(f"knob audit clean ({len(reads)} env knobs, all "
                  "documented and live)")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
