"""Docs lint: documented CLI flags and inter-doc links must be real.

    PYTHONPATH=src python -m repro_torch.analysis.docs_lint

The port's copy of ``repro.analysis.docs_lint`` (standard library only),
over the port's documentation: the README's section on the port and
that of the repository's verify notes (``skills/verify/SKILL.md`` in the
hidden tooling directory at the root), and the port's entry points.

Documentation rots in two characteristic ways: a flag gets renamed in
the parser but not in the README, or a doc file moves and the links
pointing at it dangle. Both are cheap to catch statically:

* every ``--flag`` that appears after a ``python -m <module>`` command
  in a code span, a fenced block or an indented code block (the port
  keeps commands with flags of its own there, where the JAX package's
  lint, which reads only backticks, does not look) is verified against
  that module's real
  argparse parser (each entry point exposes ``build_parser()`` for
  this check, so nothing runs);
* ``--flag`` tokens in inline code with no command context must exist
  in at least one registered parser (or the small foreign-tool
  allowlist — e.g. pytest's ``--durations``);
* markdown links to relative paths must resolve on disk, as must bare
  ``docs/*.md`` / top-level ``*.md`` mentions in code spans.

Exit code 1 on any violation.
"""
from __future__ import annotations

import argparse
import glob
import importlib
import os
import re
import sys

# Every CLI entry point of the port documented in its sections. The value
# is the attribute on the imported module that returns its argparse parser.
PARSER_FACTORIES = {
    "repro_torch.launch.train": "build_parser",
    "repro_torch.launch.serve": "build_parser",
    "repro_torch.launch.dryrun": "build_parser",
    "repro_torch.analysis.check": "build_parser",
    "repro_torch.analysis.docs_lint": "build_parser",
}

# Markdown files the lint walks (repo-root relative glob patterns), each
# from the heading that opens the port's section to the next heading of
# that level.
DOC_FILES = (
    ("README.md", "## PyTorch port"),
    (".*/skills/verify/SKILL.md", "## The PyTorch port"),
)

# Flags of tools that are not ours but appear in the port's docs: never
# an error.
FOREIGN_FLAGS = frozenset({
    "--durations",                               # pytest
    "--timeout",                                 # a runner's time limit
    "--format",                                  # nvidia-smi
    "--query-gpu",                               # nvidia-smi
})

_FENCE_RE = re.compile(r"```[^\n]*\n(.*?)```", re.S)
_INLINE_RE = re.compile(r"`([^`\n]+)`")
# an indented code block: lines of four spaces or more after a blank line
_INDENTED_RE = re.compile(r"(?<=\n\n)(?: {4}[^\n]*\n?)+")
_CMD_RE = re.compile(r"python\s+-m\s+([\w.]+)")
# a long option: not part of a word, not an `ENV=--value` assignment,
# not the tail of an em-dash run
_FLAG_RE = re.compile(r"(?<![\w=-])--[a-zA-Z][\w-]*")
_LINK_RE = re.compile(r"\[[^\]]*\]\(([^)\s]+)\)")
_DOC_MENTION_RE = re.compile(
    r"(?:docs/[\w.-]+\.md|(?:README|ROADMAP|CHANGES|PAPER)\.md)"
)


def parser_flags(module: str) -> frozenset:
    """All long-option strings of a registered entry point's parser."""
    mod = importlib.import_module(module)
    ap = getattr(mod, PARSER_FACTORIES[module])()
    return frozenset(
        opt for action in ap._actions for opt in action.option_strings
        if opt.startswith("--")
    )


def _code_regions(text: str):
    """Fenced block bodies, indented code blocks and inline code spans
    of a markdown file."""
    for m in _FENCE_RE.finditer(text):
        yield m.group(1)
    rest = _FENCE_RE.sub("", text)
    for m in _INDENTED_RE.finditer(rest):
        yield m.group(0)
    for m in _INLINE_RE.finditer(_INDENTED_RE.sub("", rest)):
        yield m.group(1)


def _flag_name(tok: str) -> str:
    return tok.split("=")[0]


def check_flags(doc: str, text: str, known: dict) -> list:
    """``(doc, detail)`` violations for flags in ``text``'s code
    regions. ``known`` maps module -> frozenset of its long options."""
    union = frozenset().union(*known.values()) | FOREIGN_FLAGS
    out = []
    for region in _code_regions(text):
        cmds = list(_CMD_RE.finditer(region))
        # flags before the first command have no module context
        bounds = [(None, 0, cmds[0].start() if cmds else len(region))]
        for i, c in enumerate(cmds):
            end = cmds[i + 1].start() if i + 1 < len(cmds) else len(region)
            bounds.append((c.group(1), c.end(), end))
        for mod, lo, hi in bounds:
            for tok in _FLAG_RE.findall(region[lo:hi]):
                flag = _flag_name(tok)
                if mod in known:
                    if flag not in known[mod] and flag not in FOREIGN_FLAGS:
                        out.append((doc, f"flag {flag} not accepted by "
                                         f"python -m {mod}"))
                elif flag not in union:
                    out.append((doc, f"flag {flag} matches no registered "
                                     "parser (see PARSER_FACTORIES)"))
    return out


def check_links(doc: str, text: str, root: str) -> list:
    """``(doc, detail)`` violations for dangling relative links and
    dangling ``*.md`` mentions in code spans."""
    out = []
    doc_dir = os.path.dirname(os.path.join(root, doc))
    for m in _LINK_RE.finditer(text):
        target = m.group(1).split("#")[0]
        if not target or "://" in target or target.startswith("mailto:"):
            continue
        if not (os.path.exists(os.path.join(doc_dir, target))
                or os.path.exists(os.path.join(root, target))):
            out.append((doc, f"dangling link target {m.group(1)!r}"))
    for region in _code_regions(text):
        for mention in _DOC_MENTION_RE.findall(region):
            if not os.path.exists(os.path.join(root, mention)):
                out.append((doc, f"dangling doc mention {mention!r}"))
    return out


def section(text: str, heading: str) -> str:
    """The part of ``text`` from the line starting with ``heading`` to the
    next heading of the same level, or '' when there is no such line."""
    level = heading.split(" ", 1)[0] + " "
    lines = text.splitlines(keepends=True)
    for i, line in enumerate(lines):
        if line.startswith(heading):
            end = next((j for j in range(i + 1, len(lines))
                        if lines[j].startswith(level)), len(lines))
            return "".join(lines[i:end])
    return ""


def doc_files(root: str = ".") -> list:
    """``(path relative to root, heading)`` of each file ``DOC_FILES``
    names, or ``(pattern, heading)`` where no file matches."""
    out = []
    for pattern, heading in DOC_FILES:
        found = sorted(glob.glob(os.path.join(root, pattern)))
        out += [(os.path.relpath(f, root), heading) for f in found] or [(pattern, heading)]
    return out


def run(root: str = ".") -> list:
    """Lint every doc's port section; returns the list of ``(doc,
    detail)`` violations."""
    known = {mod: parser_flags(mod) for mod in PARSER_FACTORIES}
    violations = []
    for doc, heading in doc_files(root):
        path = os.path.join(root, doc)
        if not os.path.exists(path):
            violations.append((doc, "documented file missing"))
            continue
        with open(path) as f:
            text = section(f.read(), heading)
        if not text:
            violations.append((doc, f"no section {heading!r}"))
            continue
        violations += check_flags(doc, text, known)
        violations += check_links(doc, text, root)
    return violations


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis.docs_lint")
    ap.add_argument("--root", default=".",
                    help="repo root the doc paths are relative to")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    violations = run(args.root)
    for doc, detail in violations:
        print(f"FAIL {doc}: {detail}", file=sys.stderr)
    n = len(DOC_FILES)
    if violations:
        print(f"docs-lint: {len(violations)} violations across {n} docs",
              file=sys.stderr)
        return 1
    print(f"docs-lint: OK ({n} docs, "
          f"{len(PARSER_FACTORIES)} parsers)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
