"""The tpulint rule engine for the torch port: AST visitors, findings,
pragmas, baseline.

Design notes:

- **Device-region index.**  Most rules only fire INSIDE code whose
  every host round trip stalls the card: a host sync in plain host code
  is just numpy.  The JAX package's engine seeds that set from
  ``@jax.jit`` and friends; eager torch has no decorator that marks its
  per-wave code, so this index is seeded by

  (a) torch's own traced or captured wrappers: functions decorated
      with or passed to ``torch.compile``, ``torch.jit.script`` /
      ``trace``, ``torch.func.vmap`` or
      ``torch.cuda.make_graphed_callables`` (through
      ``functools.partial`` too), the branch / body functions of
      ``torch.cond`` / ``while_loop`` / ``scan``, and the body of a
      ``with torch.cuda.graph(...)`` block;
  (b) the def-line pragma ``# tpulint: device-region``, trailing a line
      of a function's signature or on a comment line directly above the
      def (and its decorators): the eager port's stand-in for
      ``@jax.jit`` on the functions whose JAX counterparts are traced
      (a comment, so it costs nothing at run time);

  plus a same-module transitive closure over simple-name calls (a
  helper called from a device region runs in it too).  The closure is
  name-based and module-local, as in the JAX engine.
- **Pragmas.**  ``# tpulint: disable=<rule>[,<rule>...]`` trailing a
  code line suppresses those rules on that line; the same pragma on a
  comment-only line suppresses them for the whole file.  Anything
  after the rule list (``-- reason``) is the human justification the
  review policy requires.  ``disable=all`` suppresses every rule.
  ``# tpulint: x32-module`` on a comment-only line tags the file as an
  f32 kernel module for the dtype-discipline rule.  The grammar and
  the rule ids are the JAX package's, so a pragma reads the same in
  both packages.
- **Baseline.**  ``analysis/baseline.json`` holds a multiset of (file,
  rule, stripped-source-line) keys: known findings matched by CONTENT,
  not line number, so unrelated edits do not resurrect them, while
  genuinely new findings always gate.  ``python -m
  explicit_hybrid_mpc_tpu_torch.analysis --update-baseline`` rewrites
  it from the current findings.

The module is pure ``ast`` + stdlib (no torch/numpy): see the package
docstring.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
import re
from collections import Counter
from typing import Iterable, Iterator, Optional

BASELINE_VERSION = 1

SEVERITIES = ("error", "warn")

#: Trailing segments of the name chains of torch's traced or captured
#: wrappers: the FIRST argument (or the decorated function) runs as a
#: compiled, scripted, vectorized or graph-captured body.  Matched on
#: the chain's tail so that ``re.compile`` or an obs ``trace`` span
#: never seeds a region.
_TRACE_WRAPPERS = (("torch", "compile"), ("jit", "script"),
                   ("jit", "trace"), ("vmap",),
                   ("make_graphed_callables",))
#: torch's control-flow operators -> indices of their traced function
#: args (``torch.cond(pred, true_fn, false_fn, operands)``, the
#: ``torch._higher_order_ops`` loops); only under a ``torch`` root.
_BODY_WRAPPERS = {"cond": (1, 2), "while_loop": (0, 1), "scan": (0,)}
#: Context managers whose body is captured into a CUDA graph.
_CAPTURE_BLOCKS = (("cuda", "graph"), ("graphs", "graph"))

_PRAGMA = re.compile(
    r"#\s*tpulint:\s*(disable|x32-module|device-region)\b\s*(?:=\s*(.*))?")


def _pragma_rules(raw: Optional[str]) -> set[str]:
    """Rule ids from a pragma value, tolerating a trailing freeform
    justification after each id (``disable=silent-except -- why``)."""
    out = set()
    for tok in (raw or "").split(","):
        tok = tok.strip()
        if tok:
            out.add(tok.split()[0])
    return out


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation, anchored to file:line:col.

    ``code`` is the stripped source line -- the content-addressed key
    the baseline matches on (line numbers churn; code lines rarely do
    without the finding itself changing)."""

    rule: str
    severity: str
    path: str
    line: int
    col: int
    msg: str
    code: str

    @property
    def key(self) -> tuple[str, str, str]:
        return (self.path, self.rule, self.code)

    def render(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: "
                f"[{self.rule}] {self.severity}: {self.msg}")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class Rule:
    """Base class for lint rules.

    Subclasses set ``name`` / ``severity`` / ``doc`` and implement
    ``check(ctx)`` yielding findings; ``finding(ctx, node, msg)`` fills
    in the location + source-line plumbing."""

    name: str = "abstract"
    severity: str = "warn"
    doc: str = ""

    def check(self, ctx: "ModuleContext") -> Iterator[Finding]:
        raise NotImplementedError

    def finding(self, ctx: "ModuleContext", node: ast.AST, msg: str,
                severity: Optional[str] = None) -> Finding:
        line = getattr(node, "lineno", 1)
        col = getattr(node, "col_offset", 0)
        code = (ctx.lines[line - 1].strip()
                if 0 < line <= len(ctx.lines) else "")
        return Finding(rule=self.name, severity=severity or self.severity,
                       path=ctx.rel, line=line, col=col, msg=msg,
                       code=code)


def _attr_chain(node: ast.AST) -> list[str]:
    """['torch', 'cuda', 'synchronize'] for torch.cuda.synchronize; []
    when the expression is not a plain name/attribute chain."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return parts[::-1]
    return []


def _call_name(node: ast.AST) -> str:
    """Last segment of a call target's name chain ('' if unnameable)."""
    chain = _attr_chain(node)
    return chain[-1] if chain else ""


def _chain_ends(chain: list[str], tails) -> bool:
    """True when `chain` ends with one of the name tuples in `tails`."""
    return any(tuple(chain[-len(t):]) == t for t in tails
               if len(chain) >= len(t))


def _is_trace_wrapper(node: ast.AST) -> bool:
    return _chain_ends(_attr_chain(node), _TRACE_WRAPPERS)


def _unwrap_partial(node: ast.AST) -> ast.AST:
    """functools.partial(f, ...) -> f (compile(partial(fn, ...)) runs
    fn)."""
    if isinstance(node, ast.Call) and _call_name(node.func) == "partial" \
            and node.args:
        return node.args[0]
    return node


def _pragma_lines(fn: ast.AST, lines: list[str]) -> set[int]:
    """The lines a def's region pragma may stand on: the comment-only
    lines directly above it (and its decorators), and its signature --
    the def line up to the line before its first body statement."""
    top = min([d.lineno for d in fn.decorator_list] + [fn.lineno])
    out = set(range(fn.lineno, max(fn.body[0].lineno - 1, fn.lineno) + 1))
    ln = top - 1
    while ln >= 1 and lines[ln - 1].strip().startswith("#"):
        out.add(ln)
        ln -= 1
    return out


class _DeviceIndex:
    """The per-module set of nodes (functions, lambdas, capture blocks)
    whose code runs as a device region (see the module docstring for
    what is and is not covered)."""

    def __init__(self, tree: ast.Module, lines: list[str],
                 region_lines: set[int]):
        self.marked: set[ast.AST] = set()
        # Every def in the module by simple name (scope-insensitive on
        # purpose: marking one extra same-named helper costs a lint
        # false positive at worst, missing one hides a real host sync).
        self._defs: dict[str, list[ast.AST]] = {}
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._defs.setdefault(node.name, []).append(node)
        self._seed(tree, lines, region_lines)
        self._close()

    def _mark_expr(self, node: ast.AST) -> None:
        node = _unwrap_partial(node)
        if isinstance(node, ast.Lambda):
            self.marked.add(node)
        elif isinstance(node, ast.Name):
            for d in self._defs.get(node.id, ()):
                self.marked.add(d)

    def _seed(self, tree: ast.Module, lines: list[str],
              region_lines: set[int]) -> None:
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if region_lines.intersection(_pragma_lines(node, lines)):
                    self.marked.add(node)
                for dec in node.decorator_list:
                    target = _unwrap_partial(dec.func) if isinstance(
                        dec, ast.Call) else dec
                    if _is_trace_wrapper(target):
                        self.marked.add(node)
                    elif isinstance(dec, ast.Call) \
                            and _call_name(dec.func) == "partial" \
                            and dec.args \
                            and _is_trace_wrapper(dec.args[0]):
                        # @functools.partial(torch.compile, mode=...)
                        self.marked.add(node)
            elif isinstance(node, ast.Call):
                chain = _attr_chain(node.func)
                if _is_trace_wrapper(node.func) and node.args:
                    self._mark_expr(node.args[0])
                elif chain and chain[0] == "torch" \
                        and chain[-1] in _BODY_WRAPPERS:
                    for i in _BODY_WRAPPERS[chain[-1]]:
                        if i < len(node.args):
                            self._mark_expr(node.args[i])
            elif isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    ctx = item.context_expr
                    if isinstance(ctx, ast.Call) and _chain_ends(
                            _attr_chain(ctx.func), _CAPTURE_BLOCKS):
                        self.marked.add(node)

    def _close(self) -> None:
        """Fixpoint: helpers CALLED by simple name from a marked region
        run in it too."""
        changed = True
        while changed:
            changed = False
            for fn in list(self.marked):
                for node in ast.walk(fn):
                    if isinstance(node, ast.Call) \
                            and isinstance(node.func, ast.Name):
                        for d in self._defs.get(node.func.id, ()):
                            if d not in self.marked:
                                self.marked.add(d)
                                changed = True


class ModuleContext:
    """Everything rules need about one file, computed once: AST, parent
    links, the device-region index, pragma tables, and source lines."""

    def __init__(self, path: str, source: str, rel: Optional[str] = None):
        self.path = path
        self.rel = rel or path
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        self.parents: dict[ast.AST, ast.AST] = {}
        for parent in ast.walk(self.tree):
            for child in ast.iter_child_nodes(parent):
                self.parents[child] = parent
        self.line_disables: dict[int, set[str]] = {}
        self.file_disables: set[str] = set()
        self.region_lines: set[int] = set()
        self.x32_module = False
        self._scan_pragmas()
        self._index = _DeviceIndex(self.tree, self.lines,
                                   self.region_lines)
        self.region_nodes = self._index.marked

    def _scan_pragmas(self) -> None:
        for i, line in enumerate(self.lines, start=1):
            m = _PRAGMA.search(line)
            if not m:
                continue
            comment_only = line.strip().startswith("#")
            if m.group(1) == "device-region":
                self.region_lines.add(i)
                continue
            if m.group(1) == "x32-module":
                if comment_only:
                    self.x32_module = True
                continue
            rules = _pragma_rules(m.group(2))
            if comment_only:
                self.file_disables |= rules
            else:
                self.line_disables.setdefault(i, set()).update(rules)

    # -- queries rules use -------------------------------------------------

    def in_region(self, node: ast.AST) -> bool:
        """True when any enclosing scope (including `node` itself) is a
        device region."""
        cur: Optional[ast.AST] = node
        while cur is not None:
            if cur in self.region_nodes:
                return True
            cur = self.parents.get(cur)
        return False

    def region_functions(self) -> set[str]:
        """Names of the marked functions (lambdas and capture blocks
        have none)."""
        return {n.name for n in self.region_nodes
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}

    def enclosing_function(self, node: ast.AST) -> Optional[ast.AST]:
        cur = self.parents.get(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda)):
                return cur
            cur = self.parents.get(cur)
        return None

    def suppressed(self, f: Finding) -> bool:
        if {"all", f.rule} & self.file_disables:
            return True
        line_rules = self.line_disables.get(f.line, set())
        return bool({"all", f.rule} & line_rules)


# -- linting entry points --------------------------------------------------

def _default_rules() -> list[Rule]:
    from explicit_hybrid_mpc_tpu_torch.analysis.rules import all_rules

    return all_rules()


def lint_source(source: str, path: str, rules: Iterable[Rule] | None = None,
                rel: Optional[str] = None) -> list[Finding]:
    """Lint one source string; a syntax error becomes a single
    ``parse-error`` finding rather than an exception (the gate must
    report a broken file, not crash on it)."""
    rules = list(rules) if rules is not None else _default_rules()
    try:
        ctx = ModuleContext(path, source, rel=rel)
    except SyntaxError as e:
        return [Finding(rule="parse-error", severity="error",
                        path=rel or path, line=e.lineno or 1,
                        col=e.offset or 0, msg=f"cannot parse: {e.msg}",
                        code="")]
    out: list[Finding] = []
    for rule in rules:
        for f in rule.check(ctx):
            if not ctx.suppressed(f):
                out.append(f)
    out.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return out


def lint_paths(paths: Iterable[str], rules: Iterable[Rule] | None = None,
               root: Optional[str] = None) -> list[Finding]:
    """Lint files and/or directory trees (``*.py``); finding paths are
    recorded relative to ``root`` (default: cwd) so baseline keys stay
    stable across checkouts."""
    rules = list(rules) if rules is not None else _default_rules()
    root = os.path.abspath(root or os.getcwd())
    files: list[str] = []
    for p in paths:
        if os.path.isdir(p):
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = sorted(d for d in dirnames
                                     if not d.startswith((".", "__pycache")))
                files.extend(os.path.join(dirpath, f)
                             for f in sorted(filenames)
                             if f.endswith(".py"))
        else:
            files.append(p)
    out: list[Finding] = []
    for fp in files:
        with open(fp, encoding="utf-8") as fh:
            src = fh.read()
        rel = os.path.relpath(os.path.abspath(fp), root)
        out.extend(lint_source(src, fp, rules, rel=rel))
    out.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return out


# -- baseline --------------------------------------------------------------

def baseline_payload(findings: Iterable[Finding]) -> dict:
    """The serializable baseline: a sorted multiset of finding keys."""
    counts = Counter(f.key for f in findings)
    rows = [{"file": k[0], "rule": k[1], "code": k[2], "count": n}
            for k, n in sorted(counts.items())]
    return {"version": BASELINE_VERSION, "tool": "tpulint",
            "findings": rows}


def load_baseline(path: str) -> Counter:
    """Baseline file -> Counter of (file, rule, code) keys.  A missing
    file is an empty baseline (everything gates)."""
    if not os.path.exists(path):
        return Counter()
    with open(path, encoding="utf-8") as fh:
        data = json.load(fh)
    if data.get("version") != BASELINE_VERSION:
        raise ValueError(
            f"baseline {path} has version {data.get('version')!r}; this "
            f"engine writes v{BASELINE_VERSION} -- regenerate it with "
            "python -m explicit_hybrid_mpc_tpu_torch.analysis "
            "--update-baseline")
    out: Counter = Counter()
    for row in data.get("findings", []):
        out[(row["file"], row["rule"], row["code"])] += int(
            row.get("count", 1))
    return out


def split_baselined(findings: Iterable[Finding], baseline: Counter
                    ) -> tuple[list[Finding], list[Finding]]:
    """(new, baselined): each baseline entry absolves at most `count`
    matching findings -- a key's N+1'th occurrence is NEW and gates."""
    budget = Counter(baseline)
    new: list[Finding] = []
    old: list[Finding] = []
    for f in findings:
        if budget[f.key] > 0:
            budget[f.key] -= 1
            old.append(f)
        else:
            new.append(f)
    return new, old
