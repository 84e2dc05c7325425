"""Repo lint: stdlib-``ast`` rules for determinism and kernel hygiene.

Run ``python -m repro_torch.analysis.lint src/repro_torch`` (exit 0 =
clean, 1 = findings).  Pure stdlib on purpose — no torch import, so the
CI lane and editor hooks start in milliseconds.  The JAX package's lint
(``repro.analysis.lint``), rule for rule, but for RP005 (below).

Rules
-----
RP001  unseeded-random       no global/unseeded ``np.random.*`` in hot
                             paths (``core/``, ``fleet/``, ``runtime/``,
                             ``checkpoint/``, ``faults/``): every draw
                             must go through a seeded ``default_rng`` so
                             sim results replay bit-for-bit.  ``data/``
                             and ``launch/`` are exempt (allowlist).
RP002  wallclock             no direct ``time.*`` clock reads in hot
                             paths: ``time.time()``/``time_ns()`` because
                             simulated time is the only logic clock, and
                             ``perf_counter``/``monotonic`` (+ ``_ns``)
                             because instrumented intervals must come
                             from the ONE sanctioned wall clock,
                             ``repro_torch.obs.clock.now()`` — one clock
                             per time domain, so span/stats intervals
                             agree.
RP003  hash-seed             builtin ``hash()`` is salted per process
                             (PYTHONHASHSEED) and must never derive seeds
                             or keys; use ``zlib.crc32`` or a Generator.
RP004  bare-assert           no ``assert`` guarding runtime state in the
                             strict segments (``core/``, ``runtime/``,
                             ``checkpoint/``, ``faults/``) — asserts
                             vanish under ``-O`` (the executor's
                             ``_check_cap`` lesson); raise a typed error
                             with the violating state.
RP005  blockspec-div         in a ``kernels/`` module that launches
                             hand-written kernels (one that imports the
                             nvcc builder, ``kernels/build.py``), every
                             tile-size name (``block*``/``chunk*``) that a
                             function divides by — ``//`` (ceil-division
                             ``-(-n // block)`` included), ``ceil(n /
                             block)`` or ``cdiv(n, block)`` — must appear
                             in a ``%`` divisibility check in the same
                             function, or in a function of the same
                             module that it hands the name to (the
                             wrapper's ``_check``): buffers and a grid
                             sized ``T // chunk`` silently drop the ragged
                             tail otherwise.  The reference's rule reads
                             the tile names of a Pallas ``BlockSpec``;
                             the port has none, and its launch shapes are
                             these divisions.  The plain versions
                             (``kernels/ref.py``) and the autograd
                             bindings launch nothing and are not read.
RP006  statedict-version     every ``state_dict`` writer must emit an
                             explicit version key ("version"/
                             "version_tag"), or restored snapshots can't
                             be migrated.

A finding can be waived per line with ``# lint: allow-<rule-name>`` or
``# lint: allow-rp00N`` (the lowercase rule id).
"""
from __future__ import annotations

import ast
import sys
from dataclasses import dataclass
from pathlib import Path

__all__ = ["LintError", "RULES", "lint_file", "lint_paths", "main"]

#: path segments in scope for the hot-path rules (RP001/RP002)
HOT_SEGMENTS = ("core", "fleet", "runtime", "checkpoint", "faults",
                "memory")
#: path segments where bare asserts are banned outright (RP004): state
#: these modules guard must survive ``python -O``
STRICT_SEGMENTS = ("core", "runtime", "checkpoint", "faults")
#: path segments exempt from the hot-path rules even when nested oddly
EXEMPT_SEGMENTS = ("data", "launch", "configs", "tests")

#: legacy module-level numpy RNG entry points (global hidden state) plus
#: the argless ``default_rng()`` — both unreproducible
_NP_GLOBAL_RNG = frozenset({
    "rand", "randn", "randint", "random", "random_sample", "ranf",
    "sample", "choice", "shuffle", "permutation", "uniform", "normal",
    "standard_normal", "beta", "binomial", "exponential", "gamma",
    "poisson", "seed", "get_state", "set_state", "bytes",
})

#: names that denote a tile size (divisibility hazards); full-dimension
#: names (hd, N, P, ...) tile trivially and are ignored
_BLOCK_NAME_PREFIXES = ("block", "chunk")
#: the module a launching ``kernels/`` module imports (RP005's scope)
_BUILDER = "build"


@dataclass(frozen=True)
class LintError:
    path: str
    line: int
    rule: str          # "RP001"
    name: str          # "unseeded-random"
    message: str

    def __str__(self) -> str:
        return (f"{self.path}:{self.line}: {self.rule}[{self.name}] "
                f"{self.message}")


RULES = {
    "RP001": "unseeded-random",
    "RP002": "wallclock",
    "RP003": "hash-seed",
    "RP004": "bare-assert",
    "RP005": "blockspec-div",
    "RP006": "statedict-version",
}


def _segments(path: Path) -> tuple:
    return tuple(p.lower() for p in path.parts)


def _in_hot_path(path: Path) -> bool:
    segs = _segments(path)
    return any(s in segs for s in HOT_SEGMENTS) and \
        not any(s in segs for s in EXEMPT_SEGMENTS)


def _is_np_random_attr(node: ast.AST) -> str | None:
    """``np.random.X`` / ``numpy.random.X`` -> "X", else None."""
    if not (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Attribute)
            and node.value.attr == "random"
            and isinstance(node.value.value, ast.Name)
            and node.value.value.id in ("np", "numpy")):
        return None
    return node.attr


def _names_in(node: ast.AST):
    for n in ast.walk(node):
        if isinstance(n, ast.Name):
            yield n.id


class _Pass(ast.NodeVisitor):
    """One file's lint pass.  Tracks the innermost enclosing function so
    RP005/RP006 can attribute expressions to their kernel wrapper; RP005
    is decided in ``finish`` once every function of the file is known."""

    def __init__(self, path: Path, rel: str, lines: list[str],
                 launcher: bool = False):
        self.path = path
        self.rel = rel
        self.lines = lines
        self.hot = _in_hot_path(path)
        self.strict = any(s in _segments(path) for s in STRICT_SEGMENTS) \
            and not any(s in _segments(path) for s in EXEMPT_SEGMENTS)
        #: RP005's scope: a kernels/ module that launches (imports build)
        self.launcher = launcher
        self.errors: list[LintError] = []
        self._func_stack: list[dict] = []
        self._funcs: dict[str, dict] = {}     # name -> ctx, for RP005

    # -- helpers ---------------------------------------------------------
    def _waived(self, line: int, rule: str, rule_name: str) -> bool:
        if 1 <= line <= len(self.lines):
            text = self.lines[line - 1]
            return f"# lint: allow-{rule_name}" in text or \
                f"# lint: allow-{rule.lower()}" in text
        return False

    def _err(self, node: ast.AST, rule: str, message: str):
        name = RULES[rule]
        if not self._waived(node.lineno, rule, name):
            self.errors.append(LintError(self.rel, node.lineno, rule,
                                         name, message))

    # -- function context (RP005 / RP006) --------------------------------
    def visit_FunctionDef(self, node: ast.FunctionDef):
        self._visit_func(node)

    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef):
        self._visit_func(node)

    def _visit_func(self, node):
        a = node.args
        ctx = {"node": node, "divs": [], "mod_names": set(),
               "handoffs": [], "kwonly": {p.arg for p in a.kwonlyargs},
               "params": [p.arg for p in a.posonlyargs + a.args]}
        self._func_stack.append(ctx)
        self.generic_visit(node)
        self._func_stack.pop()
        self._funcs[node.name] = ctx
        # RP006: state_dict writers carry an explicit version key
        if node.name == "state_dict":
            consts = {n.value for n in ast.walk(node)
                      if isinstance(n, ast.Constant)
                      and isinstance(n.value, str)}
            if not any(c in ("version", "version_tag") for c in consts):
                self._err(node, "RP006",
                          "state_dict() emits no 'version'/'version_tag' "
                          "key; unversioned snapshots cannot be migrated "
                          "on load")

    # -- expression rules -------------------------------------------------
    def visit_BinOp(self, node: ast.BinOp):
        if isinstance(node.op, ast.Mod) and self._func_stack:
            for side in (node.left, node.right):
                self._func_stack[-1]["mod_names"].update(_names_in(side))
        if isinstance(node.op, ast.FloorDiv) and self.launcher and \
                self._func_stack:
            self._note_div(node, node.right)
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call):
        func = node.func
        # RP001 — unseeded / global-state numpy RNG in hot paths
        if self.hot:
            attr = _is_np_random_attr(func)
            if attr in _NP_GLOBAL_RNG:
                self._err(node, "RP001",
                          f"np.random.{attr}() uses the global RNG; draw "
                          "from a seeded np.random.default_rng(seed) "
                          "Generator instead")
            elif attr == "default_rng" and not node.args and \
                    not node.keywords:
                self._err(node, "RP001",
                          "np.random.default_rng() without a seed is "
                          "entropy-seeded; pass an explicit seed")
            # RP002 — wall clock in hot paths
            if isinstance(func, ast.Attribute) and \
                    isinstance(func.value, ast.Name) and \
                    func.value.id == "time":
                if func.attr in ("time", "time_ns"):
                    self._err(node, "RP002",
                              f"time.{func.attr}() in a hot path; "
                              "simulated runs must not read the wall "
                              "clock (use the sim clock; for wall "
                              "intervals use repro_torch.obs.clock.now())")
                elif func.attr in ("perf_counter", "perf_counter_ns",
                                   "monotonic", "monotonic_ns"):
                    self._err(node, "RP002",
                              f"time.{func.attr}() in an instrumented "
                              "hot path; read the obs clock "
                              "(repro_torch.obs.clock.now()) so spans "
                              "and "
                              "stats share one time domain")
        # RP003 — builtin hash() anywhere
        if isinstance(func, ast.Name) and func.id == "hash":
            self._err(node, "RP003",
                      "builtin hash() is salted per process "
                      "(PYTHONHASHSEED); use zlib.crc32 or a seeded "
                      "Generator for stable seeds/keys")
        # RP005 bookkeeping — tile sizes divided by, and the names a
        # function hands to another (a wrapper's _check)
        if self.launcher and self._func_stack:
            ctx = self._func_stack[-1]
            name = func.attr if isinstance(func, ast.Attribute) else \
                func.id if isinstance(func, ast.Name) else ""
            if name == "ceil":
                for arg in node.args:
                    for div in ast.walk(arg):
                        if isinstance(div, ast.BinOp) and \
                                isinstance(div.op, ast.Div):
                            self._note_div(node, div.right)
            elif name.endswith("cdiv") and len(node.args) == 2:
                self._note_div(node, node.args[1])
            if isinstance(func, ast.Name):
                passed = [(i, a.id) for i, a in enumerate(node.args)
                          if isinstance(a, ast.Name)]
                passed += [(k.arg, k.value.id) for k in node.keywords
                           if k.arg and isinstance(k.value, ast.Name)]
                ctx["handoffs"].append((func.id, passed))
        self.generic_visit(node)

    def _note_div(self, node: ast.AST, divisor: ast.AST):
        names = {n for n in _names_in(divisor)
                 if n.lower().startswith(_BLOCK_NAME_PREFIXES)}
        if names:
            self._func_stack[-1]["divs"].append((node, names))

    def finish(self):
        """RP005, once every function of the module is known: each tile
        name a function divides by needs a '%' test in that function or
        in a module function it hands the name to."""
        for ctx in self._funcs.values():
            checked = set(ctx["mod_names"])
            for callee, passed in ctx["handoffs"]:
                target = self._funcs.get(callee)
                if target is None:
                    continue
                for slot, arg in passed:
                    param = target["params"][slot] if isinstance(slot, int) \
                        and slot < len(target["params"]) else slot
                    if param in target["mod_names"]:
                        checked.add(arg)
            for node, names in ctx["divs"]:
                missing = sorted(names - checked)
                if missing:
                    self._err(node, "RP005",
                              f"tile size(s) {', '.join(missing)} divide a "
                              "launch shape with no divisibility check (no "
                              f"'%' test) in '{ctx['node'].name}' or a "
                              "function it hands them to; a buffer or grid "
                              "of n // block silently drops the ragged "
                              "tail")

    # -- statement rules --------------------------------------------------
    def visit_Assert(self, node: ast.Assert):
        if self.strict:
            self._err(node, "RP004",
                      "bare assert in a strict segment guards runtime "
                      "state but vanishes under python -O; raise a typed "
                      "error (ValueError/RuntimeError) with the state in "
                      "the message")
        self.generic_visit(node)


def _imports_builder(tree: ast.AST) -> bool:
    """True if the module imports the kernels' nvcc builder."""
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            if (node.module or "").split(".")[-1] == _BUILDER or \
                    any(a.name == _BUILDER for a in node.names):
                return True
        elif isinstance(node, ast.Import):
            if any(a.name.split(".")[-1] == _BUILDER for a in node.names):
                return True
    return False


def lint_file(path: Path) -> list[LintError]:
    try:
        src = path.read_text()
        tree = ast.parse(src, filename=str(path))
    except SyntaxError as e:
        return [LintError(str(path), e.lineno or 0, "RP000", "syntax",
                          f"could not parse: {e.msg}")]
    p = _Pass(path, str(path), src.splitlines(),
              launcher="kernels" in _segments(path) and
              _imports_builder(tree))
    p.visit(tree)
    p.finish()
    return sorted(p.errors, key=lambda e: (e.path, e.line, e.rule))


def lint_paths(paths) -> list[LintError]:
    errors: list[LintError] = []
    for p in paths:
        p = Path(p)
        files = sorted(p.rglob("*.py")) if p.is_dir() else [p]
        for f in files:
            errors.extend(lint_file(f))
    return errors


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or any(a in ("-h", "--help") for a in argv):
        print(__doc__)
        print("usage: python -m repro_torch.analysis.lint <path> [path ...]")
        return 0 if argv else 2
    errors = lint_paths(argv)
    for e in errors:
        print(e)
    n_files = sum(1 for p in argv for _ in
                  (Path(p).rglob("*.py") if Path(p).is_dir() else (p,)))
    status = f"{len(errors)} finding(s) in {n_files} file(s)" \
        if errors else f"clean ({n_files} file(s))"
    print(f"repro-torch-lint: {status}", file=sys.stderr)
    return 1 if errors else 0


if __name__ == "__main__":
    raise SystemExit(main())
