"""The port's repo lint (``repro_torch.analysis.lint``): the port's tree is
clean, each rule fires on a minimal violating fixture (and stays quiet on
the corrected form), and scope/allowlist/waiver mechanics behave.

Mirrors ``tests/test_lint.py`` and ``tests/test_obs.py::TestLintObsClock``
test for test.  RP005 reads the port's launch shapes (a tile size divided
by with ``//``, ``ceil`` or ``cdiv`` in a ``kernels/`` module that imports
the nvcc builder) where the reference reads Pallas ``BlockSpec``s.
"""
import subprocess
import sys
import textwrap
from pathlib import Path

from repro_torch.analysis.lint import RULES, lint_file, lint_paths, main

SRC = Path(__file__).resolve().parent.parent / "src"
PORT = SRC / "repro_torch"


def _write(tmp_path, rel, body):
    p = tmp_path / rel
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(textwrap.dedent(body))
    return p


def _rules_of(errors):
    return sorted({e.rule for e in errors})


# ---------------------------------------------------------------------------
# the real tree
# ---------------------------------------------------------------------------

def test_port_tree_is_clean():
    errors = lint_paths([PORT])
    assert errors == [], "\n".join(str(e) for e in errors)


def test_rule_table_is_complete():
    assert set(RULES) == {f"RP00{i}" for i in range(1, 7)}
    assert len(set(RULES.values())) == len(RULES)


# ---------------------------------------------------------------------------
# per-rule fixtures: bad fires, good is quiet
# ---------------------------------------------------------------------------

def test_rp001_unseeded_random(tmp_path):
    bad = _write(tmp_path, "core/sim.py", """
        import numpy as np
        def draw():
            return np.random.uniform(0, 1)
    """)
    assert _rules_of(lint_file(bad)) == ["RP001"]
    bad2 = _write(tmp_path, "core/sim2.py", """
        import numpy as np
        def draw():
            return np.random.default_rng().uniform(0, 1)
    """)
    assert _rules_of(lint_file(bad2)) == ["RP001"]
    good = _write(tmp_path, "core/sim3.py", """
        import numpy as np
        def draw(seed):
            return np.random.default_rng(seed).uniform(0, 1)
    """)
    assert lint_file(good) == []


def test_rp002_wallclock(tmp_path):
    bad = _write(tmp_path, "fleet/traces.py", """
        import time
        def now():
            return time.time()
    """)
    assert _rules_of(lint_file(bad)) == ["RP002"]
    assert "repro_torch.obs.clock.now()" in lint_file(bad)[0].message
    # the good form reads the sanctioned clock (the reference's fixture
    # here, time.perf_counter(), is flagged by its own obs-clock rule)
    good = _write(tmp_path, "fleet/traces2.py", """
        from repro_torch.obs.clock import now
        def tick():
            return now()
    """)
    assert lint_file(good) == []


def test_rp003_hash_seed(tmp_path):
    bad = _write(tmp_path, "util/keys.py", """
        def seed_of(name):
            return hash(name) % 2**32
    """)
    assert _rules_of(lint_file(bad)) == ["RP003"]
    good = _write(tmp_path, "util/keys2.py", """
        import zlib
        def seed_of(name):
            return zlib.crc32(name.encode())
    """)
    assert lint_file(good) == []


def test_rp004_bare_assert_in_core(tmp_path):
    bad = _write(tmp_path, "core/flow.py", """
        def check(n, cap):
            assert n <= cap
    """)
    assert _rules_of(lint_file(bad)) == ["RP004"]
    # the same assert OUTSIDE core/ is fine
    ok = _write(tmp_path, "kernels/flow.py", """
        def check(n, cap):
            assert n <= cap
    """)
    assert lint_file(ok) == []
    good = _write(tmp_path, "core/flow2.py", """
        def check(n, cap):
            if n > cap:
                raise RuntimeError(f"cap violated: {n} > {cap}")
    """)
    assert lint_file(good) == []


def test_rp005_tile_division(tmp_path):
    bad = _write(tmp_path, "kernels/attn.py", """
        import torch
        from . import build
        def fwd(q, block_q):
            S = q.shape[1]
            lse = torch.empty(q.shape[0], S // block_q * block_q)
            return build.function("fwd")(q, lse, S // block_q)
    """)
    errors = lint_file(bad)
    assert _rules_of(errors) == ["RP005"] and len(errors) == 2
    # ceil-division and cdiv keep the tail but size a launch all the same
    ceil = _write(tmp_path, "kernels/attn_ceil.py", """
        import math
        from . import build
        def grid(S, T, chunk, BLOCK_N):
            return -(-S // chunk), math.ceil(T / chunk), cdiv(S, BLOCK_N)
    """)
    assert len(lint_file(ceil)) == 3
    good = _write(tmp_path, "kernels/attn2.py", """
        import torch
        from . import build
        def fwd(q, block_q):
            S = q.shape[1]
            if S % block_q:
                raise ValueError(f"{S} not divisible by {block_q}")
            return build.function("fwd")(q, S // block_q)
    """)
    assert lint_file(good) == []
    # the check in the module's validator that the wrapper hands the name to
    handed = _write(tmp_path, "kernels/ssd.py", """
        from . import build
        def _check(x, *, chunk):
            if x.shape[1] % chunk:
                raise ValueError("T must be a multiple of chunk")
        def fwd(x, chunk):
            _check(x, chunk=chunk)
            return x.new_empty(x.shape[1] // chunk)
        def fwd_positional(x, tile_chunk):
            _check(x, tile_chunk)
            return x.new_empty(x.shape[1] // tile_chunk)
    """)
    assert lint_file(handed) == []
    # full-dimension names (not block_*/chunk*) tile trivially: no finding
    triv = _write(tmp_path, "kernels/attn3.py", """
        from . import build
        def fwd(H, hd):
            return H // hd
    """)
    assert lint_file(triv) == []


def test_rp006_statedict_version(tmp_path):
    bad = _write(tmp_path, "runtime/ckpt.py", """
        class Thing:
            def state_dict(self):
                return {"weights": self.w}
    """)
    assert _rules_of(lint_file(bad)) == ["RP006"]
    good = _write(tmp_path, "runtime/ckpt2.py", """
        class Thing:
            def state_dict(self):
                return {"version_tag": 3, "weights": self.w}
    """)
    assert lint_file(good) == []


# ---------------------------------------------------------------------------
# scope, allowlist, waiver
# ---------------------------------------------------------------------------

def test_hot_path_rules_exempt_data_and_launch(tmp_path):
    for seg in ("data", "launch"):
        f = _write(tmp_path, f"{seg}/loader.py", """
            import time
            import numpy as np
            def jitter():
                return np.random.uniform() + time.time()
        """)
        assert lint_file(f) == [], seg
    # ...but the identical code in core/ fires both hot-path rules
    f = _write(tmp_path, "core/loader.py", """
        import time
        import numpy as np
        def jitter():
            return np.random.uniform() + time.time()
    """)
    assert _rules_of(lint_file(f)) == ["RP001", "RP002"]


def test_rp005_reads_only_launching_kernel_modules(tmp_path):
    """A plain version (no builder import) and a module outside kernels/
    launch nothing: their tile divisions are not read."""
    body = """
        from . import build
        def scan(x, chunk):
            return [x[c] for c in range(x.shape[0] // chunk)]
    """
    assert _rules_of(lint_file(_write(tmp_path, "kernels/k.py", body))) \
        == ["RP005"]
    assert lint_file(_write(tmp_path, "models/k.py", body)) == []
    plain = _write(tmp_path, "kernels/ref.py", """
        def scan(x, chunk):
            return [x[c] for c in range(x.shape[0] // chunk)]
    """)
    assert lint_file(plain) == []


def test_waiver_comment_suppresses_one_line(tmp_path):
    f = _write(tmp_path, "core/sim.py", """
        import numpy as np
        def draw():
            a = np.random.uniform()  # lint: allow-unseeded-random
            b = np.random.uniform()
            return a + b
    """)
    errors = lint_file(f)
    assert len(errors) == 1 and errors[0].rule == "RP001"
    assert errors[0].line == 5


def test_syntax_error_reported_not_raised(tmp_path):
    f = _write(tmp_path, "core/broken.py", "def nope(:\n")
    errors = lint_file(f)
    assert len(errors) == 1 and errors[0].rule == "RP000"


def test_error_format_is_clickable(tmp_path):
    f = _write(tmp_path, "core/sim.py", """
        import numpy as np
        def draw():
            return np.random.uniform()
    """)
    msg = str(lint_file(f)[0])
    assert msg.startswith(f"{f}:4: RP001[unseeded-random] ")


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def test_main_exit_codes(tmp_path, capsys):
    clean = _write(tmp_path, "ok/mod.py", "X = 1\n")
    assert main([str(clean)]) == 0
    bad = _write(tmp_path, "core/bad.py", "def f():\n    assert True\n")
    assert main([str(bad)]) == 1
    assert main([]) == 2                     # usage
    capsys.readouterr()


def test_cli_subprocess_on_port_tree():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.lint", str(PORT)],
        capture_output=True, text=True,
        env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stdout + out.stderr
    assert "clean" in out.stderr


# ---------------------------------------------------------------------------
# RP002 and the obs clock (tests/test_obs.py::TestLintObsClock)
# ---------------------------------------------------------------------------

class TestLintObsClock:
    def _lint(self, tmp_path, source, name="core/hot.py"):
        p = tmp_path / name
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(source)
        return lint_file(p)

    def test_perf_counter_flagged_in_hot_path(self, tmp_path):
        errs = self._lint(tmp_path,
                          "import time\nt = time.perf_counter()\n")
        assert any(e.rule == "RP002" and "obs clock" in e.message
                   and "repro_torch.obs.clock.now()" in e.message
                   for e in errs)

    def test_monotonic_flagged(self, tmp_path):
        errs = self._lint(tmp_path, "import time\nt = time.monotonic()\n")
        assert any(e.rule == "RP002" for e in errs)

    def test_waiver_by_rule_id(self, tmp_path):
        errs = self._lint(
            tmp_path,
            "import time\n"
            "t = time.perf_counter()  # lint: allow-rp002\n")
        assert not any(e.rule == "RP002" for e in errs)

    def test_waiver_by_rule_name(self, tmp_path):
        errs = self._lint(
            tmp_path,
            "import time\n"
            "t = time.perf_counter()  # lint: allow-wallclock\n")
        assert not any(e.rule == "RP002" for e in errs)

    def test_obs_clock_itself_clean(self, tmp_path):
        # the sanctioned read is not in a hot segment and stays unflagged
        errs = self._lint(tmp_path,
                          "import time\nnow = time.perf_counter\n",
                          name="obs/clock.py")
        assert not errs

    def test_repo_is_lint_clean(self):
        import repro_torch
        assert lint_paths([list(repro_torch.__path__)[0]]) == []
