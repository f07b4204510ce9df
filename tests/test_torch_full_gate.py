"""PyTorch port: ``libultrahdr_tpu_torch/tools/full_gate.py``, the
counterpart of the JAX repository's segmented gate, on tiny test files.

- The counts come from pytest's final summary line only: a failing
  assertion that quotes "99 passed" adds nothing.
- A segment that dies on a signal is run once more: green when the second
  run passes, red when it dies again; a failing test is not re-run.
- The gate is green only when every segment is, and its default marker
  expression is the tier-1 one.
"""

import io
import subprocess
import sys

from libultrahdr_tpu_torch.tools import full_gate

QUOTES = '''
def test_quotes_a_count():
    assert "99 passed, 7 failed" == "1 passed"


def test_passes():
    pass
'''

# dies on SIGKILL the first time it runs (a flag file marks the first run)
DIES_ONCE = '''
import os, pathlib, signal

FLAG = pathlib.Path(__file__).with_suffix(".ran")


def test_dies_the_first_time():
    if not FLAG.exists():
        FLAG.write_text("1")
        os.kill(os.getpid(), signal.SIGKILL)


def test_other():
    pass
'''

DIES_ALWAYS = '''
import os, signal


def test_dies():
    os.kill(os.getpid(), signal.SIGKILL)
'''


def _gate(tmp_path, **files):
    paths = []
    for name, text in files.items():
        f = tmp_path / f"test_{name}.py"
        f.write_text(text)
        paths.append(str(f))
    log = io.StringIO()
    green, total = full_gate.gate(paths, ["-m", full_gate.TIER1_MARKERS],
                                  log, cwd=tmp_path)
    return green, total, log.getvalue()


def test_counts_come_from_the_summary_line(tmp_path):
    green, total, log = _gate(tmp_path, quotes=QUOTES)
    assert not green
    assert total["passed"] == 1 and total["failed"] == 1
    assert "99 passed" in log           # the quote is in the output
    assert full_gate._counts(log.split("\n", 1)[1])["passed"] == 1


def test_counts_of_summary_lines():
    assert full_gate._counts(
        "x\n= 12 passed, 1 skipped, 2 deselected in 3.20s =\n") == dict(
            passed=12, failed=0, skipped=1, xfailed=0, xpassed=0, errors=0,
            deselected=2)
    assert full_gate._counts("1 failed, 3 passed, 1 error in 0.50s") \
        == dict(passed=3, failed=1, skipped=0, xfailed=0, xpassed=0,
                errors=1, deselected=0)
    assert full_gate._counts("7 passed in 61.02s (0:01:01)")["passed"] == 7
    assert full_gate._counts("assert '99 passed' == x\nno tests ran in "
                             "0.01s")["passed"] == 0


def test_a_segment_killed_by_a_signal_runs_once_more(tmp_path):
    green, total, log = _gate(tmp_path, once=DIES_ONCE)
    assert green
    assert total["passed"] == 2
    assert "[CRASH]" in log and "run once more" in log


def test_a_segment_that_dies_again_is_red(tmp_path):
    green, _, log = _gate(tmp_path, always=DIES_ALWAYS, quotes=QUOTES)
    assert not green
    assert log.count("[CRASH]") == 2    # the retry, and only for the crash
    assert log.count("[ FAIL]") == 1
    assert "failing: " in log


def test_main_runs_a_green_file(tmp_path):
    f = tmp_path / "test_green.py"
    f.write_text("def test_a():\n    pass\n")
    log = tmp_path / "gate.log"
    r = subprocess.run([sys.executable, full_gate.__file__, "--log",
                        str(log), "--files", str(f)], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "full_gate GREEN: 1 passed" in r.stdout
    assert "-m 'not slow'" in log.read_text()
