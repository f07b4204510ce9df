"""The import guard: the reference loads nothing of either codec package,
and a run loads neither JAX nor the JAX package."""

import json
import subprocess
import sys

from uhdrbench import harness


def test_reference_sources_import_no_codec():
    names = harness.reference_imports()
    assert names <= {"__future__", "math", "re", "struct", "fractions",
                     "numpy", "torch"}, names


def test_reference_loads_no_codec_package():
    code = ("import json, sys; import uhdrbench.reference.codec; "
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, check=True).stdout
    loaded = set(json.loads(out))
    assert not loaded & {"libultrahdr_tpu_torch", "libultrahdr_tpu", "jax",
                         "jaxlib", "flax"}


def test_a_run_loads_no_jax():
    code = ("import uhdrbench.harness as h; p = h.Port('cpu'); "
            "import libultrahdr_tpu_torch.tools.benchmarks; "
            "print(h.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, check=True).stdout
    assert out.strip() == "[]"


def test_forbidden_names_are_whole_top_level_names():
    sys.modules.setdefault("libultrahdr_tpu_torch_probe", sys)
    try:
        assert "libultrahdr_tpu_torch_probe" not in str(
            harness.forbidden_modules())
    finally:
        del sys.modules["libultrahdr_tpu_torch_probe"]
