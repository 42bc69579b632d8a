"""The port stands alone: every module of ``repro_torch``, and the
module-level code of ``chip_smoke.py``, imports in a process where
``jax`` and the reference package ``repro`` cannot be imported; and
``chip_smoke.py`` refuses to run without a CUDA device or outside a
checkout."""
import ast
import os
import pathlib
import shutil
import subprocess
import sys

from _subproc import REPO, child_env

PORT = pathlib.Path(REPO) / "src" / "repro_torch"
SMOKE = pathlib.Path(REPO) / "chip_smoke.py"

_CHILD = r"""
import importlib, importlib.util, pkgutil, sys
sys.modules["jax"] = None          # any "import jax" now raises
sys.modules["repro"] = None        # and so does any "import repro..."
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
spec.loader.exec_module(importlib.util.module_from_spec(spec))
leaked = sorted(n for n in sys.modules
                if n.split(".")[0] in ("jax", "jaxlib", "repro")
                and sys.modules[n] is not None)
print(len(names), leaked)
"""


def test_port_imports_without_jax_or_reference():
    out = subprocess.run([sys.executable, "-c", _CHILD, str(SMOKE)],
                         env=child_env(), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    n, leaked = out.stdout.split(maxsplit=1)
    assert int(n) >= 18 and leaked.strip() == "[]", out.stdout


def test_no_source_names_jax_or_the_reference():
    """Static check over every port source and chip_smoke.py: no import
    of ``jax``/``jaxlib`` or of the reference package ``repro``."""
    files = sorted(PORT.rglob("*.py")) + [SMOKE]
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for mod in mods:
                top = mod.split(".")[0]
                assert top not in ("jax", "jaxlib", "repro"), \
                    f"{path}:{node.lineno} imports {mod}"


def test_chip_smoke_refuses_without_cuda_or_checkout(tmp_path):
    """Here (no CUDA device) the script exits non-zero and prints no
    result line; copied alone into an empty directory it does too."""
    import torch
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(SMOKE, alone)
    runs = [alone] if torch.cuda.is_available() else [alone, SMOKE]
    for script in runs:
        out = subprocess.run([sys.executable, str(script)],
                             cwd=os.path.dirname(script), env=child_env(),
                             capture_output=True, text=True, timeout=300)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
