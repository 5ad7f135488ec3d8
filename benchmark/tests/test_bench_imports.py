"""Nothing the harness runs imports JAX, jaxlib, flax or the JAX package
(top-level names compared whole: the port's name begins with the JAX
package's), and the reference imports nothing of the port."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

from benchmark import common

_BLOCK = """
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".", 1)[0] in {blocked!r}:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
"""


def _run(code: str, blocked) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-c", _BLOCK.format(blocked=set(blocked)) + code],
                          cwd=common.ROOT, env=env, capture_output=True, text=True, timeout=300)


def test_the_harness_imports_no_jax():
    drivers = [p.stem for p in (common.HERE / "drivers").glob("*.py") if p.stem != "__init__"]
    code = (
        "import importlib, glob, os\n"
        "import benchmark.run, benchmark.control, benchmark.trace, benchmark.work\n"
        "import benchmark.weights, benchmark.reference.judge\n"
        f"for d in {drivers!r}: importlib.import_module('benchmark.drivers.' + d)\n"
        "for t in glob.glob('benchmark/traffic/*.py'):\n"
        "    importlib.import_module('benchmark.traffic.' + os.path.basename(t)[:-3])\n"
        "for m in glob.glob('benchmark/metrics/*.py'): benchmark.run.load_metric(os.path.basename(m)[:-3])\n"
        "import gst_tacotron_tpu_torch.synthesize, gst_tacotron_tpu_torch.vocoder\n"
        "import gst_tacotron_tpu_torch.ops, gst_tacotron_tpu_torch.train\n"
        "from benchmark import common\n"
        "bad = common.forbidden_modules()\n"
        "assert not bad, bad\n"
        "assert 'gst_tacotron_tpu_torch' in sys.modules\n")
    out = _run(code, common.FORBIDDEN)
    assert out.returncode == 0, out.stderr


def test_the_reference_imports_nothing_of_the_port():
    code = ("import benchmark.reference.judge, benchmark.reference.tacotron\n"
            "import benchmark.reference.dsp, benchmark.reference.wavernn\n"
            "import benchmark.reference.philox\n")
    out = _run(code, common.FORBIDDEN + ("gst_tacotron_tpu_torch",))
    assert out.returncode == 0, out.stderr
    for path in (common.HERE / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".", 1)[0] not in common.FORBIDDEN + ("gst_tacotron_tpu_torch",
                                                                    "benchmark"), (path, n)
