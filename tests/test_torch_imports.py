"""The port imports and runs with ``jax`` blocked (the gst_lj slice, the
location-sensitive decode, the WaveRNN vocoder, and the training-corpus path:
a pattern run and a loader batch in both transports), and no file of the port
(nor chip_smoke.py) imports jax or the JAX package."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "gst_tacotron_tpu_torch"


def _sources():
    # _build/ holds what the kernels' build writes, not sources of the port
    return sorted(p for p in PORT.rglob("*.py")
                  if "_build" not in p.relative_to(PORT).parts) + [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_jax_package_import(path):
    roots = set(_imported_roots(path))
    for banned in ("jax", "jaxlib", "flax", "optax", "orbax", "gst_tacotron_tpu"):
        assert banned not in roots, f"{path} imports {banned}"


def test_port_imports_and_runs_with_jax_blocked():
    code = (
        "import sys, importlib, pkgutil\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['flax'] = None\n"
        "import torch; torch.set_num_threads(1)\n"
        "import gst_tacotron_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, 'gst_tacotron_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from gst_tacotron_tpu_torch.config import load_config\n"
        "from gst_tacotron_tpu_torch.weights import build_model\n"
        "from gst_tacotron_tpu_torch.synthesize import Synthesizer\n"
        f"cfg = load_config({str(ROOT / 'tests/fixtures/golden/config.json')!r})\n"
        "s = Synthesizer(cfg, build_model(cfg, seed=0, device='cpu'), device='cpu')\n"
        "out = s(['blocked jax.'], max_steps=3)\n"
        "assert out['mel'].shape == (1, 6, 80), out['mel'].shape\n"
        "from gst_tacotron_tpu_torch.config import apply_overrides\n"
        "from gst_tacotron_tpu_torch.vocoder import WaveRNNVocoder\n"
        "from gst_tacotron_tpu_torch.weights import build_wavernn\n"
        "lsa = apply_overrides(cfg, {'model.attention.kind': 'location_sensitive'})\n"
        "out = Synthesizer(lsa, build_model(lsa, seed=0, device='cpu'), device='cpu')(\n"
        "    ['blocked jax.'], max_steps=3)\n"
        "assert out['alignments'].shape[1] == 3, out['alignments'].shape\n"
        "voc = apply_overrides(cfg, {'model.vocoder.wavernn_hop': 128,\n"
        "    'model.vocoder.wavernn_gru_dim': 8, 'model.vocoder.wavernn_fc_dim': 8})\n"
        "v = WaveRNNVocoder(voc, build_wavernn(voc, seed=0, device='cpu'), device='cpu')\n"
        "out = Synthesizer(voc, build_model(voc, seed=0, device='cpu'), device='cpu',\n"
        "                  vocoder=v)(['blocked jax.'], max_steps=2)\n"
        "assert out['wav'].shape == (1, 4 * 128), out['wav'].shape\n"
        "import tempfile\n"
        "from gst_tacotron_tpu_torch.data import (BucketedLoader, PatternDataset,\n"
        "    generate_patterns, synthetic_utterances)\n"
        "from gst_tacotron_tpu_torch.train import _materialize_features\n"
        "d = tempfile.mkdtemp()\n"
        "meta = generate_patterns(synthetic_utterances(3), cfg.audio, d, store_wav=True,\n"
        "                         device_features=True, device='cpu')\n"
        "assert len(meta['entries']) == 3\n"
        "data = apply_overrides(cfg, {'data.batch_size': 2, 'data.buckets': [[128, 1024]]})\n"
        "fb = next(iter(BucketedLoader(PatternDataset(d), data.data, 2).epoch(0)))\n"
        "assert fb['mel'].shape == (2, 1024, 80), fb['mel'].shape\n"
        "wd = apply_overrides(data, {'data.wav_transport': True})\n"
        "wb = next(iter(BucketedLoader(PatternDataset(d), wd.data, 2,\n"
        "                              audio_cfg=wd.audio).epoch(0)))\n"
        "mat = _materialize_features(wd, {k: torch.from_numpy(v) for k, v in wb.items()})\n"
        "assert mat['mel'].shape == (2, 1024, 80), mat['mel'].shape\n"
        "assert 'gst_tacotron_tpu' not in sys.modules\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")
