"""The port imports and runs with ``jax`` and ``tensorflow`` blocked (the
gst_lj slice and its taco2 encoder, the
location-sensitive decode, the WaveRNN vocoder, the training-corpus path: a
pattern run and a loader batch in both transports, and the trainers: a
seq2seq step with its checkpoint and a vocoder step; the synthesis entry
points: the chunked decode, the bench's workload, the parity harness and
the synthesize CLI on the trainers' workdirs; the parallel subpackage: its
mesh, sharding rules and ``DistributedSynthesizer`` on a one-rank mesh; the
exported JAX workdir of tests/fixtures/jax_export, served and resumed; the
Keras importer's module and the trace server; the kernel microbenchmark's
quick CPU report), and no file of the port (nor a card test module)
imports jax or the JAX package."""

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
    # and the card test modules, which run where JAX is not installed
    return sorted(p for p in PORT.rglob("*.py")
                  if "_build" not in p.relative_to(PORT).parts) + [
        ROOT / "tests" / name for name in ("test_torch_cuda.py", "test_torch_card_paths.py",
                                           "test_torch_card_train.py")]


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
        "sys.modules['tensorflow'] = None\n"
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
        "one = apply_overrides(cfg, {'model.decoder.stop_threshold': 1.0})\n"
        "out = Synthesizer(one, build_model(one, seed=0, device='cpu'), device='cpu',\n"
        "                  use_chunked_decoder=True, chunk_steps=2)(['blocked jax.'], max_steps=3)\n"
        "assert out['chunks_run'] == 2 and out['alignments'].shape[1] == 4\n"
        "from gst_tacotron_tpu_torch import bench, parity\n"
        "assert bench.workload(2)[1]['tokens'].shape == (2, 64)\n"
        "pd = tempfile.mkdtemp()\n"
        "parity.save_fixture(pd + '/f.npz', 'blocked jax.', out['mel'][0])\n"
        "assert len(parity.run_parity(Synthesizer(one, build_model(one, seed=0, device='cpu'),\n"
        "    device='cpu'), pd)) == 1\n"
        "from gst_tacotron_tpu_torch.parallel import (DistributedSynthesizer,\n"
        "    describe_sharding, make_mesh, place_state, process_data_shard, shard_params,\n"
        "    state_shardings)\n"
        "assert process_data_shard(make_mesh(2, ranks=range(4)), 2) == (1, 2)\n"
        "m = build_model(cfg, seed=0, device='cpu')\n"
        "assert sum('model' in v for v in describe_sharding(dict(m.named_parameters()))\n"
        "           .values()) == 8\n"
        "ds = DistributedSynthesizer(cfg, m, make_mesh(1), device='cpu')\n"
        "assert ds.synthesize(['blocked jax.'], max_steps=2)['mel'].shape == (1, 4, 80)\n"
        "t2 = apply_overrides(cfg, {'model.encoder.kind': 'taco2'})\n"
        "out = Synthesizer(t2, build_model(t2, seed=0, device='cpu'), device='cpu')(\n"
        "    ['blocked jax.'], max_steps=3)\n"
        "assert out['mel'].shape == (1, 6, 80), out['mel'].shape\n"
        "from gst_tacotron_tpu_torch import tf_import\n"
        "from gst_tacotron_tpu_torch.utils.profiling import maybe_start_server\n"
        "assert maybe_start_server(None) is None\n"
        "from gst_tacotron_tpu_torch import kernel_bench\n"
        "kr = kernel_bench.run('cpu', steps=4, batch=2, quick=True)\n"
        "assert len(kr['sections']) == 7 and kr['failures'] == [], kr['sections']\n"
        "assert 'gst_tacotron_tpu' not in sys.modules and sys.modules['tensorflow'] is None\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


def test_port_trains_with_jax_blocked(tmp_path):
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['flax'] = None\n"
        "sys.modules['tensorflow'] = None\n"
        "sys.modules['optax'] = None\n"
        "import torch; torch.set_num_threads(1)\n"
        "from gst_tacotron_tpu_torch.config import apply_overrides, load_config\n"
        "from gst_tacotron_tpu_torch.data import generate_patterns, synthetic_utterances\n"
        "from gst_tacotron_tpu_torch.train import Trainer\n"
        "from gst_tacotron_tpu_torch.vocoder_train import VocoderTrainer\n"
        f"cfg = load_config({str(ROOT / 'tests/fixtures/golden/config.json')!r})\n"
        "cfg = apply_overrides(cfg, {'audio.hop_length': 256, 'data.batch_size': 2,\n"
        "    'data.buckets': [[64, 320]], 'data.val_fraction': 0.0,\n"
        "    'model.vocoder.wavernn_hop': 256, 'model.vocoder.wavernn_gru_dim': 8,\n"
        "    'model.vocoder.wavernn_fc_dim': 8})\n"
        f"d = {str(tmp_path)!r}\n"
        "generate_patterns(synthetic_utterances(3), cfg.audio, d + '/p', store_wav=True)\n"
        "t = Trainer(cfg, d + '/p', d + '/w', device='cpu')\n"
        "assert t.train(1).step == 1\n"
        "assert Trainer(cfg, d + '/p', d + '/w', device='cpu').restore_if_available()\n"
        "v = VocoderTrainer(cfg, d + '/p', d + '/v', device='cpu', segment_frames=4,\n"
        "                   batch_size=2)\n"
        "assert v.train(1).step == 1\n"
        "from gst_tacotron_tpu_torch.synthesize import main\n"
        "paths = main(['--workdir', d + '/w', '--out', d + '/o', '--device', 'cpu',\n"
        "    '--chunked-decoder', '--vocoder', 'wavernn', '--vocoder-workdir', d + '/v',\n"
        "    '--texts', 'blocked jax.'])\n"
        "assert paths[0].endswith('synth_000.wav'), paths\n"
        "import shutil\n"
        f"shutil.copytree({str(ROOT / 'tests/fixtures/jax_export')!r}, d + '/jx')\n"
        "main(['--workdir', d + '/jx', '--out', d + '/ox', '--device', 'cpu',\n"
        "      '--texts', 'blocked jax.'])\n"
        "jc = load_config(d + '/jx/config.json')\n"
        "generate_patterns(synthetic_utterances(3), jc.audio, d + '/jp')\n"
        "jt = Trainer(jc, d + '/jp', d + '/jx', device='cpu')\n"
        "assert jt.restore_if_available() and jt.state.step == 2\n"
        "assert jt.train(3).step == 3\n"
        "assert 'gst_tacotron_tpu' not in sys.modules and sys.modules['tensorflow'] is None\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")
