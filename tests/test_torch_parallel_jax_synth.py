"""``parallel.DistributedSynthesizer`` of the port against the JAX
package's on the CPU: two gloo ranks of the port against JAX on a 2-device
mesh, at dp=2 and ``deterministic_prenet=True``, on the setup of
tests/test_torch_parallel_jax.py (small_cfg's gst_lj widths, prenet
dropout 0, the JAX init carried over), both paths (fixed length, and
chunked with the stop consensus at stop threshold 1.0): mel within 1e-4,
and the chunked path's ``chunks_run`` on both ranks the JAX one's.
"""

import numpy as np
import pytest
import torch

from gst_tacotron_tpu.parallel import DistributedSynthesizer as JDistributedSynthesizer

from tests.test_torch_parallel_jax import B, jax_setup
from tests.torch_dist_workers import run_ranks

torch.set_num_threads(2)

MEL_TOL = 1e-4


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    return jax_setup(tmp_path_factory)


def test_distributed_synthesizer_matches_jax(setup):
    jcfg, mesh = setup["jcfg"], setup["mesh"]
    rng = np.random.default_rng(1)
    ref_len = np.array([24, 16, 9, 20], np.int32)
    ref_mel = (rng.uniform(0, 1, (B, 24, 80))
               * (np.arange(24)[None] < ref_len[:, None])[..., None]).astype(np.float32)
    inputs = dict(tokens=setup["batch"]["tokens"], token_lengths=setup["batch"]["token_lengths"],
                  ref_mel=ref_mel, ref_mel_lengths=ref_len)
    calls = [dict(max_steps=6, deterministic_prenet=True),
             dict(max_steps=6, deterministic_prenet=True, chunked=True, chunk_steps=4)]
    variables = {"params": setup["state"].params, "batch_stats": setup["state"].batch_stats}
    jds = JDistributedSynthesizer(jcfg, setup["model"], variables, mesh)
    refs = [jds(**inputs, **kw) for kw in calls]
    port_in = {k: v.astype(np.int64) if v.dtype == np.int32 else v for k, v in inputs.items()}
    got = run_ranks("synthesize_inputs", 2, setup["cfg"], setup["flat"], port_in, calls)
    for rank_out in got:
        for kw, ref, out in zip(calls, refs, rank_out):
            assert out["mel"].shape == ref["mel"].shape, kw
            np.testing.assert_allclose(out["mel"], np.asarray(ref["mel"]), atol=MEL_TOL,
                                       rtol=0, err_msg=str(kw))
            if kw.get("chunked"):
                assert out["chunks_run"] == int(ref["chunks_run"]) == 2
