"""The train step as a CUDA graph (``train.StepGraphs``) and what it reads
from the device in place of host values.

On the CPU (no graph there): the Philox draw keyed by two device scalars
(``ops.philox.DeviceSeed``) gives the int key's bits; Adam's moments, now
updated in place, keep the bits of the expressions that rebound them; the
step body fed a ``DeviceSeed`` and the update's scalars from a buffer gives
the eager step's bits; and ``train_step`` on the CPU captures nothing.

On the card (marked ``cuda``; this file imports no JAX, so it runs on the
GPU machine with ``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_train_graph.py -q``): ``train_step``, which captures at a
shape's second step and replays from then on, against the eager step body
on a twin state, four steps, in every bit of the losses, parameters,
BatchNorm buffers, Adam's state and ``.grad``; the dropout masks move from
step to step; a second padded shape captures a graph of its own.
"""

import numpy as np
import pytest
import torch

from gst_tacotron_tpu_torch.config import apply_overrides, load_config
from gst_tacotron_tpu_torch.ops import philox
from gst_tacotron_tpu_torch.ops.decode import prenet_keep
from gst_tacotron_tpu_torch.train import (OptState, Optimizer, _step_body, dropout_seed,
                                          init_state, make_optimizer, train_step)
from gst_tacotron_tpu_torch.utils import profiling

torch.set_num_threads(2)

GOLDEN = "tests/fixtures/golden/config.json"
# 64-bit seeds: small, past 2^32, a low word of all ones (``+ 1`` carries
# into the high word) and the largest (``+ 1`` wraps to 0)
SEEDS = [0, 7, 2 ** 32 + 5, (3 << 32) | 0xFFFFFFFF, 2 ** 64 - 1]


def make_batch(rng, num_freq, b=2, t_text=12, t_mel=16):
    """A seeded feature batch; no token twice in a row (a tie in the
    encoder's maxpool)."""
    tl = np.array([t_text] + [int(x) for x in rng.integers(3, t_text, b - 1)])
    ml = np.array([t_mel] + [2 * int(x) for x in rng.integers(2, t_mel // 2, b - 1)])
    steps = rng.integers(1, 39, (b, t_text))
    tokens = 1 + (rng.integers(0, 39, (b, 1)) + np.cumsum(steps, 1)) % 39
    fmask = (np.arange(t_mel)[None] < ml[:, None])[..., None]
    return {"tokens": (tokens * (np.arange(t_text)[None] < tl[:, None])).astype(np.int32),
            "token_lengths": tl.astype(np.int32),
            "mel": (rng.uniform(0, 1, (b, t_mel, 80)) * fmask).astype(np.float32),
            "mel_lengths": ml.astype(np.int32),
            "linear": (rng.uniform(0, 1, (b, t_mel, num_freq)) * fmask).astype(np.float32),
            "speaker_ids": np.zeros(b, np.int32)}


def device_seed(seed: int, device="cpu") -> philox.DeviceSeed:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    words = torch.tensor(philox.seed_key(seed), dtype=torch.int64, device=device)
    return philox.DeviceSeed(words, gen)


@pytest.mark.parametrize("seed", SEEDS)
def test_philox_tensor_key_gives_the_int_keys_bits(seed):
    g = torch.Generator().manual_seed(seed % 1000)
    ctr = [torch.randint(0, 2 ** 32, (3, 5), generator=g, dtype=torch.int64)
           for _ in range(4)]
    words = torch.tensor(philox.seed_key(seed), dtype=torch.int64)
    for got, want in zip(philox.philox4x32_10(ctr, (words[0], words[1])),
                         philox.philox4x32_10(ctr, philox.seed_key(seed))):
        assert torch.equal(got, want)
    dev = device_seed(seed)
    steps = torch.arange(3, 9)
    for n in (0, 1):
        mine = philox.stream_uniforms(dev + n if n else dev, steps, 1, 4, 13, row0=2)
        theirs = philox.stream_uniforms((seed + n) % 2 ** 64, steps, 1, 4, 13, row0=2)
        assert torch.equal(mine, theirs)
    for a, b in zip(prenet_keep(dev + 1, 5, 3, 32, 16, 0.5, "cpu", step0=2),
                    prenet_keep((seed + 1) % 2 ** 64, 5, 3, 32, 16, 0.5, "cpu", step0=2)):
        assert torch.equal(a, b)


def _rebinding_update(tx: Optimizer, params, grads, state: OptState):
    """``Optimizer.update`` as it was before the moments were updated in
    place: new moment tensors, rebound into the state."""
    c = tx.cfg
    norm = torch.sqrt(sum((t * t).sum() for t in grads.values()))
    keep = norm < c.grad_clip_norm
    count = state.count + 1
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)
    bc1, bc2 = 1 - f32(c.beta1) ** count, 1 - f32(c.beta2) ** count
    lr = tx.schedule(state.count)
    for k, p in params.items():
        g = torch.where(keep, grads[k], (grads[k] / norm) * c.grad_clip_norm)
        mu = (1 - c.beta1) * g + c.beta1 * state.mu[k]
        nu = (1 - c.beta2) * (g * g) + c.beta2 * state.nu[k]
        state.mu[k], state.nu[k] = mu, nu
        u = (mu / bc1) / (torch.sqrt(nu / bc2) + c.eps)
        if c.weight_decay > 0:
            u = u + c.weight_decay * p
        p.add_(-(lr * u))
    state.count = count
    return norm


@pytest.mark.parametrize("overrides", [{}, {"optimizer.weight_decay": 1e-2,
                                            "optimizer.schedule": "exponential",
                                            "optimizer.decay_steps": 2,
                                            "optimizer.grad_clip_norm": 0.5}],
                         ids=["noam", "decay_clip"])
def test_in_place_moments_keep_the_rebinding_bits(overrides):
    cfg = apply_overrides(load_config(GOLDEN), overrides)
    tx = make_optimizer(cfg.optimizer)
    g = torch.Generator().manual_seed(3)
    shapes = {"a": (7, 5), "b": (5,), "c": (3, 4, 2)}
    params = {k: torch.randn(s, generator=g) for k, s in shapes.items()}
    theirs_params = {k: p.clone() for k, p in params.items()}
    mine, theirs = tx.init(params), tx.init(theirs_params)
    moments = {k: (mine.mu[k], mine.nu[k]) for k in shapes}
    for _ in range(3):
        grads = {k: torch.randn(s, generator=g) for k, s in shapes.items()}
        a = tx.update(params, grads, mine)
        b = _rebinding_update(tx, theirs_params, grads, theirs)
        assert torch.equal(a, b)
    assert mine.count == theirs.count == 3
    for k in shapes:
        assert mine.mu[k] is moments[k][0] and mine.nu[k] is moments[k][1]
        for x, y in ((params[k], theirs_params[k]), (mine.mu[k], theirs.mu[k]),
                     (mine.nu[k], theirs.nu[k])):
            assert torch.equal(x, y), k


def test_step_body_with_a_device_seed_and_buffered_scalars_gives_the_eager_bits():
    """What the graph is fed (the seed's words and a generator seeded with
    it, the update's scalars from a buffer) against the eager step, three
    steps, on the CPU."""
    cfg = load_config(GOLDEN)
    rng = np.random.default_rng(5)
    batches = [{k: torch.from_numpy(v) for k, v in make_batch(rng, cfg.model.num_freq).items()}
               for _ in range(3)]
    (_, eager), (_, fed) = init_state(cfg, "cpu"), init_state(cfg, "cpu")
    tx = make_optimizer(cfg.optimizer)
    for batch in batches:
        want = train_step(tx, cfg, eager, batch)
        buffer = torch.stack(tx.scalars(fed.opt.count))
        got = _step_body(tx, cfg, fed, batch,
                         device_seed(dropout_seed(fed.seed, fed.step)),
                         (buffer[0], buffer[1], buffer[2]))
        fed.step += 1
        for k in want:
            assert torch.equal(got[k], want[k]), k
    assert fed.opt.count == eager.opt.count == 3
    for (k, x), y in zip(fed.model.state_dict().items(), eager.model.state_dict().values()):
        assert torch.equal(x, y), k
    for k in fed.opt.mu:
        assert torch.equal(fed.opt.mu[k], eager.opt.mu[k]) and torch.equal(
            fed.opt.nu[k], eager.opt.nu[k]), k


def test_train_step_on_the_cpu_captures_nothing():
    cfg = load_config(GOLDEN)
    rng = np.random.default_rng(6)
    _, state = init_state(cfg, "cpu")
    tx = make_optimizer(cfg.optimizer)
    profiling.reset_counters()
    for _ in range(3):
        train_step(tx, cfg, state,
                   {k: torch.from_numpy(v) for k, v in make_batch(rng, cfg.model.num_freq).items()})
    counted = profiling.counters()
    assert counted["calls"] == 3 and state.step == 3 and state.graphs is None
    for name in ("train_graph_captures", "train_graph_replays", "train_graph_failures"):
        assert counted.get(name, 0) == 0


# --- on the card -------------------------------------------------------------


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _recording_masks(monkeypatch, seen):
    """Record each step's encoder-prenet dropout outputs and decoder-prenet
    keep masks (``seen[-1]``, refs to the tensors a step wrote: a graph's
    are its static ones, rewritten by each replay)."""
    from gst_tacotron_tpu_torch.models import modules
    from gst_tacotron_tpu_torch.ops import decode

    real_dropout, real_keep = modules.dropout, decode.prenet_keep

    def dropout(*args, **kwargs):
        out = real_dropout(*args, **kwargs)
        seen[-1].append(out)
        return out

    def keep(*args, **kwargs):
        out = real_keep(*args, **kwargs)
        seen[-1].extend(out)
        return out

    monkeypatch.setattr(modules, "dropout", dropout)
    monkeypatch.setattr(decode, "prenet_keep", keep)


@pytest.mark.cuda
def test_replayed_step_matches_the_eager_body_in_every_bit(dev, monkeypatch):
    cfg = load_config(GOLDEN)
    rng = np.random.default_rng(9)
    batches = [{k: torch.from_numpy(v).to(dev)
                for k, v in make_batch(rng, cfg.model.num_freq, b=4, t_mel=32).items()}
               for _ in range(4)]
    (_, eager), (_, graphed) = init_state(cfg, dev), init_state(cfg, dev)
    tx = make_optimizer(cfg.optimizer)
    seen = {"eager": [], "graph": []}
    masks = {"eager": [], "graph": []}
    profiling.reset_counters()
    for batch in batches:
        for name, run in (("eager", lambda b: _step_body(
                              tx, cfg, eager, b, dropout_seed(eager.seed, eager.step))),
                          ("graph", lambda b: train_step(tx, cfg, graphed, b))):
            with monkeypatch.context() as m:
                _recording_masks(m, seen[name])
                seen[name].append([])
                got = run(batch)
            if name == "eager":
                eager.step += 1
                want = got
            else:
                for k in want:
                    assert torch.equal(got[k], want[k]), k
            # a replay runs no Python: it rewrites the tensors its capture
            # recorded (step 2's), so copy them now
            wrote = seen[name][-1] or seen[name][1]
            masks[name].append([(t == 0 if t.dtype != torch.bool else t).clone() for t in wrote])
    torch.cuda.synchronize()
    counted = profiling.counters()
    assert counted.get("train_graph_captures") == 1
    assert counted.get("train_graph_replays") == 3
    assert counted.get("train_graph_failures", 0) == 0
    assert graphed.step == eager.step == 4 and graphed.opt.count == eager.opt.count == 4
    for k, x in graphed.model.state_dict().items():
        assert torch.equal(x, eager.model.state_dict()[k]), k
    for (k, p), q in zip(graphed.model.named_parameters(), eager.model.parameters()):
        assert torch.equal(p.grad, q.grad), k
        assert torch.equal(graphed.opt.mu[k], eager.opt.mu[k]), k
        assert torch.equal(graphed.opt.nu[k], eager.opt.nu[k]), k
    # the same masks on both paths, and no step's masks equal to the last's
    assert len(masks["graph"][0]) == len(masks["eager"][0]) >= 4
    for mine, theirs in zip(masks["graph"], masks["eager"]):
        for x, y in zip(mine, theirs):
            assert torch.equal(x, y)
    for prev, nxt in zip(masks["graph"], masks["graph"][1:]):
        for x, y in zip(prev, nxt):
            assert not torch.equal(x, y)

    # a second padded shape: eager, then a graph of its own
    other = [{k: torch.from_numpy(v).to(dev)
              for k, v in make_batch(rng, cfg.model.num_freq, b=4, t_mel=48).items()}
             for _ in range(2)]
    for batch in other:
        train_step(tx, cfg, graphed, batch)
    torch.cuda.synchronize()
    assert profiling.counters().get("train_graph_captures") == 2
    assert len(graphed.graphs.graphs) == 2
