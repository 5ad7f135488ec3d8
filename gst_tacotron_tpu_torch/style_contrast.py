"""GST style control, quantified on a trained model (counterpart of
``tools/style_contrast.py``).

Synthesizes ONE text under several style conditions (one-hot token
weights, the uniform neutral weights, and a reference wav: a synthetic
utterance's audio) and reports how far apart their mels are, in two passes:

  * deterministic prenet (``Synthesizer(deterministic_prenet=True)``): the
    same condition under seeds 0 and 123 must give the same bits, so every
    nonzero pairwise mel L1 is style, not sampling noise;
  * stochastic (the production sampling mode): pairwise mel L1 against a
    noise floor, the mean over ``--floor-seeds`` seed pairs of the uniform
    condition.

Per condition it reports F0 (autocorrelation), RMS and spectral centroid of
the loudest half second (``acoustic_stats``, the JAX tool's numpy function,
copied) and the decoded frame length. The report has the JAX tool's keys.

    python -m gst_tacotron_tpu_torch.style_contrast --workdir W --out F \\
        [--text T] [--tokens 0,3,5,7] [--floor-seeds 4] [--device cpu]

``W`` is a workdir of the port's trainer or a JAX one exported by
``tools/export_jax_workdir.py`` (``config.json`` and ``checkpoints/``). On
the card every condition runs the encoder, post-net (K1) and decode (K4)
kernels, and the reference wav also K3, K2 and the reference GRU (K1);
without a card it raises unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

from .config import Config, load_config
from .device import resolve_device

DEFAULT_TEXT = "style tokens shape the voice of this sentence."


def load_trained(workdir: str, device=None) -> Tuple[Config, Any, int]:
    """(config, model with the latest checkpoint's weights on ``device``,
    its step) of a trainer workdir."""
    from .checkpoint import CheckpointManager
    from .weights import build_model

    cfg = load_config(os.path.join(workdir, "config.json"))
    dev = resolve_device(device)
    saved = CheckpointManager(os.path.join(workdir, cfg.train.checkpoint_dir)).restore(
        map_location=dev)
    model = build_model(cfg, seed=cfg.train.seed, device=dev)
    model.load_state_dict(saved["model"])
    return cfg, model, int(saved["step"])


def acoustic_stats(wav: np.ndarray, sr: int) -> dict:
    """F0 (autocorr over the loudest 0.5 s), RMS, spectral centroid."""
    wav = np.asarray(wav, np.float64)
    if len(wav) < sr // 10:
        return {"f0_hz": 0.0, "rms": 0.0, "centroid_hz": 0.0}
    # loudest 0.5 s window
    win = min(len(wav), sr // 2)
    e = np.convolve(wav ** 2, np.ones(win), "valid")
    s0 = int(np.argmax(e))
    seg = wav[s0: s0 + win]
    rms = float(np.sqrt(np.mean(seg ** 2)))
    # autocorrelation F0 in [60, 400] Hz
    ac = np.correlate(seg, seg, "full")[len(seg) - 1:]
    lo, hi = sr // 400, sr // 60
    f0 = float(sr / (lo + np.argmax(ac[lo:hi]))) if hi < len(ac) else 0.0
    # spectral centroid of the segment
    sp = np.abs(np.fft.rfft(seg))
    freqs = np.fft.rfftfreq(len(seg), 1.0 / sr)
    centroid = float((sp * freqs).sum() / max(sp.sum(), 1e-9))
    return {"f0_hz": round(f0, 1), "rms": round(rms, 5),
            "centroid_hz": round(centroid, 1)}


def style_conditions(cfg: Config, tokens: Sequence[int]) -> Dict[str, Dict[str, Any]]:
    """{name: Synthesizer keyword arguments}: ``token<t>`` one-hot weights
    for each of ``tokens``, ``uniform`` weights and ``ref_wav``, the fourth
    synthetic utterance's audio."""
    from .data.pattern import synthesize_wav, synthetic_utterances

    n_tok = cfg.model.gst.num_tokens
    conditions = {}
    for t in tokens:
        w = np.zeros((1, n_tok), np.float32)
        w[0, t] = 1.0
        conditions[f"token{t}"] = dict(token_weights=w)
    conditions["uniform"] = dict(token_weights=np.full((1, n_tok), 1.0 / n_tok, np.float32))
    ref_utt = synthetic_utterances(4, num_speakers=1)[3]
    conditions["ref_wav"] = dict(reference_wavs=[synthesize_wav(ref_utt, cfg.audio)])
    return conditions


def _mel_of(o: Dict[str, np.ndarray]) -> np.ndarray:
    return np.asarray(o["mel"][0][: int(o["frame_lengths"][0])])


def _mel_dist(a: np.ndarray, b: np.ndarray) -> float:
    t = min(a.shape[0], b.shape[0])
    return float(np.mean(np.abs(a[:t] - b[:t])))


def style_contrast(cfg: Config, model, *, text: str = DEFAULT_TEXT,
                   tokens: Sequence[int] = (0, 3, 5, 7), floor_seeds: int = 4,
                   device=None) -> Dict[str, Any]:
    """The report's passes, conditions and summary (the JAX tool's keys but
    ``workdir`` and ``step``) of ``model`` on ``device``."""
    from .synthesize import Synthesizer

    if not cfg.model.gst.enabled:
        raise ValueError("style contrast requires a GST config (model.gst.enabled)")
    synth_det = Synthesizer(cfg, model, device=device, deterministic_prenet=True)
    synth_sto = Synthesizer(cfg, model, device=device)
    conditions = style_conditions(cfg, tokens)

    # ---- deterministic pass (primary) --------------------------------------
    det = {}
    for name, kw in conditions.items():
        det[name] = synth_det([text], seed=0, **kw)
        print(f"[style/det] {name}: {int(det[name]['frame_lengths'][0])} frames")
    # same condition, another seed -> the same bits
    det_check = synth_det([text], seed=123, **conditions["uniform"])
    det_floor = _mel_dist(_mel_of(det["uniform"]), _mel_of(det_check))
    det_bitident = bool(np.array_equal(_mel_of(det["uniform"]), _mel_of(det_check)))

    style_names = [n for n in conditions if n != "uniform"] + ["uniform"]
    det_pairs = {}
    for a, b in itertools.combinations(style_names, 2):
        det_pairs[f"{a}|{b}"] = {
            "mel_l1": _mel_dist(_mel_of(det[a]), _mel_of(det[b])),
            "frame_delta": abs(int(det[a]["frame_lengths"][0])
                               - int(det[b]["frame_lengths"][0])),
        }
    sr = cfg.audio.sample_rate
    det_stats = {n: {**acoustic_stats(det[n]["wav"][0][: int(det[n]["wav_lengths"][0])], sr),
                     "frames": int(det[n]["frame_lengths"][0])}
                 for n in style_names}

    # ---- stochastic pass with an N-seed floor -------------------------------
    sto = {name: synth_sto([text], seed=0, **kw) for name, kw in conditions.items()}
    floor_vals = [_mel_dist(_mel_of(sto["uniform"]),
                            _mel_of(synth_sto([text], seed=1000 + s, **conditions["uniform"])))
                  for s in range(floor_seeds)]
    sto_floor = float(np.mean(floor_vals))
    sto_pairs = {f"{a}|{b}": _mel_dist(_mel_of(sto[a]), _mel_of(sto[b]))
                 for a, b in itertools.combinations(style_names, 2)}

    det_cross = [v["mel_l1"] for v in det_pairs.values()]
    sto_cross = list(sto_pairs.values())
    return {
        "text": text,
        "conditions": sorted(style_names),
        "deterministic_pass": {
            "pairwise": det_pairs,
            "acoustic_stats": det_stats,
            "seed_floor_mel_l1": det_floor,
            "seed_floor_bit_identical": det_bitident,
            "min_cross_condition_mel_l1": min(det_cross),
            "mean_cross_condition_mel_l1": float(np.mean(det_cross)),
        },
        "stochastic_pass": {
            "pairwise_mel_l1": sto_pairs,
            "seed_floor_mel_l1_mean_of": floor_seeds,
            "seed_floor_mel_l1": sto_floor,
            "seed_floor_values": floor_vals,
            "min_contrast_over_floor": min(sto_cross) / max(sto_floor, 1e-9),
            "mean_contrast_over_floor": float(np.mean(sto_cross)) / max(sto_floor, 1e-9),
        },
        "summary": {
            "verdict": (
                "with the prenet deterministic, the same condition under two seeds is {}: "
                "every nonzero pairwise mel L1 below is style, not sampling noise".format(
                    "bit-identical" if det_bitident else f"within {det_floor:.2e}")),
            "det_min_pair_mel_l1": min(det_cross),
            "det_mean_pair_mel_l1": float(np.mean(det_cross)),
            "sto_min_contrast_over_floor": min(sto_cross) / max(sto_floor, 1e-9),
            "frame_lengths": {n: int(det[n]["frame_lengths"][0]) for n in style_names},
        },
    }


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """The command line: writes the report to ``--out`` and returns it."""
    p = argparse.ArgumentParser(description="GST style contrast (PyTorch port)")
    p.add_argument("--workdir", required=True,
                   help="a training workdir of the port, or a JAX one exported by "
                        "tools/export_jax_workdir.py")
    p.add_argument("--out", required=True, help="the JSON report")
    p.add_argument("--text", default=DEFAULT_TEXT)
    p.add_argument("--tokens", default="0,3,5,7",
                   help="comma list of one-hot token indices to contrast")
    p.add_argument("--floor-seeds", type=int, default=4,
                   help="seed pairs for the stochastic-pass noise floor")
    p.add_argument("--device", default=None,
                   help="default cuda; 'cpu' runs the plain path on the CPU")
    args = p.parse_args(argv)

    cfg, model, step = load_trained(args.workdir, args.device)
    report = {"workdir": args.workdir, "step": step,
              **style_contrast(cfg, model, text=args.text,
                               tokens=[int(x) for x in args.tokens.split(",")],
                               floor_seeds=args.floor_seeds,
                               device=next(model.parameters()).device)}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=2)
    s = report["summary"]
    bitident = report["deterministic_pass"]["seed_floor_bit_identical"]
    floor = report["deterministic_pass"]["seed_floor_mel_l1"]
    print(f"[style] det min pair mel L1 {s['det_min_pair_mel_l1']:.4f} "
          f"(floor {'0 (bit-identical)' if bitident else floor}); "
          f"stochastic min contrast/floor {s['sto_min_contrast_over_floor']:.1f}x -> {args.out}")
    return report


if __name__ == "__main__":
    main()
