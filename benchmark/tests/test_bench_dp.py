"""The data-parallel driver end to end on the CPU: four ranks over gloo at
small widths, the gathered outputs judged against the plain reference of
the whole global batch, and the exchange between the ranks left out."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

import small
from benchmark.drivers import dp_synth

HELPER = str(Path(__file__).with_name("dp_worker.py"))


def _run(monkeypatch, fault: str):
    monkeypatch.setattr(dp_synth, "WORKER", [sys.executable, HELPER, fault])
    if fault == "no_gather":
        import gst_tacotron_tpu_torch.parallel.distributed_synthesis as ds

        monkeypatch.setattr(ds, "all_gather", lambda t, group, dim=0: t)
    torch.set_num_threads(1)
    return dp_synth.run(small.dp_context(), *small.config())


def test_sound_run_is_correct(monkeypatch):
    res = _run(monkeypatch, "none")
    assert res.correct, res.checks
    assert res.attempted >= 1 and res.device["count"] == 4
    assert res.metrics["audio_s_per_s"] > 0


def test_a_rank_that_loads_jax_refuses_the_result(monkeypatch):
    """Rank 1 loading JAX ends the run with no result. The rank's exit
    would end the process from the watcher; here the watcher's exit only
    ends its thread, and rank 0 raises once it has waited for the ranks."""
    exits = []

    def no_exit(code):
        exits.append(code)
        raise SystemExit(code)

    monkeypatch.setattr(dp_synth.os, "_exit", no_exit)
    with pytest.raises(RuntimeError, match="a rank exited with") as e:
        _run(monkeypatch, "jax_on_rank1")
    assert "3" in str(e.value).rsplit("with", 1)[1]
    assert exits in ([], [1])


def test_the_exchange_left_out_is_not_correct(monkeypatch):
    """Each rank keeping its own rows: the program's own result assembly
    fails on the ungathered rows (the run ends with no result line), or the
    judge reads them as wrong."""
    try:
        res = _run(monkeypatch, "no_gather")
    except RuntimeError as e:
        assert "size of tensor" in str(e)
    else:
        assert not res.correct
