"""The cell's check comes out true for the program as it is, and false
with the timed path broken underneath, once for each fault a prefill cell
can have: an answer altered where it is produced, and half of the batch
left out. The harness's look for a card is skipped (``main.execute`` on
the CPU); the rest of a run is driven as ``run.py`` drives it, at a tiny
size."""

import time

import pytest

from portbench.harness import main


def execute(bench, cell, seed=11):
    line, _ = main.execute(bench, cell, seed, 1.0, False,
                           time.perf_counter(), device="cpu")
    return line


@pytest.mark.parametrize("seed", [11, 2**31 + 77])
def test_sound_run_is_correct(tiny_bench, seed):
    line = execute(tiny_bench, "yi6b-prefill-2k", seed)
    assert line["correct"] and line["attempted"] > 0 and not line["failed"]
    assert list(line)[-1] == "checks"


def _prefill_fault(kind):
    from repro_torch.models.lm import DecoderLM

    forward = DecoderLM.forward

    def broken(self, batch):
        logits = forward(self, batch).clone()
        if kind == "answer":      # each sequence's next-token logits altered
            logits[:, -1] = logits[:, -1].roll(1, dims=-1)
        else:            # the first half of the batch given for the whole
            half = batch["tokens"][: logits.shape[0] // 2]
            kept = forward(self, {"tokens": half}).clone()
            logits = kept.repeat(2, 1, 1)[: logits.shape[0]]
        return logits

    return broken


@pytest.mark.parametrize("kind", ["answer", "half_batch"])
def test_prefill_faults(tiny_bench, monkeypatch, kind):
    from repro_torch.models.lm import DecoderLM

    monkeypatch.setattr(DecoderLM, "forward", _prefill_fault(kind))
    assert not execute(tiny_bench, "yi6b-prefill-2k")["correct"]


def test_control_fails_its_limit(tiny_bench):
    """At the tiny size the control (fp8) reads above the tiny limit."""
    from portbench.harness import cells
    from portbench.tests.test_portbench_reference import tiny_ctx

    ctx = tiny_ctx(tiny_bench, "yi6b-prefill-2k")
    got = cells.driver("prefill", tiny_bench).control(ctx)
    assert got["row_err_max"] > ctx.cell["check"]["row_err_max"]


@pytest.mark.cuda
def test_traced_run_on_the_card(tiny_bench, cuda):
    """A traced run at the tiny size on the card: correct, and the trace
    saw the device busy."""
    line, _ = main.execute(tiny_bench, "yi6b-prefill-2k", 13, 1.0, True,
                           time.perf_counter(), device="cuda")
    assert line["correct"] and line["device"]["busy_s"] > 0
    assert line["metrics"] and line["breakdown"]["device_ops"]
