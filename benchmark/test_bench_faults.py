"""``correct`` on a cut cell driven on the CPU (the harness's look for a
card skipped): true for the port, false for the control and for each
fault a cell can have planted in the timed path."""

import json

import pytest

CELLS = ["headline-decode", "flagship-encode"]
BROKEN = ["control", "fault.answer_altered", "fault.half_batch",
          "fault.state_unchanged"]


@pytest.mark.parametrize("name", CELLS)
def test_port_is_correct(run_small, name):
    res, log = run_small(name)
    assert res["correct"], log
    assert all(c["value"] == 0 == c["limit"] for c in res["checks"].values())


@pytest.mark.parametrize("program", BROKEN)
@pytest.mark.parametrize("name", CELLS)
def test_broken_timed_path_is_not_correct(run_small, name, program):
    res, log = run_small(name, program)
    assert not res["correct"], log
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


def test_a_missing_window_counts_its_samples(run_small, monkeypatch):
    """A file answered with one window short reads B x N wrong samples
    for it, so a lost window fails the cell's one compared number."""
    from benchmark import harness

    real = harness.kind_module

    def short(cell):
        mod = real(cell)

        class Work(mod.Work):
            def request(self, i):
                return super().request(i)[:-1]
        return type("kind", (), {"Work": Work})
    monkeypatch.setattr(harness, "kind_module", short)
    res, _ = run_small("headline-decode")
    assert not res["correct"]
    # every request is kept at this size: one window of 4 x 64 each
    assert res["checks"]["samples_wrong"]["value"] == 4 * 64 * \
        res["attempted"]



@pytest.mark.parametrize("name", CELLS)
def test_a_fault_in_an_answer_not_kept_is_caught(run_small, monkeypatch,
                                                 name):
    """With only the window's first answer kept whole, one value altered
    in each later answer still fails the cell: every answer is probed."""
    from benchmark import harness

    real = harness.kind_module

    def late(cell):
        mod = real(cell)

        class Work(mod.Work):
            calls = 0

            def request(self, i):
                out = super().request(i)
                Work.calls += 1
                if Work.calls <= harness.WARM_REQUESTS + 1:
                    return out              # the warm-up and the kept first
                if name == "headline-decode":
                    out[-1] = out[-1].copy()
                    out[-1][1, 5] ^= 1
                else:
                    s = bytearray(out[-1][0])
                    s[len(s) // 2] ^= 0x10
                    out[-1] = (bytes(s), out[-1][1])
                return out
        return type("kind", (), {"Work": Work})
    monkeypatch.setattr(harness, "kind_module", late)
    res, log = run_small(name, keep_share=0.0)
    assert not res["correct"], log
    notes = next(json.loads(line)["notes"] for line in log.splitlines()
                 if line.startswith('{"notes"'))
    assert notes["requests_kept"] == 1 and notes["requests_probed"] >= 1
    # one altered value an answer, each seen by its probe (a stream's
    # probed positions may repeat)
    assert max(c["value"] for c in res["checks"].values()) >= \
        notes["requests_probed"]
