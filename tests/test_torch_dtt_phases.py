"""The DTT phase timer script (scripts/dtt_phases.py) on the CPU: every
phase of the evaluation is reported for each run, with its minimum and
median, under the pregather and dma_i fetches."""

import re

import pytest
import torch

from onbody_tpu_torch.scripts import dtt_phases

torch.set_num_threads(1)


@pytest.mark.parametrize("fetch", ["pregather", "dma_i"])
def test_dtt_phases_reports_every_run(capsys, fetch):
    dtt_phases.main(["-n", "3000", "--reps", "2", "--device", "cpu",
                     "--fetch", fetch, "vort2d"])
    out = capsys.readouterr().out
    assert out.startswith(f"vort2d {fetch} N=3000: launches {{}}")
    lines = {m.group(1): (float(m.group(2)), float(m.group(3)),
                          [float(t) for t in m.group(4).split()])
             for m in re.finditer(r"^  ([\w ]+): min (\S+) median (\S+) s; "
                                  r"runs (.*)$", out, re.M)}
    assert {"tree", "equivalents", "lists", "exec interior",
            "downward"} <= set(lines)
    for lo, mid, runs in lines.values():
        assert len(runs) == 2 and lo == min(runs) and lo <= mid


def test_dtt_phases_needs_a_device_or_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dtt_phases.main(["-n", "3000", "--reps", "1", "vort2d"])
