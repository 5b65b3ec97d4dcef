"""``python -m sda_tpu_torch.benchmarks.startup`` on the CPU: every
measurement runs, the record holds each one, and the ``sda`` command
line's import holds no torch (it imports torch at its first device
use)."""

import json

from sda_tpu_torch.benchmarks import startup


def test_startup_probe_records_every_measurement(capsys):
    assert startup.main(["--device", "cpu", "--at-once", "2",
                         "--reps", "1"]) == 0
    record = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(record["alone"]) == {
        "python", "import numpy", "import torch",
        "import the sda command line", "sda agent create"}
    assert set(record["at_once_runs"]) == {"import torch",
                                           "sda agent create"}
    for runs in (record["alone"], record["at_once_runs"]):
        for label, s in runs.items():
            assert 0 < s["wall_s_min"] <= s["wall_s_median"] \
                <= s["wall_s_max"], label
            assert s["user_s_median"] > 0, label
    assert record["at_once_runs"]["sda agent create"]["n"] == 2
    split = record["import_split"]
    assert split["torch_s"] == 0 < split["cli_main_s"]
