"""The harness finds every piece by name: a new configuration, traffic
mix, cell sizing and metric file, added beside copies of the committed
ones, are loaded without editing any file that was there; and every
metric and cell of the committed BENCHMARK.json has its files."""
import json
import shutil
from pathlib import Path

import pytest

from fdbench.lib import cell as C

FDBENCH = Path(__file__).resolve().parents[1]
ROOT = FDBENCH.parent


def test_committed_benchmark_has_every_file():
    bench = C.load_benchmark()
    for w in bench["workloads"]:
        cell = C.load_cell(bench, w["name"])
        assert cell.config["name"] == w["config"]
        assert cell.mix["name"] == w["traffic"]
        assert cell.sizing["slots"] % 2 == 0
        C.family(cell.config)
        C.reference(cell.config)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(C.reader(m["name"]))


def test_every_cell_reports_what_its_metrics_move():
    bench = C.load_benchmark()
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for w in bench["workloads"]:
        mine = {m["name"] for m in C.metrics_for(bench, w["name"], False)}
        assert "setup_s" in mine and len(mine) >= 2
        layer = C.metrics_for(bench, w["name"], True)
        assert layer
        for m in layer:
            assert m["moves"] in mine, (w["name"], m["name"])
    assert all(m["moves"] in e2e for m in bench["per_layer"])


def test_a_new_cell_loads_by_name(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(FDBENCH, root / "fdbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = {p: p.read_bytes() for p in (root / "fdbench").rglob("*")
              if p.is_file()}
    new = root / "fdbench"
    cfg = json.loads((new / "configs" / "opt-175b.s8.json").read_text())
    cfg["name"] = "other.s4"
    cfg["num_hidden_layers"] = 4
    (new / "configs" / "other.s4.json").write_text(json.dumps(cfg))
    mix = json.loads((new / "traffic" / "batch.json").read_text())
    mix["name"] = "burst"
    mix["output"]["hi"] = 511
    (new / "traffic" / "burst.json").write_text(json.dumps(mix))
    (new / "cells" / "other.s4.burst.json").write_text(json.dumps(
        {"slots": 8, "cache_len": 256, "check": {"limits": {"max_gap": 1.0}}}))
    (new / "metrics" / "queue_depth.tput.py").write_text(
        "def read(run):\n    return 7.0\n")
    bench["configs"].append({"name": "other.s4", "source": "x",
                             "file": "fdbench/configs/other.s4.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "other.s4.burst",
                               "config": "other.s4", "traffic": "burst",
                               "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "queue_depth.tput", "unit": "1",
                               "better": "lower", "source": "program_counter",
                               "layer": "engine", "moves": "decode_tok_s",
                               "workloads": ["other.s4.burst"]})
    cell = C.load_cell(bench, "other.s4.burst", root=root)
    assert cell.config["num_hidden_layers"] == 4
    assert cell.mix["output"]["hi"] == 511
    assert cell.sizing["slots"] == 8
    names = [m["name"] for m in C.metrics_for(bench, "other.s4.burst", True)]
    assert names == ["queue_depth.tput"]
    assert C.reader("queue_depth.tput", root)(None) == 7.0
    after = {p: p.read_bytes() for p in before}
    assert after == before


def test_unknown_cell_is_refused():
    with pytest.raises(ValueError):
        C.load_cell(C.load_benchmark(), "no-such.cell")
