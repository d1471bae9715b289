"""BENCHMARK.json keeps to the benchmark's contract, and every cell,
configuration, traffic mix, limit and metric is found by name and parsed."""

import json
import re
from pathlib import Path

import pytest

from benchmark import check, harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(BENCH["command"]) <= 32 and all(_line(w) for w in BENCH["command"])
    assert 1 <= len(BENCH["paths"]) <= 16
    for path in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", path) and ".." not in path
        assert not path.startswith("/") and not path.endswith("_torch")
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert 2 + 14 * 24 <= 43200 and \
        (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_entry_keys():
    names = [c["name"] for c in BENCH["configs"]] + CELLS + [m["name"] for m in METRICS]
    assert all(NAME.match(n) for n in names)
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        assert len({e["name"] for e in group}) == len(group)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["traffic"]) and w["chips"] == 1 and _line(w["why"])
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]} and _line(m["layer"])


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for name in CELLS:
        cell = harness.load_cell(name)
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer


def test_configurations_are_used_and_under_paths():
    used = {w["config"] for w in BENCH["workloads"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert used == {c["name"] for c in BENCH["configs"]} and len(set(files)) == len(files)
    for c in BENCH["configs"]:
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["name"] == c["name"] and body["reduced"] == c["reduced"]
        assert "assumed" in body and body["dtype"] == "float32"


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_are_found_and_parsed(name):
    cell = harness.load_cell(name)
    assert cell.config["spec"]["batch_size"] > 0 and 0 < cell.traffic["p"] < 0.5
    assert set(cell.limits["limits"]) == set(check.NUMBERS)
    assert cell.traffic["check"]["drawn"] <= cell.traffic["check"]["within_first"]
    for m in cell.end_to_end + cell.per_layer:
        assert callable(harness.reader(m["name"]))


def test_files_under_paths_are_named_from_name_characters():
    for path in (ROOT / "benchmark").rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert re.fullmatch(r"[A-Za-z0-9_./-]+", rel), rel


def test_a_space_time_cell_needs_only_new_files(tmp_path, capsys):
    """A space-time configuration, traffic mix and limits added as new files,
    and entries in BENCHMARK.json, in a copy of the benchmark: no file the
    benchmark had changes, the cell loads, its reference builds, and
    ``calibrate.readings`` reads the program within the limits and its
    control outside them."""
    import shutil

    from benchmark import calibrate
    from benchmark.tests import tiny

    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    config = tiny.st_config()
    limits = json.loads((ROOT / "benchmark" / "limits" / "cc144_p050.json").read_text())
    new = {
        "benchmark/configs/bb72_st_bposd.json": config,
        "benchmark/workloads/st_p0.03.json": {
            "name": "st_p0.03", "p": 0.03, "why": "p = 0.03 over four rounds",
            "check": {"drawn": 1, "within_first": 2}, "stage_reps": 2, "idle_batches": 2},
        "benchmark/limits/st72_t4_p003.json": {"limits": limits["limits"], "readings": {}},
    }
    for rel, body in new.items():
        assert not (tmp_path / rel).exists()
        (tmp_path / rel).write_text(json.dumps(body, indent=2))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": config["name"], "source": config["source"],
                             "file": "benchmark/configs/bb72_st_bposd.json", "reduced": [],
                             "why": "space-time BP (K6) and OSD-0 on H_st"})
    bench["workloads"].append({"name": "st72_t4_p003", "config": config["name"],
                               "traffic": "st_p0.03", "chips": 1, "why": "T = 4, p = 0.03"})
    for m in bench["per_layer"]:
        if m["name"] != "k4g_lanes_per_batch":
            m["workloads"].append("st72_t4_p003")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench, indent=2))
    for path in (ROOT / "benchmark").rglob("*"):
        if path.is_file() and "__pycache__" not in path.parts:
            rel = path.relative_to(ROOT)
            assert (tmp_path / rel).read_bytes() == path.read_bytes(), rel

    cell = harness.load_cell("st72_t4_p003", root=tmp_path)
    assert cell.config == config and cell.per_layer
    assert {"setup_s", "trials_per_s"} <= {m["name"] for m in cell.end_to_end}
    p = float(cell.traffic["p"])
    ref = check.Reference(cell.config, p)
    ref.place("cpu")
    for control in (False, True):
        engine = harness.build_engine(cell.config, "cpu", control=control, p=p)
        calibrate.readings(cell, engine, ref, [2**33 + 777], control, None)
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines() if s.startswith("{")]
    within = [all(line["numbers"][k] <= cell.limits["limits"][k] for k in check.NUMBERS)
              for line in lines]
    assert [line["control"] for line in lines] == [False, True] and within == [True, False]
