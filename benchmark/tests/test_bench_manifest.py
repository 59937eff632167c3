"""The manifest and the data files the harness finds by name: every file
parses, names and units keep to the allowed characters, and each
per-layer metric's end-to-end metric is reported by every cell it lists."""

import json
import pathlib
import re

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def manifest():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def load(sub, name):
    return json.loads((BENCH / sub / f"{name}.json").read_text())


def test_manifest_shape():
    m = manifest()
    assert set(m) == KEYS
    assert m["paths"] == ["benchmark"]
    assert 1 <= m["run_seconds"] <= 51 and isinstance(m["run_seconds"], int)
    assert len(m["command"]) <= 32
    assert all(not w.startswith("/") and ".." not in w for w in m["command"])
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    # A full check of 24 cells must fit its budget.
    rs = m["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_text():
    m = manifest()
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in m[k]]
    names += [w[k] for w in m["workloads"] for k in ("config", "traffic")]
    names += [r for c in m["configs"] for r in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({x["name"] for x in m[k]}) == len(m[k])
    for x in m["end_to_end"] + m["per_layer"]:
        assert UNIT.match(x["unit"]) and x["better"] in ("lower", "higher")
    texts = [c["source"] for c in m["configs"]] + \
        [x["why"] for k in ("configs", "workloads") for x in m[k]] + \
        [x["layer"] for x in m["per_layer"]] + m["command"]
    assert all(1 <= len(t) <= 200 and "\n" not in t and "\t" not in t
               for t in texts)
    for path in BENCH.rglob("*"):
        if "__pycache__" in path.parts:
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


def test_entry_keys():
    m = manifest()
    allowed = {"configs": {"name", "source", "file", "reduced", "why"},
               "workloads": {"name", "config", "traffic", "chips", "why"},
               "end_to_end": {"name", "unit", "better", "bound", "source",
                              "workloads"},
               "per_layer": {"name", "unit", "better", "source", "layer",
                             "moves", "workloads"}}
    for k, keys in allowed.items():
        for x in m[k]:
            assert set(x) <= keys, (k, x)
    for x in m["end_to_end"]:
        assert 0.01 <= x["bound"] <= 0.25
        assert x["source"] in ("host_clock", "device_trace")
    assert any(x["name"] == "setup_s" for x in m["end_to_end"])


def test_files_found_by_name():
    m = manifest()
    for c in m["configs"]:
        assert c["file"].startswith("benchmark/configs/")
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
        assert any(w["config"] == c["name"] for w in m["workloads"])
    pairs = [(w["config"], w["traffic"]) for w in m["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for w in m["workloads"]:
        assert w["chips"] in (1, 4)
        mix = load("traffic", w["traffic"])
        assert (BENCH / "traffic" / f"{mix['kind']}.py").is_file()
        cell = load("cells", w["name"])
        assert cell["checks"] and cell["traced_units"] > 0
    for x in m["per_layer"]:
        spec = load("metrics", x["name"])
        assert (BENCH / "readers" / f"{spec['reader']}.py").is_file()


def test_every_cell_reports_what_its_metrics_move():
    m = manifest()
    e2e = {x["name"]: x for x in m["end_to_end"]}
    cells = [w["name"] for w in m["workloads"]]

    def reports(cell, metric):
        return cell in e2e[metric].get("workloads", cells)

    for cell in cells:
        assert reports(cell, "setup_s")
        assert any(reports(cell, k) for k in e2e if k != "setup_s")
        assert any(cell in x["workloads"] for x in m["per_layer"])
    for x in m["per_layer"]:
        assert x["moves"] in e2e and x["moves"] != "setup_s"
        assert set(x["workloads"]) <= set(cells)
        assert all(reports(c, x["moves"]) for c in x["workloads"])
    layers = {}
    for x in m["per_layer"]:
        layers.setdefault(x["name"].split(".")[0], set()).add(x["layer"])
    assert all(len(v) == 1 for v in layers.values()), layers
