"""BENCHMARK.json against the benchmark's contract, and the harness
finding a cell, a configuration and a metric by name alone."""
import json
import re
import shutil

import pytest

from bench import run

B = json.loads((run.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
E2E = {m["name"]: m for m in B["end_to_end"]}


def test_top_level_keys():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert B["command"] == ["python3", "bench/run.py"]
    assert B["paths"] == ["bench"]
    assert 1 <= B["run_seconds"] <= 51
    assert len(json.dumps(B)) < 64 * 1024


def test_names_units_and_keys():
    names = []
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        names.append(("config", c["name"]))
        assert all(NAME.match(k) for k in c["reduced"])
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        names.append(("cell", w["name"]))
    for m in B["end_to_end"] + B["per_layer"]:
        keys = {"name", "unit", "better", "source"}
        keys |= {"bound"} if m in B["end_to_end"] else {"layer", "moves"}
        assert set(m) - {"workloads"} == keys
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(("metric", m["name"]))
    for _, n in names:
        assert NAME.match(n), n
    assert len(set(names)) == len(names)
    for text in ([c["why"] for c in B["configs"] + B["workloads"]]
                 + [c["source"] for c in B["configs"]]
                 + [m["layer"] for m in B["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_bounds():
    for m in B["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert E2E["setup_s"]["bound"] <= 0.25


def test_every_cell_names_its_files():
    configs = {c["name"]: c for c in B["configs"]}
    used = set()
    for w in B["workloads"]:
        wl = json.loads((run.BENCH / "workloads" / f"{w['name']}.json")
                        .read_text())
        assert wl["config"] == w["config"] and wl["traffic"] == w["traffic"]
        c = configs[w["config"]]
        cf = json.loads((run.ROOT / c["file"]).read_text())
        assert cf["name"] == c["name"] and cf["source"] == c["source"]
        assert cf["reduced"] == c["reduced"]
        assert (run.BENCH / f"{cf['reference']}.py").is_file()
        assert (run.BENCH / f"{cf.get('program', 'program')}.py").is_file()
        assert c["file"].startswith("bench/")
        used.add(w["config"])
    assert used == set(configs)


@pytest.mark.parametrize("config", [c["file"] for c in B["configs"]])
def test_a_config_without_program_runs_the_tm_round(config):
    """Neither TM configuration names a program: both run
    ``bench/program.py``, the round engine."""
    cf = json.loads((run.ROOT / config).read_text())
    assert "program" not in cf
    mod = run.program_of(cf)
    assert mod.__file__ == str(run.BENCH / "program.py")
    assert mod.make_inputs.__module__ == "bench.traffic"
    assert {"obs", "cycle", "outcome", "close"} <= set(dir(mod.Program))
    assert callable(mod.capture) and callable(mod.check)


def _reports(metric, cell):
    return cell in metric.get("workloads", [cell])


def test_every_cell_reports_setup_another_e2e_and_a_layer():
    for w in B["workloads"]:
        e2e = [m["name"] for m in B["end_to_end"] if _reports(m, w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(_reports(m, w["name"]) for m in B["per_layer"])


def test_each_layer_metric_moves_what_its_cells_report():
    cells = [w["name"] for w in B["workloads"]]
    for m in B["per_layer"]:
        assert m["moves"] in E2E and m["moves"] != "setup_s"
        for cell in m.get("workloads", cells):
            assert cell in cells and _reports(E2E[m["moves"]], cell)
        assert (run.BENCH / "metrics" / f"{m['name']}.py").is_file()
        assert callable(run.metric_reader(m["name"]))


def test_a_roofline_is_named_for_its_kernel():
    for m in B["per_layer"]:
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_a_new_cell_is_found_from_new_files(tmp_path):
    """A later change adds a cell by adding its traffic file and its
    entry; the harness finds both by name."""
    shutil.copytree(run.BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(B))
    bench["workloads"].append({"name": "tm-mnist-c10.new", "config":
                               "tm-mnist-c10", "traffic": "new",
                               "chips": 1, "why": "a later cell"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    wl = {"config": "tm-mnist-c10", "traffic": "new", "why": "x",
          "population": 4, "cohort": 2,
          "per_client": {"train": 8, "test": 4, "conf": 4},
          "rounds_per_cycle": 5, "reference_rounds": 1}
    (tmp_path / "bench" / "workloads" / "tm-mnist-c10.new.json").write_text(
        json.dumps(wl))
    got = run.load_cell("tm-mnist-c10.new", tmp_path)
    assert got[1]["name"] == "tm-mnist-c10.new"
    assert got[2] == wl and got[3]["name"] == "tm-mnist-c10"
    with pytest.raises(KeyError):
        run.load_cell("tm-mnist-c10.absent", tmp_path)
